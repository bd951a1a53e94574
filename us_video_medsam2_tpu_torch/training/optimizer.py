"""Optimizer: AdamW with per-group cosine schedules, layer-wise lr decay,
weight-decay masking and global-norm clipping.

Counterpart of the JAX package's ``training/optimizer.py`` (reference
training/optimizer.py:52-502 + GFTE_3.yaml:246-289), written as a plain
update over the model's named parameters in the order of the JAX
``update_fn``: clip the gradients to the global norm, Adam moments with
optax's bias correction and eps outside the square root, then
``p -= lr · mult · (adam + wd · p)`` with decoupled weight decay. The step
count and the micro-step are int32 tensors on the parameters' device, and
the schedules and the bias corrections are computed from them there in
f32, as optax computes them from its count: an update reads nothing from
the host and writes nothing to it, so the training step can be captured
once and replayed (``train_step.py``). Gradient accumulation is
``optax.MultiSteps``' select on the device: every call adds to the running
mean, and the update is computed and kept where the micro-step closes the
group. Parameters are updated in place.

``state_dict`` / ``load_state_dict`` hold the moments, the step count and,
with ``accum_steps`` > 1, the micro-step and the accumulator, in the layout
the JAX trainer writes under ``opt_state/`` (``{"adam": {"count", "mu",
"nu"}, "count"}``, inside optax.MultiSteps' ``{"mini_step",
"gradient_step", "inner_opt_state", "acc_grads", "skip_state"}`` when it
accumulates; trees in the JAX parameter names), so a checkpoint of either
trainer resumes in the other.
"""

from __future__ import annotations

import fnmatch
import re
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class OptimConfig:
    base_lr: float = 5.0e-5
    vision_lr: float = 3.0e-5
    lr_end_factor: float = 0.1  # cosine end = start * factor
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    layer_decay: float = 0.9
    layer_decay_min: float | None = None
    # unix patterns over '/'-joined parameter paths of parameters to freeze
    freeze_patterns: tuple = ()
    grad_dtype: str = "float32"  # 'bfloat16' rounds the gradients to bf16 first
    accum_steps: int = 1  # gradient accumulation micro-steps per optimizer step


@dataclass(frozen=True)
class ParamMeta:
    group: int  # 1: the image encoder's lr schedule, 0: the base schedule
    mult: float  # layer-decay multiplier (0 = frozen)
    wd_on: bool


def param_path(name: str) -> str:
    """'image_encoder.trunk.blocks_0.attn.qkv.weight' -> '.../qkv/weight'."""
    return name.replace(".", "/")


def _trunk_layer_id(path: str, num_layers: int) -> int:
    """reference Hiera.get_layer_id (hieradet.py:301-314)."""
    if "pos_embed" in path or "patch_embed" in path:
        return 0
    m = re.search(r"blocks_(\d+)", path)
    return int(m.group(1)) + 1 if m else num_layers + 1


def compute_param_meta(named_params: dict, cfg: OptimConfig) -> dict:
    """name -> ParamMeta, by the JAX package's path rules."""
    ids = [int(m.group(1)) for n in named_params
           if (m := re.search(r"image_encoder/trunk/blocks_(\d+)", param_path(n)))]
    num_layers = max(ids, default=-1) + 1
    metas = {}
    for name, p in named_params.items():
        path = param_path(name)
        mult = 1.0
        trunk = "image_encoder/trunk" in path and not fnmatch.fnmatch(path, "*pos_embed*")
        if cfg.layer_decay != 1.0 and trunk:
            mult = cfg.layer_decay ** (num_layers + 1 - _trunk_layer_id(path, num_layers))
            if cfg.layer_decay_min is not None:
                mult = max(mult, cfg.layer_decay_min)
        if any(fnmatch.fnmatch(path, pat) for pat in cfg.freeze_patterns):
            mult = 0.0
        # no weight decay on biases, norm parameters and 1-d leaves
        is_norm = "/norm" in path or "_ln" in path
        wd_on = not (path.endswith("/bias") or is_norm or p.dim() <= 1)
        metas[name] = ParamMeta(int("image_encoder" in path), float(mult), wd_on)
    return metas


def cosine_value(start, end, frac):
    """The cosine schedule at ``frac`` in f32: numpy f32 scalars, or an f32
    tensor ``frac`` (``start`` and ``end`` numpy f32)."""
    cos = torch.cos if isinstance(frac, torch.Tensor) else np.cos
    return end + np.float32(0.5) * (start - end) * (np.float32(1.0) + cos(np.float32(np.pi) * frac))


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """The JAX ``build_optimizer`` transformation over ``named_params``
    (name -> f32 parameter), with ``accum_steps`` micro-steps averaged per
    update as ``optax.MultiSteps`` does."""

    def __init__(self, named_params: dict, cfg: OptimConfig):
        self.cfg = cfg
        self.params = dict(named_params)
        self.meta = compute_param_meta(self.params, cfg)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        dev = next(iter(self.params.values())).device if self.params else torch.device("cpu")
        # optimizer steps taken, and the micro-step within the accumulation group
        self.count_t = torch.zeros((), dtype=torch.int32, device=dev)
        self.mini_step_t = torch.zeros((), dtype=torch.int32, device=dev)
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()} if cfg.accum_steps > 1 else None

    @property
    def count(self) -> int:
        return int(self.count_t)

    @count.setter
    def count(self, value: int) -> None:
        self.count_t.fill_(int(value))

    @property
    def mini_step(self) -> int:
        return int(self.mini_step_t)

    @mini_step.setter
    def mini_step(self, value: int) -> None:
        self.mini_step_t.fill_(int(value))

    def state_tensors(self) -> list:
        """Every tensor of the optimizer's state (what a captured step reads and writes)."""
        out = [self.count_t, self.mini_step_t, *self.mu.values(), *self.nu.values()]
        return out + (list(self.acc.values()) if self.acc is not None else [])

    def lr_at(self, count):
        """(base lr, vision lr) at ``count``: numpy f32 for an int, f32
        tensors for an int tensor (the update's own, on the device)."""
        c = self.cfg
        end = np.float32(c.lr_end_factor)
        if isinstance(count, torch.Tensor):
            frac = torch.clamp(count.float() / np.float32(max(c.total_steps, 1)), 0.0, 1.0)
        else:
            frac = np.clip(np.float32(count) / np.float32(max(c.total_steps, 1)), 0.0, 1.0).astype(np.float32)
        return (cosine_value(np.float32(c.base_lr), np.float32(c.base_lr) * end, frac),
                cosine_value(np.float32(c.vision_lr), np.float32(c.vision_lr) * end, frac))

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """Apply one (micro-)step of gradients ``grads`` (name -> tensor)."""
        if self.acc is None:
            self._update(grads, None)
            return
        mini = self.mini_step_t
        for n, g in grads.items():  # running mean (Welford), as optax.MultiSteps
            self.acc[n] += (g - self.acc[n]) / (mini + 1).float()
        emit = mini == self.cfg.accum_steps - 1  # this micro-step closes the group
        self._update(self.acc, emit)
        for a in self.acc.values():
            a.copy_(torch.where(emit, torch.zeros_like(a), a))
        mini.copy_(torch.remainder(mini + 1, self.cfg.accum_steps))

    def _update(self, grads: dict, emit) -> None:
        """The update from ``grads``; with ``emit`` (a 0-d bool tensor) it is
        kept only where ``emit`` holds, and the state left as it was else."""
        c = self.cfg
        norm = global_norm(grads.values())
        keep = norm < c.clip_norm
        lr0, lr1 = self.lr_at(self.count_t)
        count = (self.count_t + 1).float()
        bc1 = 1 - torch.pow(torch.full_like(count, c.b1), count)
        bc2 = 1 - torch.pow(torch.full_like(count, c.b2), count)

        def put(dst, new):
            dst.copy_(new if emit is None else torch.where(emit, new, dst))

        def step_param(p, delta):  # p - delta; p.sub_ gives the same bits
            if emit is None:
                p.sub_(delta)
            else:
                p.copy_(torch.where(emit, p - delta, p))

        for n, p in self.params.items():
            g = grads[n].float()
            g = torch.where(keep, g, g / norm * c.clip_norm)
            mu, nu = self.mu[n], self.nu[n]
            put(mu, (1 - c.b1) * g + c.b1 * mu)
            put(nu, (1 - c.b2) * g.square() + c.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + c.eps)
            m = self.meta[n]
            lr = (lr1 if m.group == 1 else lr0) * np.float32(m.mult)
            if m.wd_on:
                u = u + c.weight_decay * p
            step_param(p, lr * u)
        self.count_t.add_(1 if emit is None else emit.int())

    def _tree(self, tensors: dict, cfg, buffers: dict) -> dict:
        from us_video_medsam2_tpu_torch.core.weights import to_jax_params

        # the JAX optimizer also holds moments of the BatchNorm statistics
        # (batch_stats is part of its variables); their gradient is 0, so they stay 0
        return to_jax_params({**tensors, **{n: torch.zeros_like(b) for n, b in buffers.items()}}, cfg)

    def state_dict(self, cfg, buffers: dict | None = None) -> dict:
        """The state in the JAX trainer's ``opt_state`` layout for the model
        of config ``cfg`` whose buffers are ``buffers``: nested dicts of numpy
        arrays (counts int32, trees f32)."""
        buffers = buffers or {}
        count = np.asarray(self.count, np.int32)
        inner = {"adam": {"count": count, "mu": self._tree(self.mu, cfg, buffers),
                          "nu": self._tree(self.nu, cfg, buffers)}, "count": count}
        if self.acc is None:
            return inner
        return {"mini_step": np.asarray(self.mini_step, np.int32), "gradient_step": count,
                "inner_opt_state": inner, "acc_grads": self._tree(self.acc, cfg, buffers), "skip_state": {}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore from the JAX layout (``state_dict``'s, or a JAX trainer's
        ``opt_state``); the accumulation of the state must be this
        optimizer's."""
        from us_video_medsam2_tpu_torch.core.weights import from_jax_params

        accumulating = "inner_opt_state" in state
        if accumulating != (self.acc is not None):
            raise ValueError(f"optimizer state {'with' if accumulating else 'without'} gradient accumulation, "
                             f"but accum_steps is {self.cfg.accum_steps}")
        inner = state["inner_opt_state"] if accumulating else state

        def load(dst: dict, tree: dict) -> None:
            src = from_jax_params(tree)
            missing = sorted(set(dst) - set(src))
            if missing:
                raise KeyError(f"optimizer state lacks {missing[:5]}")
            for n, t in dst.items():
                if tuple(src[n].shape) != tuple(t.shape):
                    raise ValueError(f"{n}: {tuple(src[n].shape)} vs {tuple(t.shape)}")
                t.copy_(src[n])

        load(self.mu, inner["adam"]["mu"])
        load(self.nu, inner["adam"]["nu"])
        self.count = int(np.asarray(inner["count"]))
        if accumulating:
            load(self.acc, state["acc_grads"])
            self.mini_step = int(np.asarray(state["mini_step"]))
