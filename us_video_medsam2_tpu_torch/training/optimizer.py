"""Optimizer: AdamW with per-group cosine schedules, layer-wise lr decay,
weight-decay masking and global-norm clipping.

Counterpart of the JAX package's ``training/optimizer.py`` (reference
training/optimizer.py:52-502 + GFTE_3.yaml:246-289), written as a plain
update over the model's named parameters in the order of the JAX
``update_fn``: clip the gradients to the global norm, Adam moments with
optax's bias correction and eps outside the square root, then
``p -= lr · mult · (adam + wd · p)`` with decoupled weight decay. The step
count, the schedules and the bias corrections are f32, as in the JAX
package. Parameters are updated in place.
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
    return end + np.float32(0.5) * (start - end) * (np.float32(1.0) + np.cos(np.float32(np.pi) * frac))


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
        self.count = 0  # optimizer steps taken
        self.mini_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()} if cfg.accum_steps > 1 else None

    def lr_at(self, count: int):
        c = self.cfg
        frac = np.clip(np.float32(count) / np.float32(max(c.total_steps, 1)), 0.0, 1.0).astype(np.float32)
        end = np.float32(c.lr_end_factor)
        return (cosine_value(np.float32(c.base_lr), np.float32(c.base_lr) * end, frac),
                cosine_value(np.float32(c.vision_lr), np.float32(c.vision_lr) * end, frac))

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """Apply one (micro-)step of gradients ``grads`` (name -> tensor)."""
        if self.acc is not None:
            for n, g in grads.items():  # running mean (Welford), as optax.MultiSteps
                self.acc[n] += (g - self.acc[n]) / (self.mini_step + 1)
            self.mini_step = (self.mini_step + 1) % self.cfg.accum_steps
            if self.mini_step:
                return
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            for a in self.acc.values():
                a.zero_()

    def _update(self, grads: dict) -> None:
        c = self.cfg
        norm = global_norm(grads.values())
        keep = norm < c.clip_norm
        lr0, lr1 = self.lr_at(self.count)
        self.count += 1
        bc1 = 1 - np.float32(c.b1) ** np.float32(self.count)
        bc2 = 1 - np.float32(c.b2) ** np.float32(self.count)
        for n, p in self.params.items():
            g = grads[n].float()
            g = torch.where(keep, g, g / norm * c.clip_norm)
            mu, nu = self.mu[n], self.nu[n]
            mu.copy_((1 - c.b1) * g + c.b1 * mu)
            nu.copy_((1 - c.b2) * g.square() + c.b2 * nu)
            u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + c.eps)
            m = self.meta[n]
            lr = float(np.float32(lr1 if m.group == 1 else lr0) * np.float32(m.mult))
            if m.wd_on:
                u = u + c.weight_decay * p
            p.add_(-lr * u)
