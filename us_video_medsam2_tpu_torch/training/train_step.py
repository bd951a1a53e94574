"""The training step: prompt-simulated tracking forward + loss + AdamW.

Counterpart of the JAX package's ``training/train_step.py``, whose step is
one ``jax.jit`` program (value_and_grad, the bf16 gradient cast and the
optax AdamW) and whose eval step is jitted too. Here each is one CUDA graph
on the card: ``make_train_step`` and ``make_eval_step`` return steps that
capture their body once for each model, batch shape and dtype, compute
dtype, kernel switch set and process group, and then replay that capture
every step. The body is one program whatever the plan
(``train_model.train_forward`` draws the plan on the device and selects
between branches), and reads nothing back to the host. Its backward pass
recomputes the frame and click bodies (``train_forward``'s
rematerialisation): the recompute and its backward are recorded in the
same capture and replayed with the rest, and a failed recompute raises. On
the CPU the same body runs eagerly, in the dtype the caller names.

A capture is made from an eager run of the body on a side stream (the first
step's own, whose outputs it returns: capture runs nothing) and needs every
tensor it reads at a fixed address: the batch is copied into the step's
buffers, the parameters, the BatchNorm buffers and the optimizer's state
(its count and micro-step included, ``optimizer.py``) are updated in place.
A replay changes those tensors without autograd seeing it, so after each one
their versions are moved on, as an eager step's in-place updates move them.
The graph reads the weights by address: a checkpoint load or a resume copies
into the same tensors and the next replay reads them; a weight with other
memory (``.data =``, a cast) drops every graph of the step, and the next
call captures anew. A failed capture or replay raises; nothing falls back
to the eager body on the card. A model's train and eval steps never run at
once, so all the step graphs of one model share one memory pool: the
outputs of a step are the graph's memory until the model's next train or
eval step.

Randomness: each step is given an int seed. The step's own generator on the
batch's device (registered with the capture) is seeded with it: the plan,
the prompt noise, the temporal fusion's draws and the attention-dropout
seeds. The device's default generator (the residual dropouts and drop path)
is seeded with it and the rank. A replay draws from the generators' state
at that time, so a step draws the same values whether it is replayed or run
eagerly.

In a ``torch.distributed`` group (``parallel/distributed.py``) each rank
holds its share of the global batch (equal shares): the valid-object count
is summed over the ranks before the loss divides by it, the prompt noise is
drawn for the global batch's objects and sliced (``train_forward``'s
``shard``), and the gradients are summed over the ranks, so the step equals
the single-process step on the global batch, as the JAX package's sharded
step does; on the card the NCCL collectives are captured with the rest. The
metrics are the global batch's. The dropouts draw on each rank for its own
rows.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from us_video_medsam2_tpu_torch.core.device import resolve_device
from us_video_medsam2_tpu_torch.core.switches import fused_cxblock_enabled, fused_qkv_window_attention_enabled
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.parallel import distributed
from us_video_medsam2_tpu_torch.training.losses import CORE_LOSS_KEY, LossConfig, multi_step_loss_stacked
from us_video_medsam2_tpu_torch.training.optimizer import AdamW, OptimConfig, global_norm
from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig, train_forward
from us_video_medsam2_tpu_torch.utils.graphs import MAX_GRAPHS, FrameGraph


class TrainBatch(NamedTuple):
    """The collated video batch (reference BatchedVideoDatapoint, data_utils.py:72-179)."""

    images: torch.Tensor  # [T, B, H, W, 3] float, normalized
    masks: torch.Tensor  # [T, B, O, H, W] bool
    obj_valid: torch.Tensor  # [B, O] bool: padded object slots are False


@dataclass(frozen=True)
class TrainConfig:
    sim: TrainSimConfig = field(default_factory=TrainSimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)


@dataclass
class TrainState:
    model: SAM2Model
    optimizer: AdamW
    step: int = 0


def create_train_state(model: SAM2Model, cfg: TrainConfig, device: str | torch.device = "cuda",
                       dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """Move ``model`` (f32 parameters) to ``device``, run it in ``dtype`` with
    the parameters kept in f32 as master weights, and attach the optimizer."""
    dev = resolve_device(device)
    model = model.to(dev).set_compute_dtype(dtype, cast_weights=False).train()
    return TrainState(model, AdamW(dict(model.named_parameters()), cfg.optim))


def _losses(model: SAM2Model, cfg: TrainConfig, batch: TrainBatch, gen: torch.Generator,
            is_training: bool, remat: bool = True):
    obj_valid = batch.obj_valid.reshape(-1)
    shard = num_objects = None
    if distributed.is_initialized():
        n = obj_valid.numel()
        shard = (distributed.rank() * n, distributed.world() * n)
        num_objects = torch.clamp(distributed.all_reduce_sum(obj_valid.float().sum()), min=1.0)
    stacked, finals, plan = train_forward(model, gen, batch.images, batch.masks, cfg.sim, is_training, shard,
                                          remat=remat)
    losses = multi_step_loss_stacked(cfg.loss, stacked, obj_valid, final_logits_by_frame=finals,
                                     num_objects=num_objects)
    return losses, plan


def _global(losses: dict) -> dict:
    """The losses of the global batch: each rank's is its share."""
    return {k: distributed.all_reduce_sum(v.detach()) for k, v in losses.items()}


def seed_step(gen: torch.Generator, seed: int) -> None:
    """Seed the step's generator ``gen`` with ``seed`` and its device's
    default generator with ``seed`` and the rank (each rank's residual
    dropouts draw for its own rows)."""
    gen.manual_seed(seed % 2**63)
    dev = gen.device
    default = torch.default_generator if dev.type != "cuda" else torch.cuda.default_generators[
        dev.index if dev.index is not None else torch.cuda.current_device()]
    default.manual_seed((seed * 1_009 + distributed.rank()) % 2**63)


# the last step graph captured for each model: a model's train and eval
# steps never run at once, so each capture shares that graph's memory pool
_LAST_GRAPH: "weakref.WeakKeyDictionary[SAM2Model, weakref.ref]" = weakref.WeakKeyDictionary()


def _shared_pool(model):
    """The memory pool of ``model``'s last step graph while it lives, else
    None (a new pool)."""
    ref = _LAST_GRAPH.get(model)
    g = ref() if ref is not None else None
    return g.graph.pool() if g is not None and g.graph is not None else None


class _Captured:
    """The CUDA graphs of one step function, one a key (at most
    ``MAX_GRAPHS``, the last made), and the step's generator on each
    device. ``captures`` counts the captures made; ``last`` is the graph
    of the last call (its ``capture_s`` and ``pool_bytes``)."""

    def __init__(self):
        self.graphs: dict = {}
        self.gens: dict = {}
        self.captures = 0
        self.last = None

    def generator(self, device: torch.device) -> torch.Generator:
        g = self.gens.get(str(device))
        if g is None:
            g = self.gens[str(device)] = torch.Generator(device=device)
        return g

    @staticmethod
    def key(model, batch: TrainBatch) -> tuple:
        """What a capture depends on beyond its buffers' contents."""
        return (id(model), model.dtype, tuple((tuple(x.shape), x.dtype, str(x.device)) for x in batch),
                fused_cxblock_enabled(), fused_qkv_window_attention_enabled(),
                distributed.rank(), distributed.world())

    def run(self, key, batch: TrainBatch, seed: int, weights: list, written: list, body, model) -> dict:
        """``body(batch, gen)`` for ``batch`` and ``seed``: the step's graph
        for ``key`` replayed (captured first where there is none, or where a
        tensor of ``weights`` has other memory than the graph read). A
        capture shares the memory pool of ``model``'s last step graph."""
        gen = self.generator(batch.images.device)
        g = self.graphs.get(key)
        # a step's graph stays valid under its own in-place updates and under
        # copies into its tensors (a checkpoint load), not under new memory
        if g is not None and not g.reads(weights, versions=False):
            self.graphs.clear()
            g = None
        if g is None:
            while len(self.graphs) >= MAX_GRAPHS:
                self.graphs.pop(next(iter(self.graphs)))
            bufs = TrainBatch(*(torch.empty_like(x) for x in batch))
            g = FrameGraph(bufs, weights, pool=_shared_pool(model))
            for d, s in zip(bufs, batch):
                d.copy_(s)
            seed_step(gen, seed)
            out = g.warm_up_and_capture(lambda: body(bufs, gen), generators=(gen,))
            self.graphs[key] = self.last = g
            _LAST_GRAPH[model] = weakref.ref(g)
            self.captures += 1
            return out
        for d, s in zip(g.bufs, batch):
            d.copy_(s, non_blocking=True)
        seed_step(gen, seed)
        self.last = g
        g.replay()
        if written:  # the replay updated them in place, unseen by autograd
            torch.autograd.graph.increment_version(written)
        return g.outputs


class TrainStep:
    """``make_train_step``'s step: ``step(state, batch, seed) -> metrics``.
    Metrics are the losses, ``grad_norm``, ``grads`` (the gradients the
    optimizer receives, by parameter name) and ``plan`` (the tensor plan);
    on the card they are the graph's memory, valid until the model's next
    train or eval step.
    ``eager`` runs the body once eagerly (on the card too: the body a
    capture records, for holding a graph against it); ``remat=False`` runs
    it without rematerialisation, for holding the step against the step
    without it (``train_model.train_forward``)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.captured = _Captured()

    @property
    def captures(self) -> int:
        return self.captured.captures

    def body(self, state: TrainState, batch: TrainBatch, gen: torch.Generator, remat: bool = True) -> dict:
        cfg = self.cfg
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        losses, plan = _losses(model, cfg, batch, gen, is_training=True, remat=remat)
        # every plan's loss has a graph: positions 1..n_init_max-1 run the
        # tracked branch under a selection, so a plan whose frames are all
        # mask-prompted initial frames gets exact zero gradients, as JAX's
        # value_and_grad gives them (its AdamW still applies the weight decay)
        losses[CORE_LOSS_KEY].backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}
        if cfg.optim.grad_dtype == "bfloat16":  # the reference's bf16 gradient hook, before the reduction
            grads = {n: g.to(torch.bfloat16).to(g.dtype) for n, g in grads.items()}
        grads = distributed.all_reduce_gradients(grads)
        state.optimizer.step(grads)
        metrics = _global(losses)
        metrics["grad_norm"] = global_norm(grads.values())
        metrics["grads"] = grads
        metrics["plan"] = plan
        return metrics

    def eager(self, state: TrainState, batch: TrainBatch, seed: int, remat: bool = True) -> dict:
        gen = self.captured.generator(batch.images.device)
        seed_step(gen, seed)
        metrics = self.body(state, batch, gen, remat)
        state.step += 1
        return metrics

    def __call__(self, state: TrainState, batch: TrainBatch, seed: int) -> dict:
        if batch.images.device.type != "cuda":
            return self.eager(state, batch, seed)
        model, opt = state.model, state.optimizer
        params = list(model.parameters())
        written = params + opt.state_tensors()
        metrics = self.captured.run(self.captured.key(model, batch), batch, seed,
                                    written + list(model.buffers()), written,
                                    lambda b, gen: self.body(state, b, gen), model)
        state.step += 1
        return metrics


class EvalStep:
    """``make_eval_step``'s step: ``step(model, batch, seed) -> losses``,
    eval-mode prompt simulation and loss without gradients (reference
    trainer.py:583-701); on the card one graph a key, as ``TrainStep``."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.captured = _Captured()

    @property
    def captures(self) -> int:
        return self.captured.captures

    def body(self, model: SAM2Model, batch: TrainBatch, gen: torch.Generator) -> dict:
        with torch.no_grad():
            return _global(_losses(model, self.cfg, batch, gen, is_training=False)[0])

    def eager(self, model: SAM2Model, batch: TrainBatch, seed: int) -> dict:
        gen = self.captured.generator(batch.images.device)
        seed_step(gen, seed)
        return self.body(model, batch, gen)

    def __call__(self, model: SAM2Model, batch: TrainBatch, seed: int) -> dict:
        if batch.images.device.type != "cuda":
            return self.eager(model, batch, seed)
        return self.captured.run(self.captured.key(model, batch), batch, seed,
                                 list(model.parameters()) + list(model.buffers()), [],
                                 lambda b, gen: self.body(model, b, gen), model)


def make_train_step(cfg: TrainConfig) -> TrainStep:
    """``train_step(state, batch, seed) -> metrics``: one step of loss,
    gradients and update (``TrainStep``)."""
    return TrainStep(cfg)


def make_eval_step(cfg: TrainConfig) -> EvalStep:
    """``eval_step(model, batch, seed) -> losses`` (``EvalStep``)."""
    return EvalStep(cfg)
