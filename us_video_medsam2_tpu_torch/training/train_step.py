"""The training step: prompt-simulated tracking forward + loss + AdamW.

Counterpart of the JAX package's ``training/train_step.py``. The step runs
on the card (bf16 compute, f32 master weights cast at use) unless the caller
asks for the CPU (the plain versions, in the dtype it names). The model's
parameters and the optimizer's moments are updated in place.

In a ``torch.distributed`` group (``parallel/distributed.py``) each rank
holds its share of the global batch (equal shares): the valid-object count
is summed over the ranks before the loss divides by it, the prompt noise is
drawn for the global batch's objects and sliced (``train_forward``'s
``shard``), and the gradients are summed over the ranks, so the step equals
the single-process step on the global batch, as the JAX package's sharded
step does. The metrics are the global batch's. The dropouts (attention,
residual, the temporal fusion's) draw on each rank for its own rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from us_video_medsam2_tpu_torch.core.device import resolve_device
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.parallel import distributed
from us_video_medsam2_tpu_torch.training.losses import CORE_LOSS_KEY, LossConfig, multi_step_loss_stacked
from us_video_medsam2_tpu_torch.training.optimizer import AdamW, OptimConfig, global_norm
from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig, train_forward


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
            is_training: bool):
    obj_valid = batch.obj_valid.reshape(-1)
    shard = num_objects = None
    if distributed.is_initialized():
        n = obj_valid.numel()
        shard = (distributed.rank() * n, distributed.world() * n)
        num_objects = torch.clamp(distributed.all_reduce_sum(obj_valid.float().sum()), min=1.0)
    stacked, finals, plan = train_forward(model, gen, batch.images, batch.masks, cfg.sim, is_training, shard)
    losses = multi_step_loss_stacked(cfg.loss, stacked, obj_valid, final_logits_by_frame=finals,
                                     num_objects=num_objects)
    return losses, plan


def _global(losses: dict) -> dict:
    """The losses of the global batch: each rank's is its share."""
    return {k: distributed.all_reduce_sum(v.detach()) for k, v in losses.items()}


def make_train_step(cfg: TrainConfig):
    """``train_step(state, batch, gen) -> metrics``: one step of loss,
    gradients and update. ``gen`` is a CPU generator that draws the step's
    plan and every random number of the simulation. Metrics are the losses,
    ``grad_norm`` and ``grads`` (the gradients the optimizer receives, by
    parameter name) and ``plan``."""

    def train_step(state: TrainState, batch: TrainBatch, gen: torch.Generator) -> dict:
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        losses, plan = _losses(model, cfg, batch, gen, is_training=True)
        # a plan whose every frame is a mask-prompted conditioning frame gives
        # the masks themselves as outputs: no parameter reaches the loss, and
        # the gradients are 0, as JAX's value_and_grad gives them. Any other
        # loss without a graph is a fault, and its backward raises.
        no_tracked_frame = plan.mode == 2 and all(plan.is_init)
        if not (no_tracked_frame and not losses[CORE_LOSS_KEY].requires_grad):
            losses[CORE_LOSS_KEY].backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}
        if cfg.optim.grad_dtype == "bfloat16":  # the reference's bf16 gradient hook, before the reduction
            grads = {n: g.to(torch.bfloat16).to(g.dtype) for n, g in grads.items()}
        grads = distributed.all_reduce_gradients(grads)
        state.optimizer.step(grads)
        state.step += 1
        metrics = _global(losses)
        metrics["grad_norm"] = global_norm(grads.values())
        metrics["grads"] = grads
        metrics["plan"] = plan
        return metrics

    return train_step


def make_eval_step(cfg: TrainConfig):
    """``eval_step(model, batch, gen) -> losses``: eval-mode prompt simulation
    and loss, no gradients (reference trainer.py:583-701)."""

    @torch.no_grad()
    def eval_step(model: SAM2Model, batch: TrainBatch, gen: torch.Generator) -> dict:
        return _global(_losses(model, cfg, batch, gen, is_training=False)[0])

    return eval_step
