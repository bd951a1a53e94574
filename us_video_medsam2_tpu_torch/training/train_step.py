"""The training step: prompt-simulated tracking forward + loss + AdamW.

Counterpart of the JAX package's ``training/train_step.py``. The step runs
on the card (bf16 compute, f32 master weights cast at use) unless the caller
asks for the CPU (the plain versions, in the dtype it names). The model's
parameters and the optimizer's moments are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from us_video_medsam2_tpu_torch.core.device import resolve_device
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
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
    stacked, finals, plan = train_forward(model, gen, batch.images, batch.masks, cfg.sim, is_training)
    losses = multi_step_loss_stacked(cfg.loss, stacked, batch.obj_valid.reshape(-1),
                                     final_logits_by_frame=finals)
    return losses, plan


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
        losses[CORE_LOSS_KEY].backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}
        if cfg.optim.grad_dtype == "bfloat16":  # the reference's bf16 gradient hook
            grads = {n: g.to(torch.bfloat16).to(g.dtype) for n, g in grads.items()}
        state.optimizer.step(grads)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
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
        return _losses(model, cfg, batch, gen, is_training=False)[0]

    return eval_step
