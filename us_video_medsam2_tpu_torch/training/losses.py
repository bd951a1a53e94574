"""Training losses.

Counterpart of the JAX package's ``training/losses.py``: the upstream
multi-step multi-mask loss (reference training/loss_fns.py:20-306) and the
fork's temporal losses (reference training/loss_fnsJ.py:74-389). Steps that
did not run carry ``valid`` False and contribute zero; padded objects are
masked by ``obj_valid``; losses are divided by the valid-object count
(``num_objects``: under data parallelism the global count, which the
temporal term is divided by too, so that the ranks' losses sum to the
global batch's). The temporal term runs over the frame axis of the
final-step logits, per object.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

CORE_LOSS_KEY = "core_loss"
_KEYS = ("loss_mask", "loss_dice", "loss_iou", "loss_class")


def _bce_with_logits(logits, targets):
    relu = torch.maximum(logits, torch.zeros_like(logits))  # half the gradient at 0, as jnp.maximum
    return relu - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(inputs, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Per-element focal loss (reference loss_fns.py:52-92)."""
    prob = torch.sigmoid(inputs)
    ce = _bce_with_logits(inputs, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def dice_loss_multimask(inputs, targets):
    """[N, M, H, W] -> [N, M] (reference loss_fns.py:20-49)."""
    p = torch.sigmoid(inputs).flatten(2)
    t = targets.flatten(2)
    return 1 - (2 * (p * t).sum(-1) + 1) / (p.sum(-1) + t.sum(-1) + 1)


def iou_loss_multimask(inputs, targets, pred_ious, use_l1_loss: bool = True):
    """[N, M, H, W], [N, M] -> [N, M] (reference loss_fns.py:95-123)."""
    pred = inputs.flatten(2) > 0
    gt = targets.flatten(2) > 0
    actual = (pred & gt).sum(-1).float() / torch.clamp((pred | gt).sum(-1).float(), min=1.0)
    return (pred_ious - actual).abs() if use_l1_loss else (pred_ious - actual).square()


@dataclass(frozen=True)
class LossConfig:
    """weight_dict + options (reference GFTE_3.yaml:305-317, loss_fns.py:126-165)."""

    weight_mask: float = 20.0
    weight_dice: float = 1.0
    weight_iou: float = 1.0
    weight_class: float = 1.0
    weight_temporal: float = 0.0  # fork default 0.5 when the temporal loss is on
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    focal_alpha_obj_score: float = -1.0
    focal_gamma_obj_score: float = 0.0
    supervise_all_iou: bool = True
    iou_use_l1_loss: bool = True
    pred_obj_scores: bool = True
    temporal_variant: str = "consistency"  # 'consistency' | 'graph' | 'spectral'


def _step_losses(cfg: LossConfig, src_masks, target_masks, ious, object_score_logits):
    """One prediction step: [N, M, H, W] masks -> dict of [N] losses."""
    n, m = src_masks.shape[:2]
    src = src_masks.float()
    tgt = target_masks.float().expand_as(src)
    loss_multimask = sigmoid_focal_loss(src, tgt, cfg.focal_alpha, cfg.focal_gamma).flatten(2).mean(-1)
    loss_multidice = dice_loss_multimask(src, tgt)
    loss_multiiou = iou_loss_multimask(src, tgt, ious.float(), cfg.iou_use_l1_loss)
    target_obj = (tgt[:, 0].reshape(n, -1) > 0).any(-1, keepdim=True).float()  # [N, 1]
    if cfg.pred_obj_scores:
        loss_class = sigmoid_focal_loss(object_score_logits.float(), target_obj,
                                        cfg.focal_alpha_obj_score, cfg.focal_gamma_obj_score).mean(-1)
    else:
        loss_class = torch.zeros(n, device=src.device)
    if m > 1:
        best = (loss_multimask * cfg.weight_mask + loss_multidice * cfg.weight_dice).argmin(-1)

        def take(x):
            return x.gather(1, best[:, None])[:, 0]

        loss_mask, loss_dice = take(loss_multimask), take(loss_multidice)
        loss_iou = loss_multiiou.mean(-1) if cfg.supervise_all_iou else take(loss_multiiou)
    else:
        loss_mask, loss_dice, loss_iou = loss_multimask[:, 0], loss_multidice[:, 0], loss_multiiou[:, 0]
    obj = target_obj[:, 0]
    return {"loss_mask": loss_mask * obj, "loss_dice": loss_dice * obj, "loss_iou": loss_iou * obj,
            "loss_class": loss_class}


# --------------------------------------------------------------------- temporal
def temporal_consistency_loss(logits, alpha=0.1, beta=0.05, threshold=0.1, low_penalty=0.1,
                              high_penalty=1.0, use_semantic_weight=True):
    """Hybrid pairwise/graph/confidence-weighted loss over [T, H, W] (reference loss_fnsJ.py:74-170)."""
    t = logits.shape[0]
    if t < 2:
        return logits.new_zeros((), dtype=torch.float32)
    probs = torch.sigmoid(logits.float())

    def flexible(d):
        return torch.where(d < threshold, d * low_penalty, d * high_penalty)

    basic_loss = flexible((probs[1:] - probs[:-1]).abs().mean(dim=(-1, -2))).mean()
    graph_loss = 0.0
    if t > 2:
        center, left, right = probs[1:-1], probs[:-2], probs[2:]
        gd = (((center - left).abs() + (center - right).abs()) / 2.0).mean(dim=(-1, -2))
        graph_loss = flexible(gd).mean()
    weighted_loss = 0.0
    if use_semantic_weight:
        spatial_conf = (1.0 - 2.0 * (probs - 0.5).abs()).mean(dim=(-1, -2))
        wp = probs * torch.softmax(spatial_conf * 5.0, 0)[:, None, None]
        weighted_loss = (wp[1:] - wp[:-1]).abs().mean()
    return alpha * basic_loss + beta * graph_loss + 0.05 * weighted_loss


def temporal_graph_consistency_loss(logits, alpha=0.1, beta=0.05, use_semantic_weight=True):
    """(reference loss_fnsJ.py:173-218)"""
    t = logits.shape[0]
    if t < 2:
        return logits.new_zeros((), dtype=torch.float32)
    probs = torch.sigmoid(logits.float())
    basic = (probs[1:] - probs[:-1]).abs().mean()
    graph = 0.0
    if t > 2:
        center, left, right = probs[1:-1], probs[:-2], probs[2:]
        graph = ((center - left).abs() + (center - right).abs()).mean() / 2.0
    weighted = 0.0
    if use_semantic_weight:
        conf = (1.0 - 2.0 * (probs - 0.5).abs()).mean(dim=(-1, -2))
        wp = probs * torch.softmax(conf * 5.0, 0)[:, None, None]
        weighted = (wp[1:] - wp[:-1]).abs().mean()
    return alpha * basic + beta * graph + 0.05 * weighted


def spectral_temporal_regularizer(logits, alpha=0.1, beta=0.05, phase_weight=0.02,
                                  freq_cutoff=0.3, adaptive_temp=0.1):
    """Chebyshev smoothness + rFFT high-frequency + sliced Wasserstein + phase
    consistency with JS-confidence weights (reference loss_fnsJ.py:221-389)."""
    t = logits.shape[0]
    if t < 2:
        return logits.new_zeros((), dtype=torch.float32)
    probs = torch.sigmoid(logits.float())  # [T, H, W]
    kl1 = probs * torch.log((probs + 1e-8) / 0.5)
    kl2 = (1 - probs) * torch.log((1 - probs + 1e-8) / 0.5)
    js = 0.5 * (kl1 + kl2).mean(dim=(-1, -2))  # [T]
    wp = probs * torch.softmax(torch.exp(-adaptive_temp * js), 0)[:, None, None]

    spectral = 0.0
    if t >= 3:
        sig = wp.permute(1, 2, 0).reshape(-1, t)  # [HW, T]
        mid = sig[:, 2:] + sig[:, :-2] - 2 * sig[:, 1:-1]
        x1 = torch.cat([torch.zeros_like(sig[:, :1]), mid, torch.zeros_like(sig[:, :1])], 1)
        spectral = ((1.0 * sig + (-2.0) * x1) ** 2).mean()
        # the frequencies past the cutoff: a tail of rfftfreq's increasing
        # bins, sliced by a host index (no boolean gather, which reads back)
        high = int((torch.fft.rfftfreq(t, d=1.0) <= freq_cutoff).sum())
        if high < t // 2 + 1:
            spectral = spectral + 0.5 * (torch.fft.rfft(sig, dim=1)[:, high:].abs() ** 2).mean()

    srt = torch.sort(wp.reshape(t, -1), dim=1).values
    wasserstein = (srt[1:] - srt[:-1]).abs().mean()

    phase_loss = 0.0
    if t >= 3:
        grad = (wp[2:] - wp[:-2]) / 2.0
        phase = torch.atan2(grad, wp[1:-1] + 1e-8)
        pd = (phase[1:] - phase[:-1]).abs()
        phase_loss = torch.where(pd > math.pi, 2 * math.pi - pd, pd).mean()
    return alpha * spectral + beta * wasserstein + phase_weight * phase_loss


TEMPORAL_LOSSES = {
    "consistency": temporal_consistency_loss,
    "graph": temporal_graph_consistency_loss,
    "spectral": spectral_temporal_regularizer,
}


def _temporal(cfg: LossConfig, final_logits_by_frame, ow, num_objects):
    if cfg.weight_temporal == 0.0 or final_logits_by_frame is None:
        return ow.new_zeros(())
    fn = TEMPORAL_LOSSES[cfg.temporal_variant]
    per_obj = torch.stack([fn(final_logits_by_frame[:, i]) for i in range(final_logits_by_frame.shape[1])])
    return (per_obj * ow).sum() / num_objects


def _core(cfg: LossConfig, losses: dict) -> dict:
    losses[CORE_LOSS_KEY] = (
        losses["loss_mask"] * cfg.weight_mask + losses["loss_dice"] * cfg.weight_dice
        + losses["loss_iou"] * cfg.weight_iou + losses["loss_class"] * cfg.weight_class
        + losses["loss_temporal"] * cfg.weight_temporal
    )
    return losses


def multi_step_multimasks_and_ious(cfg: LossConfig, frame_outputs, frame_targets, obj_valid,
                                   final_logits_by_frame=None,
                                   num_objects: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Multi-step loss over lists: ``frame_outputs`` holds, per processed
    frame, a list over steps of {"multimasks" [O, M, H, W], "ious" [O, M],
    "score" [O, 1], "valid"}; ``frame_targets`` [O, H, W] per frame
    (reference loss_fns.py:167-306, loss_fnsJ.py:391-508)."""
    ow = obj_valid.float()
    if num_objects is None:
        num_objects = torch.clamp(ow.sum(), min=1.0)
    losses = {k: 0.0 for k in _KEYS}
    for steps, target in zip(frame_outputs, frame_targets):
        tgt = target[:, None].float()
        for step in steps:
            out = _step_losses(cfg, step["multimasks"], tgt, step["ious"], step["score"])
            w = float(step["valid"]) * ow
            for k in losses:
                losses[k] = losses[k] + (out[k] * w).sum() / num_objects
    losses["loss_temporal"] = _temporal(cfg, final_logits_by_frame, ow, num_objects)
    return _core(cfg, losses)


def multi_step_loss_stacked(cfg: LossConfig, stacked: Dict[str, torch.Tensor], obj_valid: torch.Tensor,
                            final_logits_by_frame: Optional[torch.Tensor] = None,
                            num_objects: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The same loss over ``train_model.train_forward``'s stacked outputs:
    step0_multimasks [T, Bo, 3, H, W], step0_ious [T, Bo, 3], step0_score
    [T, Bo, 1], corr_* with a step axis [T, S, Bo, ...], corr_valid [T, S],
    target [T, Bo, H, W]; (frame, step) folded into the object axis."""
    t, bo = stacked["target"].shape[:2]
    ow = obj_valid.float()
    if num_objects is None:
        num_objects = torch.clamp(ow.sum(), min=1.0)
    tgt = stacked["target"].float()[:, :, None]  # [T, Bo, 1, H, W]
    h, w = tgt.shape[-2:]
    l0 = _step_losses(cfg, stacked["step0_multimasks"].reshape(t * bo, 3, h, w),
                      tgt.reshape(t * bo, 1, h, w), stacked["step0_ious"].reshape(t * bo, 3),
                      stacked["step0_score"].reshape(t * bo, 1))
    w0 = ow.repeat(t)
    losses = {k: (v * w0).sum() / num_objects for k, v in l0.items()}
    s = stacked["corr_multimasks"].shape[1]
    if s > 0:
        tgt_s = tgt[:, None].expand(t, s, bo, 1, h, w)
        lc = _step_losses(cfg, stacked["corr_multimasks"].reshape(t * s * bo, 1, h, w),
                          tgt_s.reshape(t * s * bo, 1, h, w), stacked["corr_ious"].reshape(t * s * bo, 1),
                          stacked["corr_score"].reshape(t * s * bo, 1))
        wc = (stacked["corr_valid"].float()[:, :, None] * ow[None, None, :]).reshape(t * s * bo)
        for k in losses:
            losses[k] = losses[k] + (lc[k] * wc).sum() / num_objects
    losses["loss_temporal"] = _temporal(cfg, final_logits_by_frame, ow, num_objects)
    return _core(cfg, losses)
