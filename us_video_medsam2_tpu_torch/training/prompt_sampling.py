"""Interactive-prompt simulation samplers, on the masks' device.

Counterpart of the JAX package's ``training/prompt_sampling.py`` (reference
sam2/modeling/sam2_utils.py:156-323): noised ground-truth boxes, uniform
clicks in the error region, and RITM centre clicks through an iterative
chamfer distance transform. Every random draw comes from the explicit
``torch.Generator`` the caller passes (of the masks' device). Under data
parallelism ``shard`` = (offset, total) says where this process's objects
lie among the global batch's: a draw is made for all ``total`` objects and
this process's rows taken, so every rank draws what the single-process step
on the global batch draws for the same objects.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SQRT2 = torch.tensor(2.0).sqrt().item()  # sqrt(2) rounded to f32, as the JAX table holds it


def mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] bool -> [B, 1, 4] xyxy f32; an empty mask gives the box 0, 0, 0, 0."""
    _, _, h, w = masks.shape
    ys = torch.arange(h, device=masks.device)[None, None, :, None]
    xs = torch.arange(w, device=masks.device)[None, None, None, :]
    big = 1 << 30
    x_min = torch.where(masks, xs, big).amin(dim=(2, 3))
    x_max = torch.where(masks, xs, -1).amax(dim=(2, 3))
    y_min = torch.where(masks, ys, big).amin(dim=(2, 3))
    y_max = torch.where(masks, ys, -1).amax(dim=(2, 3))
    empty = ~masks.any(dim=(2, 3))
    box = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(empty[..., None], 0, box).float()


def rand_rows(shape, gen: torch.Generator, device, shard=None, axis: int = 0) -> torch.Tensor:
    """torch.rand of ``shape`` whose ``axis`` holds the objects; with ``shard``
    (offset, total) the rows [offset, offset + n) of a draw over ``total``."""
    if shard is None:
        return torch.rand(shape, generator=gen, device=device)
    off, total = shard
    full = list(shape)
    full[axis] = total
    return torch.rand(full, generator=gen, device=device).narrow(axis, off, shape[axis])


def sample_box_points(masks: torch.Tensor, gen: torch.Generator, noise: float = 0.1,
                      noise_bound: float = 20.0, shard=None):
    """[B, 1, H, W] -> coords [B, 2, 2], labels [B, 2] (2 and 3: box corners)."""
    b, _, h, w = masks.shape
    box = mask_to_box(masks)
    labels = torch.tensor([[2, 3]], dtype=torch.int32, device=masks.device).repeat(b, 1)
    if noise > 0:
        bw = box[..., 2] - box[..., 0]
        bh = box[..., 3] - box[..., 1]
        max_dx = torch.clamp(bw * noise, max=noise_bound)
        max_dy = torch.clamp(bh * noise, max=noise_bound)
        bn = 2 * rand_rows((b, 1, 4), gen, masks.device, shard) - 1
        box = box + bn * torch.stack([max_dx, max_dy, max_dx, max_dy], dim=-1)
        bounds = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=torch.float32, device=masks.device)
        box = torch.clamp(box, min=torch.zeros_like(bounds), max=bounds)
    return box.reshape(b, 2, 2), labels


def _argmax2d(x: torch.Tensor):
    """(max, first-occurrence flat argmax) over the last two [H, W] axes."""
    w = x.shape[-1]
    y = x.amax(dim=-1).argmax(dim=-1)
    row = x.gather(-2, y[..., None, None].expand(*y.shape, 1, w))[..., 0, :]
    xcol = row.argmax(dim=-1)
    return row.gather(-1, xcol[..., None])[..., 0], y * w + xcol


def sample_random_points_from_errors(gt_masks: torch.Tensor, pred_masks: torch.Tensor | None,
                                     gen: torch.Generator, shard=None):
    """[B, 1, H, W] bool -> (points [B, 1, 2] f32, labels [B, 1] int32): a
    uniform click among the false positives (label 0) and false negatives
    (label 1); an all-correct prediction draws from the background."""
    if pred_masks is None:
        pred_masks = torch.zeros_like(gt_masks)
    b, _, h, w = gt_masks.shape
    fp = ~gt_masks & pred_masks
    fn = gt_masks & ~pred_masks
    all_correct = (gt_masks == pred_masks).all(dim=3, keepdim=True).all(dim=2, keepdim=True)
    noise = rand_rows((2, b, 1, h, w), gen, gt_masks.device, shard, axis=1)
    max0, pix0 = _argmax2d(noise[0] * (fp | (all_correct & ~gt_masks)))
    max1, pix1 = _argmax2d(noise[1] * fn)
    take1 = (max1 > max0) | ((max1 == max0) & (pix1 < pix0))
    pix = torch.where(take1, pix1, pix0)
    points = torch.stack([(pix % w).float(), (pix // w).float()], dim=2)
    return points, take1.int()


def _distance_transform(mask: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Approximate L2 distance to the nearest False pixel of [B, H, W] bool:
    ``num_iters`` 3x3 min-pool sweeps with steps 1 and sqrt(2)."""
    _, h, w = mask.shape
    big = 1e9
    d = torch.where(mask, big, 0.0)
    for _ in range(num_iters):
        p = F.pad(d, (1, 1, 1, 1), value=big)
        m = d
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                step = 1.0 if (dy == 1 or dx == 1) else _SQRT2
                m = torch.minimum(m, p[:, dy: dy + h, dx: dx + w] + step)
        d = torch.where(mask, m, 0.0)
    return d


def sample_one_point_from_error_center(gt_masks: torch.Tensor, pred_masks: torch.Tensor | None,
                                       gen: torch.Generator | None = None, num_dt_iters: int = 64):
    """RITM centre click: the error pixel farthest from the error region's
    boundary (with the reference's 1-pixel border), positive if it lies in
    the false negatives. Draws nothing."""
    if pred_masks is None:
        pred_masks = torch.zeros_like(gt_masks)
    b, _, h, w = gt_masks.shape
    fp = (~gt_masks & pred_masks)[:, 0]
    fn = (gt_masks & ~pred_masks)[:, 0]
    border = torch.zeros((b, h, w), dtype=torch.bool, device=gt_masks.device)
    border[:, 1:-1, 1:-1] = True
    fn_max, fn_arg = _argmax2d(_distance_transform(fn & border, num_dt_iters))
    fp_max, fp_arg = _argmax2d(_distance_transform(fp & border, num_dt_iters))
    is_positive = fn_max > fp_max
    idx = torch.where(is_positive, fn_arg, fp_arg)
    pts = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)[:, None]
    return pts, is_positive.int()[:, None]


def get_next_point(gt_masks, pred_masks, method: str, gen: torch.Generator | None, shard=None):
    if method == "uniform":
        return sample_random_points_from_errors(gt_masks, pred_masks, gen, shard)
    if method == "center":
        return sample_one_point_from_error_center(gt_masks, pred_masks, gen)
    raise ValueError(f"unknown sampling method {method}")
