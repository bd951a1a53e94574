"""Exact small-component masks for hole filling and sprinkle removal, in plain torch.

Counterpart of the JAX package's ``ops/connected_components.py`` (the
reference's CUDA connected-components extension, sam2/utils/misc.py:312-339).
``small_component_mask`` is the same bounded-propagation algorithm: A rounds
of masked 8-neighbourhood min-propagation of linear indices, a flood of the
pixels whose neighbourhood disagrees, and a (2A+1)² windowed count of pixels
sharing the label. Neighbourhood min/max and dilation are 3x3 max-pools and
the windowed count runs one window row at a time over an unfold view (a
[B, H, W, 2A+1] compare, never the whole [B, (2A+1)², H, W] window), all
exact on f32 labels (< 2^24, plus the 2^30 sentinel).

The JAX module's ``connected_components`` labeller and its ``fill_holes_fast``
(kept there for ablation) lie on no path of either package and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INF = float(2**30)


def _pool_max(x: torch.Tensor, r: int = 1) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def small_component_mask(fg: torch.Tensor, max_area: int) -> torch.Tensor:
    """[B, H, W] bool: pixels of 8-connected components of ``fg`` whose area
    is <= max_area (border-touching components included)."""
    b, h, w = fg.shape
    a = max(1, int(max_area))
    idx = torch.arange(h * w, dtype=torch.float32, device=fg.device).reshape(1, h, w)
    inf = torch.full_like(idx, _INF).expand(b, h, w)
    labels = torch.where(fg, idx.expand(b, h, w), inf)

    def neighbor_min(lab):
        return torch.where(fg, -_pool_max(-torch.where(fg, lab, inf)), inf)

    for _ in range(a):
        labels = torch.minimum(labels, neighbor_min(labels))
    nmin = neighbor_min(labels)
    nmax = _pool_max(torch.where(fg, labels, torch.full_like(labels, -1.0)))
    mixed = fg & ((nmin < labels) | ((nmax > labels) & (nmax < _INF)))
    fgf = fg.float()
    flood = mixed.float()
    for _ in range(a):
        flood = torch.maximum(_pool_max(flood) * fgf, flood)
    # (2A+1)^2 window: same-label foreground pixels around each pixel, a row
    # of the window at a time
    padded = F.pad(torch.where(fg, labels, torch.full_like(labels, -2.0)), (a, a, a, a), value=-2.0)
    samecount = torch.zeros(b, h, w, dtype=torch.int32, device=fg.device)
    for dy in range(2 * a + 1):
        row = padded[:, dy: dy + h].unfold(2, 2 * a + 1, 1)  # [B, H, W, 2A+1] view
        samecount += (row == labels[..., None]).sum(-1, dtype=torch.int32)
    return fg & (flood == 0) & (samecount <= max_area)


def fill_holes_in_mask_scores(mask: torch.Tensor, max_area: int) -> torch.Tensor:
    """Set small background holes (<= max_area px) of [..., H, W] logits to 0.1
    (border-touching pockets included)."""
    if max_area <= 0:
        return mask
    shape = mask.shape
    flat = mask.reshape(-1, shape[-2], shape[-1])
    hole = small_component_mask(flat <= 0, max_area)
    return torch.where(hole, torch.full_like(flat, 0.1), flat).reshape(shape)


def remove_small_sprinkles(mask: torch.Tensor, max_area: int) -> torch.Tensor:
    """Set small foreground specks (<= max_area px) of [..., H, W] logits to -10."""
    if max_area <= 0:
        return mask
    shape = mask.shape
    flat = mask.reshape(-1, shape[-2], shape[-1])
    speck = small_component_mask(flat > 0, max_area)
    return torch.where(speck, torch.full_like(flat, -10.0), flat).reshape(shape)
