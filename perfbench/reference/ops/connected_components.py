# Frozen copy of us_video_medsam2_tpu_torch/ops/connected_components.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""Connected components, hole filling and sprinkle removal, in plain torch.

Counterpart of the JAX package's ``ops/connected_components.py`` (the
reference's CUDA connected-components extension, sam2/utils/misc.py:312-339).
``small_component_mask`` is the same bounded-propagation algorithm: A rounds
of masked 8-neighbourhood min-propagation of linear indices, a flood of the
pixels whose neighbourhood disagrees, and a (2A+1)² windowed count of pixels
sharing the label. Neighbourhood min/max and dilation are 3x3 max-pools and
the windowed count runs one window row at a time over an unfold view (a
[B, H, W, 2A+1] compare, never the whole [B, (2A+1)², H, W] window), all
exact on f32 labels (< 2^24, plus the 2^30 sentinel).

``connected_components`` is JAX's labeller: a neighbourhood min (a max-pool),
a hook of each root to its smallest neighbour label (``scatter_reduce``) and
two pointer jumps (``gather``) a round, the same rounds as JAX, so the labels
are JAX's own. ``fill_holes_fast`` is JAX's gather-free filler, kept there for
ablation: the border's background flooded by masked 8-dilations, then a
(2·max_area+1)² box count (separable sums) of the pockets left. Both are
exact on f32 values below 2^24. ``fill_holes_in_mask_scores`` takes JAX's
``method``: "exact" (the default, the predictors' only use) or "fast".
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INF = float(2**30)


def _pool_max(x: torch.Tensor, r: int = 1) -> torch.Tensor:
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def _neighbor_min(labels: torch.Tensor, fg: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """Min label over the 8-neighbourhood (the pixel itself included, which
    leaves every min below unchanged), ``inf`` off the foreground."""
    return torch.where(fg, -_pool_max(-torch.where(fg, labels, inf)), inf)


def connected_components(mask: torch.Tensor, num_iters: int = 16):
    """Label the 8-connected components of a [B, H, W] bool mask.

    ``num_iters`` rounds, each a local neighbourhood min, a hook of the root
    to it and two pointer jumps (JAX's rounds; 16 is exact for the mask
    topologies of 128²-512² frames). Returns (labels, areas), both [B, H, W]
    int32: 1-based component ids (0 on the background; the id is the
    component's smallest linear index + 1) and each pixel's component area
    (0 on the background), as the reference kernel's outputs."""
    b, h, w = mask.shape
    hw = h * w
    fg = mask.bool()
    idx = torch.arange(hw, dtype=torch.float32, device=mask.device).reshape(1, h, w)
    inf = torch.full((b, h, w), _INF, dtype=torch.float32, device=mask.device)
    labels = torch.where(fg, idx.expand(b, h, w), inf)
    fgf = fg.reshape(b, hw)
    inf_flat = inf.reshape(b, hw)
    for _ in range(num_iters):
        nmin = torch.minimum(labels, _neighbor_min(labels, fg, inf))
        flat = torch.where(fgf, labels.reshape(b, hw), inf_flat)
        cand = torch.where(fgf, nmin.reshape(b, hw), inf_flat)
        # hook: the smaller neighbour label scattered onto the current root
        root = torch.where(flat < _INF, flat, 0.0).long()
        flat = flat.scatter_reduce(1, root, cand, reduce="amin", include_self=True)
        flat = torch.where(fgf, flat, inf_flat)
        # compress: label <- label[label], twice
        for _ in range(2):
            live = flat < _INF
            jumped = flat.gather(1, torch.where(live, flat, 0.0).long())
            flat = torch.where(live, torch.minimum(flat, jumped), inf_flat)
        labels = flat.reshape(b, h, w)
    flat = labels.reshape(b, hw)
    safe = torch.where(flat < _INF, flat, 0.0).long()
    counts = torch.zeros(b, hw, dtype=torch.int32, device=mask.device)
    counts.scatter_add_(1, safe, fgf.int())
    areas = torch.where(fg, counts.gather(1, safe).reshape(b, h, w), 0)
    labels_out = torch.where(fg, safe.reshape(b, h, w).int() + 1, 0)
    return labels_out, areas


def small_component_mask(fg: torch.Tensor, max_area: int) -> torch.Tensor:
    """[B, H, W] bool: pixels of 8-connected components of ``fg`` whose area
    is <= max_area (border-touching components included)."""
    b, h, w = fg.shape
    a = max(1, int(max_area))
    idx = torch.arange(h * w, dtype=torch.float32, device=fg.device).reshape(1, h, w)
    inf = torch.full_like(idx, _INF).expand(b, h, w)
    labels = torch.where(fg, idx.expand(b, h, w), inf)
    for _ in range(a):
        labels = torch.minimum(labels, _neighbor_min(labels, fg, inf))
    nmin = _neighbor_min(labels, fg, inf)
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


def _box_count(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)² box sum of a [B, H, W] bool array, zero outside, as int32."""
    k = 2 * radius + 1
    v = F.avg_pool2d(x.float()[:, None], (k, 1), stride=1, padding=(radius, 0), divisor_override=1)
    v = F.avg_pool2d(v, (1, k), stride=1, padding=(0, radius), divisor_override=1)
    return v[:, 0].int()


def fill_holes_fast(mask: torch.Tensor, max_area: int, flood_iters: int = 256) -> torch.Tensor:
    """JAX's gather-free hole filler: background not reached from the image
    border by ``flood_iters`` masked 8-dilations is a pocket, and a pocket
    pixel whose (2·max_area+1)² window holds at most ``max_area`` pocket
    pixels is set to 0.1. [..., H, W] logits.

    Two benign deviations from the exact filler, as in JAX: small pockets
    touching the border stay unfilled, and so do small holes within
    2·max_area px of another pocket. Large interior pockets are never filled."""
    if max_area <= 0:
        return mask
    shape = mask.shape
    flat = mask.reshape(-1, shape[-2], shape[-1])
    bg = flat <= 0
    border = torch.zeros_like(bg)
    border[:, 0, :] = border[:, -1, :] = True
    border[:, :, 0] = border[:, :, -1] = True
    bgf = bg.float()
    reach = (border & bg).float()
    for _ in range(flood_iters):
        reach = torch.maximum(_pool_max(reach) * bgf, reach)
    pocket = bg & (reach == 0)
    hole = pocket & (_box_count(pocket, max_area) <= max_area)
    return torch.where(hole, torch.full_like(flat, 0.1), flat).reshape(shape)


def fill_holes_in_mask_scores(mask: torch.Tensor, max_area: int, method: str = "exact") -> torch.Tensor:
    """Set small background holes (<= max_area px) of [..., H, W] logits to 0.1.
    ``method`` "exact" (the default): border-touching pockets included, the
    reference kernel's semantics; "fast": ``fill_holes_fast``."""
    if max_area <= 0:
        return mask
    if method == "fast":
        return fill_holes_fast(mask, max_area)
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
