"""2-D resampling of NHWC tensors with torch.nn.functional.interpolate semantics.

The JAX package re-derives torch's interpolation as separable matrix products
(``ops/resize.py``); here the torch operator is the definition itself. Inputs
and outputs stay channels-last at the public boundary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MODES = {"linear": "bilinear", "cubic": "bicubic"}


def resize2d(
    x: torch.Tensor, out_hw: tuple[int, int], mode: str = "linear", antialias: bool = False
) -> torch.Tensor:
    """Resize the spatial axes of [B, H, W, C] with align_corners=False, in f32.

    mode: 'linear' (bilinear) | 'cubic' (bicubic, a=-0.75).
    """
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    dtype = x.dtype
    y = x.permute(0, 3, 1, 2).float()
    y = F.interpolate(y, size=tuple(out_hw), mode=_MODES[mode], align_corners=False,
                      antialias=antialias)
    return y.permute(0, 2, 3, 1).to(dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample of [B, H, W, C]."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
