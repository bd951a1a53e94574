# Frozen copy of us_video_medsam2_tpu_torch/ops/resize.py at commit 40a6c6c, for the
# benchmark's plain reference: imports rewritten to perfbench.reference, every
# kernel replaced by the plain composition in perfbench/reference/plain.py.
"""2-D resampling of NHWC tensors with torch.nn.functional.interpolate semantics.

The JAX package re-derives torch's interpolation as separable matrix products
(``ops/resize.py``); here the torch operator is the definition itself. Inputs
and outputs stay channels-last at the public boundary.

Where a gradient is wanted (training: the SAM heads' mask upsample, the
pos-embed resizes), the forward is still ``F.interpolate`` and the backward
is its adjoint as those separable matrix products, ``Rhᵀ·g·Rw``
(``interp_matrix``): torch's own CUDA backward scatters with atomic adds, so
two runs of one step would give gradients a rounding apart, and through the
bf16 layers above a whole step's gradients ~1e-3 apart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MODES = {"linear": "bilinear", "cubic": "bicubic"}


def interp_matrix(n_in: int, n_out: int, mode: str, device) -> torch.Tensor:
    """[n_out, n_in] f32: the weights ``F.interpolate`` gives each input
    sample along one axis (align_corners=False, no antialias): 'linear'
    two taps at max(scale·(i + 0.5) − 0.5, 0), 'cubic' four taps of the
    a = −0.75 kernel, clamped at the borders. Made with device ops."""
    i = torch.arange(n_out, device=device, dtype=torch.float32)
    src = (n_in / n_out) * (i + 0.5) - 0.5
    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, device=device)
    if mode == "linear":
        src = src.clamp(min=0.0)
        i0 = src.floor()
        w1 = src - i0
        i0 = i0.long()
        i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
        m.index_put_((rows, i0), 1.0 - w1, accumulate=True)
        m.index_put_((rows, i1), w1, accumulate=True)
        return m
    a = -0.75
    i0 = src.floor()
    t = src - i0

    def near(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def far(x):  # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    for k, w in ((-1, far(t + 1.0)), (0, near(t)), (1, near(1.0 - t)), (2, far(2.0 - t))):
        m.index_put_((rows, (i0.long() + k).clamp(0, n_in - 1)), w, accumulate=True)
    return m


_matrices: dict = {}


def _kept_matrix(n_in: int, n_out: int, mode: str, device) -> torch.Tensor:
    """``interp_matrix``, kept by shape, mode and device once made outside a
    CUDA graph capture (a capture reads the kept one, as ``ops/posenc.py``'s
    tables)."""
    key = (n_in, n_out, mode, str(device))
    m = _matrices.get(key)
    if m is None:
        m = interp_matrix(n_in, n_out, mode, device)
        if not (m.is_cuda and torch.cuda.is_current_stream_capturing()):
            _matrices[key] = m
    return m


class _Resize(torch.autograd.Function):
    """``F.interpolate`` of [B, C, H, W] f32 forward; the adjoint by matrix
    products backward (deterministic)."""

    @staticmethod
    def forward(ctx, y, out_hw, mode):
        ctx.in_hw, ctx.out_hw, ctx.mode = tuple(y.shape[-2:]), out_hw, mode
        return F.interpolate(y, size=out_hw, mode=_MODES[mode], align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (hi, wi), (ho, wo) = ctx.in_hw, ctx.out_hw
        rh = _kept_matrix(hi, ho, ctx.mode, g.device)
        rw = _kept_matrix(wi, wo, ctx.mode, g.device)
        return torch.matmul(torch.matmul(rh.t(), g.float()), rw), None, None


def resize2d(
    x: torch.Tensor, out_hw: tuple[int, int], mode: str = "linear", antialias: bool = False
) -> torch.Tensor:
    """Resize the spatial axes of [B, H, W, C] with align_corners=False, in f32.

    mode: 'linear' (bilinear) | 'cubic' (bicubic, a=-0.75). With a gradient
    wanted and no antialias, the backward is ``_Resize``'s.
    """
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    dtype = x.dtype
    y = x.permute(0, 3, 1, 2).float()
    if not antialias and torch.is_grad_enabled() and y.requires_grad:
        y = _Resize.apply(y, tuple(out_hw), mode)
    else:
        y = F.interpolate(y, size=tuple(out_hw), mode=_MODES[mode], align_corners=False,
                          antialias=antialias)
    return y.permute(0, 2, 3, 1).to(dtype)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample of [B, H, W, C]."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
