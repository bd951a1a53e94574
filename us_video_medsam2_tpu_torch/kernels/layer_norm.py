"""Row LayerNorm, fast-variance form — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_ln.py``
(``layer_norm_pallas``, body ``_ln_kernel``), used at the norm1 site of every
Hiera block. Math: mean and E[x²] in f32 from one read, var = max(E[x²] −
mean², 0), y = (x − mean)·rsqrt(var + eps)·w + b with f32 scale/bias, cast
down once.

On the H100 it is bound by bytes: 4 flop per element against 4 bytes of
traffic (bf16 in, bf16 out), under a microsecond a call at the trunk's
shapes, so the host's cost of a call matters as much as the kernel. The CUDA
kernel (``csrc/layer_norm.cu``) gives each row a group of D/24 lanes (several
rows to a warp below D 768), each lane reading three 16-byte chunks with
neighbouring lanes on neighbouring addresses; it keeps w and b in registers
across the rows a thread takes, reduces both sums with shuffles inside the
group and writes once in 16-byte stores. The wrapper checks only what keeps
the kernel's memory accesses in bounds and calls the bound entry point
directly when no gradient is wanted.
"""

from __future__ import annotations

import torch

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_D = (96, 192, 384, 768)


def layer_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Plain PyTorch LayerNorm over the last axis (fast variance, f32 stats)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    meansq = xf.square().mean(-1, keepdim=True)
    var = torch.clamp(meansq - mean.square(), min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm of x [..., d]. CPU tensors take the plain version; a CUDA
    tensor launches the kernel (bf16 x, f32 weight/bias) or raises. The
    gradient is the plain version's, recomputed in the backward pass."""
    if x.is_cpu:
        return layer_norm_plain(x, weight, bias, eps)
    return _lib.with_plain_grad(_kernel, layer_norm_plain, x, weight, bias, eps)


def _kernel(x, weight, bias, eps):
    global _fn
    d = x.shape[-1]
    if not (x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous() and x.data_ptr() % 16 == 0):
        raise ValueError(f"layer_norm kernel takes contiguous, aligned bf16 CUDA x, got {x.dtype} {x.device}")
    if d not in SUPPORTED_D:
        raise ValueError(f"layer_norm kernel: d={d} not in {SUPPORTED_D}")
    dev = x.get_device()
    for p in (weight, bias):
        if not (p.dtype == torch.float32 and p.shape == (d,) and p.get_device() == dev and p.is_contiguous()
                and p.data_ptr() % 16 == 0):
            raise ValueError("layer_norm kernel takes contiguous, aligned f32 weight/bias of shape [d] on x's device")
    out = torch.empty_like(x)
    if _fn is None:
        _fn = _lib.fn("usm_layer_norm_bf16", [_lib.P] * 4 + [_lib.I, _lib.I, _lib.F, _lib.P])
    rc = _fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), x.numel() // d, d, float(eps),
             _lib.stream_ptr(x))
    _lib.check(rc, "layer_norm")
    layer_norm.launches += 1
    return out


_fn = None  # usm_layer_norm_bf16, bound at the first launch
_lib.counted(layer_norm)
