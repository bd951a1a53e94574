"""Row LayerNorm, fast-variance form — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_ln.py``
(``layer_norm_pallas``, body ``_ln_kernel``), used at the norm1 site of every
Hiera block. Math: mean and E[x²] in f32 from one read, var = max(E[x²] −
mean², 0), y = (x − mean)·rsqrt(var + eps)·w + b with f32 scale/bias, cast
down once.

On the H100 it is bound by bytes: 4 flop per element against 4 bytes of
traffic (bf16 in, bf16 out). The CUDA kernel (``csrc/layer_norm.cu``) gives
one warp to each row, reads the row once into registers with neighbouring
lanes on neighbouring addresses, reduces both sums with warp shuffles and
writes once — no shared memory and no second pass over device memory.
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
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    return _lib.with_plain_grad(_kernel, layer_norm_plain, x, weight, bias, eps)


def _kernel(x, weight, bias, eps):
    d = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"layer_norm kernel takes contiguous bf16 CUDA x, got {x.dtype} {x.device}")
    if d not in SUPPORTED_D:
        raise ValueError(f"layer_norm kernel: d={d} not in {SUPPORTED_D}")
    for p in (weight, bias):
        if p.dtype != torch.float32 or p.shape != (d,) or p.device != x.device:
            raise ValueError("layer_norm kernel takes f32 weight/bias of shape [d] on x's device")
    rows = x.numel() // d
    out = torch.empty_like(x)
    f = _lib.fn("usm_layer_norm_bf16", [_lib.P] * 4 + [_lib.I, _lib.I, _lib.F, _lib.P])
    rc = f(x.data_ptr(), weight.contiguous().data_ptr(), bias.contiguous().data_ptr(),
           out.data_ptr(), rows, d, float(eps), _lib.stream_ptr(x))
    _lib.check(rc, "layer_norm")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
