"""LayerNorm -> Linear -> exact GELU -> Linear -> residual — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_mlp.py``
(``ln_mlp_residual``, body ``_kernel``): the MLP tail of every Hiera block,
out = x + W2·GELU(W1·LN(x) + b1) + b2. LN uses the two-pass variance with f32
statistics; the bf16 rounding points are those of the JAX ``_xla_ref``: LN
output, W1 product plus bias, GELU output, W2 product plus bias, residual sum.
GELU is the exact erf form (``erff``), not the TPU's polynomial.

On the H100 it is bound by operations at the trunk shapes (4·N·D·F flop
against 4·N·D + 4·D·F bytes: ~150-500 flop/byte with N >= 256). The CUDA
kernel (``csrc/ln_mlp_residual.cu``) keeps the [tile, F] hidden activation
out of device memory: one block per 32-token tile normalises the tile into
shared memory, then walks F in 128-wide chunks, computing the chunk of
hidden units with bf16 tensor-core products (WMMA, f32 accumulation), applying
bias and GELU in shared memory, and accumulating its contribution to the
[32, D] output in f32 fragments held in registers across the chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_D = (96, 192, 384, 768)
F_CHUNK = 128


def ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain PyTorch version over x [N, D]; w1 [F, D], w2 [D, F] (Linear layout).
    Products run in f32 on the rounded operands, as f32-accumulating
    tensor-core products do."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(x.dtype)
    h = (F.linear(y.float(), w1.to(x.dtype).float()) + b1.float()).to(x.dtype)
    h = F.gelu(h.float(), approximate="none").to(x.dtype)
    o = (F.linear(h.float(), w2.to(x.dtype).float()) + b2.float()).to(x.dtype)
    return x + o


def ln_mlp_residual(x, ln_w, ln_b, w1, b1, w2, b2, eps: float = 1e-6):
    """x [N, D] -> x + MLP(LN(x)). CPU tensors take the plain version; a CUDA
    tensor launches the kernel (bf16 x/w1/w2, f32 LN params and biases) or
    raises. The gradient is the plain version's, recomputed in the backward
    pass (cast w1/w2 at use to keep f32 master weights)."""
    if x.is_cpu:
        return ln_mlp_residual_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    return _lib.with_plain_grad(_kernel, ln_mlp_residual_plain, x, ln_w, ln_b, w1, b1, w2, b2, eps)


def _kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps):
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("ln_mlp_residual kernel takes contiguous bf16 CUDA x [N, D]")
    n, d = x.shape
    f = w1.shape[0]
    if d not in SUPPORTED_D or f % F_CHUNK:
        raise ValueError(f"ln_mlp_residual kernel: D={d} not in {SUPPORTED_D} or F={f} % {F_CHUNK}")
    expect = {
        "ln_w": (ln_w, (d,), torch.float32), "ln_b": (ln_b, (d,), torch.float32),
        "w1": (w1, (f, d), torch.bfloat16), "b1": (b1, (f,), torch.float32),
        "w2": (w2, (d, f), torch.bfloat16), "b2": (b2, (d,), torch.float32),
    }
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ln_mlp_residual kernel: {name} must be contiguous {dt} {shape}")
    out = torch.empty_like(x)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_ln_mlp_residual_bf16", [_lib.P] * 8 + [_lib.I] * 3 + [_lib.F, _lib.P])
    rc = _fn(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, d, f, float(eps),
             _lib.stream_ptr(x))
    _lib.check(rc, "ln_mlp_residual")
    ln_mlp_residual.launches += 1
    return out


ln_mlp_residual.launches = 0
_fn = None  # usm_ln_mlp_residual_bf16, bound at the first launch
