"""The whole ConvNeXt block of the memory encoder's fuser — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_cxblock.py``
(``fused_cxblock``, body ``_kernel``): out = x + γ·pwconv2(GELU(pwconv1(LN(
dwconv7x7(x))))) over [B, H, W, C]. Rounding points are those of the JAX
``_xla_ref``: the depthwise conv sums x·taps in f32, adds its f32 bias and
rounds; the LayerNorm (fast variance, f32 statistics) rounds; each pointwise
product accumulates in f32 and rounds, then adds its bias in the input dtype;
GELU is the exact erf form in f32, rounded; the layer scale multiplies and the
residual adds in the input dtype. Weights take the port's layouts: depthwise
[C, 1, k, k], Linear [out, in].

On the H100 the block at [1, 32, 32, 256] is bound by operations: 4·HW·C·4C
flop of the two pointwise products (1.07 GFLOP) against ~2.6 MB of x, out and
weights. The CUDA kernel (``csrc/cxblock.cu``) cannot hold the image in shared
memory as the TPU kernel holds it in VMEM (512 KB against 227 KB), so one
block takes an 8x8 token tile with its 3-pixel halo (14x14x256 bf16, 100 KB):
the depthwise conv runs one channel per thread from shared memory with the 49
taps in registers, LayerNorm one warp per token, and the hidden axis streams
in 128-wide chunks through bf16 tensor-core products (WMMA, f32
accumulation), so the [tokens, 4C] hidden activation never reaches device
memory and the [64, C] output accumulates in registers across the chunks.
At B = 1 that is 16 blocks on 132 SMs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm_plain

SUPPORTED_C = (256,)
KERNEL_SIZE = 7
F_CHUNK = 128


def cxblock_plain(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-6):
    """Plain PyTorch version (the JAX ``_xla_ref``) over x [B, H, W, C];
    dw_w [C, 1, k, k], w1 [4C, C], w2 [C, 4C]. Products run in f32 on the
    rounded operands, as f32-accumulating tensor-core products do."""
    dt = x.dtype
    c, k = x.shape[-1], dw_w.shape[-1]
    dw = F.conv2d(x.float().permute(0, 3, 1, 2), dw_w.float(), dw_b.float(), padding=k // 2, groups=c)
    y = layer_norm_plain(dw.permute(0, 2, 3, 1).to(dt), ln_w, ln_b, eps)
    h = F.linear(y.float(), w1.to(dt).float()).to(dt) + b1.to(dt)
    h = F.gelu(h.float(), approximate="none").to(dt)
    o = F.linear(h.float(), w2.to(dt).float()).to(dt) + b2.to(dt)
    return x + gamma.to(dt) * o


def cxblock(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-6):
    """x [B, H, W, C] -> the ConvNeXt block's output. CPU tensors take the
    plain version; a CUDA tensor launches the kernel (bf16 x/w1/w2, f32 taps,
    biases, LN parameters and γ) or raises. The gradient is the plain
    version's, recomputed in the backward pass (cast w1/w2 at use to keep f32
    master weights)."""
    if x.is_cpu:
        return cxblock_plain(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps)
    return _lib.with_plain_grad(_kernel, cxblock_plain, x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2,
                                gamma, eps)


def _kernel(x, dw_w, dw_b, ln_w, ln_b, w1, b1, w2, b2, gamma, eps):
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("cxblock kernel takes contiguous, 16-byte aligned bf16 CUDA x [B, H, W, C]")
    b, h, w, c = x.shape
    f = w1.shape[0]
    if c not in SUPPORTED_C or f % F_CHUNK:
        raise ValueError(f"cxblock kernel: C={c} not in {SUPPORTED_C} or 4C={f} % {F_CHUNK}")
    expect = {
        "dw_w": (dw_w, (c, 1, KERNEL_SIZE, KERNEL_SIZE), torch.float32),
        "dw_b": (dw_b, (c,), torch.float32), "ln_w": (ln_w, (c,), torch.float32),
        "ln_b": (ln_b, (c,), torch.float32), "w1": (w1, (f, c), torch.bfloat16),
        "b1": (b1, (f,), torch.float32), "w2": (w2, (c, f), torch.bfloat16),
        "b2": (b2, (c,), torch.float32), "gamma": (gamma, (c,), torch.float32),
    }
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"cxblock kernel: {name} must be contiguous {dt} {shape}")
    out = torch.empty_like(x)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_cxblock_bf16", [_lib.P] * 11 + [_lib.I] * 5 + [_lib.F, _lib.P])
    rc = _fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
             out.data_ptr(), b, h, w, c, f, float(eps), _lib.stream_ptr(x))
    _lib.check(rc, "cxblock")
    cxblock.launches += 1
    return out


cxblock.launches = 0
_fn = None  # usm_cxblock_bf16, bound at the first launch
