"""qkv projection and windowed multi-head attention in one pass — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_window_attention.py``
(``fused_qkv_window_attention``, body ``_kernel_qkv``). Input is the
post-norm1 token map, zero-padded to whole windows, [B, Hp, Wp, Cin], with the
qkv Linear's weight [3·nh·hd, Cin] and f32 bias; output is [B, Hpo, Wpo,
nh·hd], as ``window_attention`` gives it. The projection accumulates in f32,
adds the f32 bias and rounds once (so pad tokens carry exactly the bias, and
are attended); the attention is ``window_attention``'s: q optionally 2x2
max-pooled inside the window, f32 scores and softmax, P rounded, f32 P·V
rounded once.

On the H100 it is bound by operations: the projection's 2·Hp·Wp·Cin·3·nh·hd
flop dominate the attention's and the ~Hp·Wp·Cin input bytes. The CUDA kernel
(``csrc/qkv_window_attention.cu``) runs one block per (batch, window, head),
so the qkv map never reaches device memory: it streams the window's tokens
and the head's weight rows through shared memory in 96-wide chunks of Cin,
projects q, k and v on bf16 tensor cores (WMMA, f32 accumulation in
registers), pools q in shared memory, and runs ``window_attention``'s S,
softmax and P·V on the result. Each window's tokens are read once per head
and per q/k/v (3·nh times, from L2). hd is 64 or 96, as for
``window_attention``; Cin a multiple of 96 (the ViTDet trunks' 384 and 192
are).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.window_attention import MAX_WS, SUPPORTED_HD, window_attention_plain

CIN_CHUNK = 96


def qkv_window_attention_plain(y, w, b, ws: int, nh: int, q_pool: bool) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``_xla_ref_qkv``): the projection in f32
    on the rounded operands plus the f32 bias, rounded to y's dtype, then
    ``window_attention_plain``."""
    qkv = F.linear(y.float(), w.to(y.dtype).float(), b.float()).to(y.dtype)
    return window_attention_plain(qkv, ws, nh, q_pool)


def qkv_window_attention(y, w, b, ws: int, nh: int, q_pool: bool) -> torch.Tensor:
    """[B, Hp, Wp, Cin] -> [B, Hpo, Wpo, nh·hd]. CPU tensors take the plain
    version; a CUDA tensor launches the kernel (bf16 y and w, f32 b) or
    raises. The gradient is the plain version's, recomputed in the backward
    pass (cast w at use to keep f32 master weights)."""
    if y.is_cpu:
        return qkv_window_attention_plain(y, w, b, ws, nh, q_pool)
    return _lib.with_plain_grad(_kernel, qkv_window_attention_plain, y, w, b, ws, nh, q_pool)


def _kernel(y, w, b, ws, nh, q_pool):
    if (y.device.type != "cuda" or y.dtype != torch.bfloat16 or y.dim() != 4 or not y.is_contiguous()
            or y.data_ptr() % 16):
        raise ValueError("qkv_window_attention kernel takes contiguous, 16-byte aligned bf16 CUDA y")
    bsz, hp, wp, cin = y.shape
    c = w.shape[0]
    hd = c // (3 * nh)
    if 3 * nh * hd != c or hd not in SUPPORTED_HD or cin % CIN_CHUNK:
        raise ValueError(f"qkv_window_attention kernel: {c} outputs != 3*{nh}*hd with hd in "
                         f"{SUPPORTED_HD}, or Cin={cin} % {CIN_CHUNK}")
    if tuple(w.shape) != (c, cin) or w.dtype != torch.bfloat16 or not w.is_contiguous() or w.device != y.device:
        raise ValueError(f"qkv_window_attention kernel: w must be contiguous bf16 ({c}, {cin})")
    if tuple(b.shape) != (c,) or b.dtype != torch.float32 or not b.is_contiguous() or b.device != y.device:
        raise ValueError(f"qkv_window_attention kernel: b must be contiguous f32 ({c},)")
    if not 0 < ws <= MAX_WS or hp % ws or wp % ws or (q_pool and ws % 2):
        raise ValueError(f"qkv_window_attention kernel: ws={ws} must divide {hp}x{wp}, <= {MAX_WS}")
    wso = ws // 2 if q_pool else ws
    out = torch.empty((bsz, hp // ws * wso, wp // ws * wso, nh * hd), dtype=y.dtype, device=y.device)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_qkv_window_attention_bf16", [_lib.P] * 4 + [_lib.I] * 8 + [_lib.F, _lib.P])
    rc = _fn(y.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, hp, wp, cin, ws, nh, hd,
             int(q_pool), float(hd**-0.5), _lib.stream_ptr(y))
    _lib.check(rc, "qkv_window_attention")
    qkv_window_attention.launches += 1
    return out


qkv_window_attention.launches = 0
_fn = None  # usm_qkv_window_attention_bf16, bound at the first launch
