"""Windowed multi-head attention on the dense qkv layout — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_window_attention.py``
(``fused_window_attention``, body ``_kernel``). Input is the qkv projection in
the layout the Linear writes it, [B, Hp, Wp, 3·nh·hd] (Hp, Wp multiples of the
window ws); output is [B, Hpo, Wpo, nh·hd] in the spatial layout the output
projection reads. Per (window, head): q optionally 2x2 max-pooled inside the
window, S = q·kᵀ·hd^-½ in f32, row softmax in f32, P rounded to the input
dtype, O = P·v accumulated in f32 and rounded once.

On the H100 it is bound by bytes at ws 4/8 (qkv read once, o written once;
~2·Lk·hd flop per byte is below the card's ~295 flop/byte balance) and near
the balance point at ws 14. The CUDA kernel (``csrc/window_attention.cu``)
runs one block per (batch, window, head): it gathers the window's k and v
rows straight from the dense layout into shared memory with 16-byte loads,
max-pools q while loading it, and lets each warp take 16-row query slabs
through S, softmax and P·V on bf16 tensor cores (WMMA, f32 accumulation). The
window partition and unpartition never touch device memory; S never leaves
shared memory. The TPU's lane padding of hd 96 to 128, its window packing and
its last-strip row cut are not carried over: hd 96 (Hiera-tiny) is six 16-deep
k-steps and hd 64 (the ViTDet trunks' ws-14 blocks) four, each its own
instantiation of the kernel; any other head dim raises on the card.
"""

from __future__ import annotations

import torch

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_HD = (64, 96)
MAX_WS = 14


def window_attention_plain(qkv: torch.Tensor, ws: int, nh: int, q_pool: bool) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``_xla_ref``)."""
    b, hp, wp, c = qkv.shape
    hd = c // (3 * nh)
    nwh, nww = hp // ws, wp // ws
    lk = ws * ws
    wso = ws // 2 if q_pool else ws
    lq = wso * wso
    t = qkv.reshape(b, nwh, ws, nww, ws, 3, nh, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    t = t.reshape(3, b * nwh * nww * nh, lk, hd)
    q, k, v = t[0], t[1], t[2]
    n = q.shape[0]
    if q_pool:
        q = q.reshape(n, wso, 2, wso, 2, hd).amax(dim=(2, 4)).reshape(n, lq, hd)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (hd**-0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    o = o.reshape(b, nwh, nww, nh, wso, wso, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, nwh * wso, nww * wso, nh * hd)


def window_attention(qkv: torch.Tensor, ws: int, nh: int, q_pool: bool) -> torch.Tensor:
    """[B, Hp, Wp, 3·nh·hd] -> [B, Hpo, Wpo, nh·hd]. CPU tensors take the plain
    version; a CUDA tensor launches the kernel (bf16) or raises. The gradient
    is the plain version's, recomputed in the backward pass."""
    if qkv.is_cpu:
        return window_attention_plain(qkv, ws, nh, q_pool)
    return _lib.with_plain_grad(_kernel, window_attention_plain, qkv, ws, nh, q_pool)


def _kernel(qkv, ws, nh, q_pool):
    if (qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or qkv.data_ptr() % 16):
        raise ValueError("window_attention kernel takes contiguous, 16-byte aligned bf16 CUDA qkv")
    b, hp, wp, c = qkv.shape
    hd = c // (3 * nh)
    if 3 * nh * hd != c or hd not in SUPPORTED_HD:
        raise ValueError(f"window_attention kernel: channels {c} != 3*{nh}*hd with hd in {SUPPORTED_HD}")
    if not 0 < ws <= MAX_WS or hp % ws or wp % ws or (q_pool and ws % 2):
        raise ValueError(f"window_attention kernel: ws={ws} must divide {hp}x{wp}, <= {MAX_WS}")
    wso = ws // 2 if q_pool else ws
    out = torch.empty((b, hp // ws * wso, wp // ws * wso, nh * hd), dtype=qkv.dtype, device=qkv.device)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_window_attention_bf16", [_lib.P, _lib.P] + [_lib.I] * 7 + [_lib.F, _lib.P])
    rc = _fn(qkv.data_ptr(), out.data_ptr(), b, hp, wp, ws, nh, hd, int(q_pool),
             float(hd**-0.5), _lib.stream_ptr(qkv))
    _lib.check(rc, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
_fn = None  # usm_window_attention_bf16, bound at the first launch
