"""Flash attention with a per-key boolean mask — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/flash_attention.py``
(``flash_attention`` / ``flash_attention_masked``, body ``_flash_kernel``),
the memory-attention path behind ``ops/attention.py::sdpa``. q [B, H, Lq, D],
k/v [B, H, Lk, D], key_mask [B, Lk] (True = attend); masked keys contribute
exact zeros. bf16 operands, f32 scores, online softmax in f32, f32
accumulation, one rounding of the output.

On the H100 it is bound by operations at the memory-attention shapes
(4·Lq·Lk·D flop against 2·Lk·D·2 + 2·Lq·D·2 bytes: ~500 flop/byte at
Lq = 1024, D = 256). The CUDA kernel (``csrc/flash_attention.cu``) keeps a
64-row query tile resident in shared memory (4 warps x 16 rows) and streams
64-key K/V tiles through shared memory; S = Q·Kᵀ and O += P·V run on bf16
tensor cores (WMMA, f32 accumulation), the running max and sum stay in f32,
and the [Lq, Lk] score matrix never reaches device memory. At batch 1 the
grid is only Lq/64 = 16 blocks for 132 SMs; splitting the keys across blocks
is left to a later change.
"""

from __future__ import annotations

import torch

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_D = (256,)
NEG_INF = -1e30


def flash_attention_plain(q, k, v, key_mask=None):
    """Plain PyTorch version (the JAX ``ops/attention.py::sdpa`` math)."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_attention(q, k, v, key_mask=None):
    """softmax(q·kᵀ/√D, masked)·v. CPU tensors take the plain version; a CUDA
    tensor launches the kernel (bf16, D in SUPPORTED_D) or raises. The
    gradient is the plain version's, recomputed in the backward pass."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask)
    return _lib.with_plain_grad(_kernel, flash_attention_plain, q, k, v, key_mask)


def _kernel(q, k, v, key_mask):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t, shape in (("q", q, (b, h, lq, d)), ("k", k, (b, h, lk, d)), ("v", v, (b, h, lk, d))):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"flash_attention kernel: {name} must be contiguous, aligned bf16 CUDA {shape}")
    if d not in SUPPORTED_D:
        raise ValueError(f"flash_attention kernel: D={d} not in {SUPPORTED_D}")
    mask_ptr = None
    if key_mask is not None:
        if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, lk) or key_mask.device != q.device:
            raise ValueError(f"flash_attention kernel: key_mask must be bool [{b}, {lk}] on q's device")
        key_mask = key_mask.contiguous()
        mask_ptr = key_mask.data_ptr()
    out = torch.empty_like(q)
    fn = _lib.fn("usm_flash_attention_bf16", [_lib.P] * 5 + [_lib.I] * 5 + [_lib.F, _lib.P])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            b * h, h, lq, lk, d, float(d**-0.5), _lib.stream_ptr(q))
    _lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
