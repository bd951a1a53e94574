"""Flash attention with a per-key boolean mask — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/flash_attention.py``
(``flash_attention`` / ``flash_attention_masked``, body ``_flash_kernel``),
the memory-attention path behind ``ops/attention.py::sdpa``. q [B, H, Lq, D],
k/v [B, H, Lk, D], key_mask [B, Lk] (True = attend); masked keys contribute
exact zeros. bf16 operands, f32 scores, online softmax in f32, f32
accumulation, one rounding of the output.

On the H100 it is bound by operations at the memory-attention shapes
(4·Lq·Lk·D flop against 2·Lk·D·2 + 2·Lq·D·2 bytes: ~500 flop/byte at
Lq = 1024, D = 256). The CUDA kernel (``csrc/flash_attention.cu``) splits the
keys across blocks as well as the queries (flash-decoding): ``flash_splits``
picks, from the shape alone, enough key splits for the (query tile, split,
batch·head) grid to fill the card's 132 SMs. Each block keeps a 64-row query
tile in shared memory, streams 64-key K/V tiles through two cp.async stages,
runs S = Q·Kᵀ and O += P·V on ``mma.sync`` bf16 tensor cores with O, the
running max and the running sum in registers, and skips key tiles that are
wholly masked when the batch has a valid key (decided on the device). A
second kernel combines the splits' partial (O, m, l) with the weights
exp(m_i − m). ``flash_attention_split_plain`` is the plain model of that
split and combine, for the tests.
"""

from __future__ import annotations

import torch

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_D = (256,)
NEG_INF = -1e30
BLOCK_Q = 64  # query rows per block
BLOCK_K = 64  # keys per tile
TARGET_BLOCKS = 132  # the H100's SMs; one block fits an SM (165 KB of shared memory)


def flash_attention_plain(q, k, v, key_mask=None):
    """Plain PyTorch version (the JAX ``ops/attention.py::sdpa`` math)."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_splits(bh: int, lq: int, lk: int) -> int:
    """Key splits of the kernel for B·H = ``bh``: enough (query tile, split,
    batch·head) blocks to fill TARGET_BLOCKS SMs, at most one per key tile.
    Split i takes key tiles [i·tps, (i+1)·tps), tps = ceil(tiles / splits), so
    trailing splits may hold no key."""
    q_tiles = -(-lq // BLOCK_Q)
    k_tiles = -(-lk // BLOCK_K)
    return max(1, min(k_tiles, TARGET_BLOCKS // (bh * q_tiles)))


def split_ranges(lk: int, splits: int, block_k: int = BLOCK_K) -> list[tuple[int, int]]:
    """The [lo, hi) key range of each split (empty past Lk)."""
    tiles = -(-lk // block_k)
    per = -(-tiles // splits) * block_k
    return [(min(i * per, lk), min((i + 1) * per, lk)) for i in range(splits)]


def flash_attention_split_partials(q, k, v, key_mask=None, splits: int = 1, block_k: int = BLOCK_K):
    """Each split's unnormalised O_i [splits, B, H, Lq, D] (f32, P rounded to
    v's dtype as the kernel rounds it), running max m_i and sum l_i [splits,
    B, H, Lq] in f32, natural-log units. A split with no key has O 0, m −inf, l 0."""
    b, h, lq, d = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    os, ms, ls = [], [], []
    for lo, hi in split_ranges(k.shape[2], splits, block_k):
        if lo == hi:
            os.append(s.new_zeros(b, h, lq, d))
            ms.append(s.new_full((b, h, lq), float("-inf")))
            ls.append(s.new_zeros(b, h, lq))
            continue
        si = s[..., lo:hi]
        m = si.amax(-1)
        p = torch.exp(si - m[..., None])
        os.append(torch.matmul(p.to(v.dtype).float(), v[:, :, lo:hi].float()))
        ms.append(m)
        ls.append(p.sum(-1))
    return torch.stack(os), torch.stack(ms), torch.stack(ls)


def flash_attention_split_plain(q, k, v, key_mask=None, splits: int = 1, block_k: int = BLOCK_K):
    """Plain model of the kernel's split over keys and its combine (tests
    only): out = Σ w_i O_i / max(Σ w_i l_i, 1e-30), w_i = exp(m_i − max_i m_i),
    0 for a split with no key."""
    o, m, l = flash_attention_split_partials(q, k, v, key_mask, splits, block_k)
    w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - m.amax(0)))
    return ((w[..., None] * o).sum(0) / (w * l).sum(0).clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_attention(q, k, v, key_mask=None):
    """softmax(q·kᵀ/√D, masked)·v. CPU tensors take the plain version; a CUDA
    tensor launches the kernel (bf16, D in SUPPORTED_D) or raises. The
    gradient is the plain version's, recomputed in the backward pass."""
    if q.is_cpu:
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
    splits = flash_splits(b * h, lq, lk)
    o_part = ml_part = None
    if splits > 1:
        o_part = torch.empty((splits, b * h, lq, d), dtype=torch.float32, device=q.device)
        ml_part = torch.empty((splits, b * h, lq, 2), dtype=torch.float32, device=q.device)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_flash_attention_bf16", [_lib.P] * 7 + [_lib.I] * 6 + [_lib.F, _lib.P])
    rc = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
             None if o_part is None else o_part.data_ptr(), None if ml_part is None else ml_part.data_ptr(),
             b * h, h, lq, lk, d, splits, float(d**-0.5), _lib.stream_ptr(q))
    _lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


_lib.counted(flash_attention)
_fn = None  # usm_flash_attention_bf16, bound at the first launch
