"""Flash attention with attention-weight dropout (training) — kernels and plain version.

Replaces the TPU kernels of ``us_video_medsam2_tpu/kernels/flash_dropout.py``
(``flash_attention_train``: forward ``_fwd_kernel``, backward ``_bwd_kernel``),
the memory attention's attention in training. q [B, H, Lq, D], k/v
[B, H, Lk, D], key_mask [B, Lk] (True = attend). Dropout acts after the
softmax: p = softmax(q·kᵀ/√D) in f32, then p·keep/(1 - rate), then the product
with v in the value dtype with f32 accumulation.

The keep decision of element (bh, q, k) is the JAX package's murmur3 hash of
its global index (bh·Lq + q)·Lk + k mixed with an int32 seed, in wrapping
32-bit arithmetic with logical shifts (``keep_from_index``). The mask is
bit-identical to ``keep_mask_reference`` there, and the same in the plain
version, both kernels and the JAX package, for any tiling.

On the H100 both kernels are bound by operations (forward 4·Lq·Lk·D flop,
backward 10·Lq·Lk·D, over the unmasked keys). ``csrc/flash_dropout.cu``
skips key tiles that are all masked when the batch has a valid key. The
forward keeps its score, probability and keep tiles in shared memory and runs
its products on WMMA. The backward runs dk/dv blocks over 64 keys and dq
blocks over 64 queries in one launch (blocks run in no order, so nothing is
carried across them), on ``mma.sync`` with the accumulators in registers and
the streamed tiles in two cp.async stages. ``bwd_splits`` also splits the
queries of the dk/dv blocks and the keys of the dq blocks, from the shape
alone, to fill the card's 132 SMs and to keep the dq blocks no longer than
the dk/dv blocks; each split writes f32 partials that a third kernel sums in
split order and rounds once, so the gradients are the same on every run.
``flash_dropout_bwd_split_plain`` is the plain model of that split, for the
tests.

The JAX package's remat form (``FLASH_RESID``, ``_flash_apply``) exists
because ``jax.checkpoint`` re-runs a custom_vjp's forward to rebuild its
residuals. Here ``save_for_backward`` keeps (out, lse) from the one forward,
so nothing replaces it.
"""

from __future__ import annotations

import torch

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.flash_attention import split_ranges

SUPPORTED_D = (256,)
BLOCK = 64  # keys or queries per tile of the backward kernels
TARGET_BLOCKS = 132  # the H100's SMs; one backward block fills an SM (up to 217 KB of shared memory)
NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def keep_threshold(rate: float) -> int:
    """Unsigned 32-bit threshold: keep when hash >= it, P(keep) = 1 - rate."""
    return min(int(round(rate * 2.0**32)), 2**32 - 1)


def keep_from_index(idx: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Keep mask of the elements whose global index (bh·Lq + q)·Lk + k is
    ``idx`` (int64, wrapped to 32 bits here, as the int32 index wraps)."""
    h = (idx & _M32) ^ ((int(seed) * _GOLD) & _M32)
    h = _mul32(h ^ (h >> 16), _M1)
    h = _mul32(h ^ (h >> 13), _M2)
    h = h ^ (h >> 16)
    return h >= keep_threshold(rate)


def keep_mask(bh: int, lq: int, lk: int, seed: int, rate: float, device="cpu") -> torch.Tensor:
    """[bh, lq, lk] bool keep mask (the JAX ``keep_mask_reference``)."""
    i = torch.arange(bh, device=device)[:, None, None]
    q = torch.arange(lq, device=device)[None, :, None]
    k = torch.arange(lk, device=device)[None, None, :]
    return keep_from_index((i * lq + q) * lk + k, seed, rate)


def flash_attention_train_plain(q, k, v, key_mask, seed: int, rate: float):
    """Plain PyTorch version: (out, lse [B, H, Lq] f32)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, -1)
    p = torch.softmax(s, -1)
    if rate > 0.0:
        keep = keep_mask(b * h, lq, lk, seed, rate, q.device).reshape(b, h, lq, lk)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, lse


def bwd_splits(bh: int, lq: int, lk: int) -> tuple[int, int]:
    """(query splits of the dk/dv blocks, key splits of the dq blocks) for
    B·H = ``bh``, from the shape alone. The dk/dv blocks' query tiles are
    split until their grid alone fills TARGET_BLOCKS SMs (at least 1 split);
    the dq blocks' key tiles are cut into ranges no longer than one dk/dv
    block's walk, so no dq block outlasts the dk/dv blocks it shares the
    launch with. Split i takes tiles [i·tps, (i+1)·tps), tps = ceil(tiles /
    splits), so trailing splits may hold no row."""
    q_tiles, k_tiles = -(-lq // BLOCK), -(-lk // BLOCK)
    q_splits = max(1, min(q_tiles, TARGET_BLOCKS // (bh * k_tiles)))
    walk = -(-q_tiles // q_splits)
    return q_splits, -(-k_tiles // walk)


def flash_dropout_bwd_split_partials(q, k, v, key_mask, seed: int, rate: float, out, lse, g,
                                     q_splits: int, k_splits: int):
    """The backward kernels' f32 partials, unscaled: dq_i [k_splits, B, H, Lq,
    D] over each key range, dk_i and dv_i [q_splits, B, H, Lk, D] over each
    query range. P comes from lse (exp(min(s − lse, 0)), 0 on masked keys,
    1/Lk on a batch whose keys are all masked), P·keep/(1 − rate) and dS =
    P·(dP·keep/(1 − rate) − delta) are rounded to the value dtype before
    their products, as the kernels round them; a range with no row gives
    exact zeros."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    g = g.to(q.dtype)
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    p = torch.exp(torch.clamp(s - lse.float()[..., None], max=0.0))
    attend = torch.ones(b, lk, dtype=torch.bool, device=q.device) if key_mask is None else key_mask
    attend = attend[:, None, None, :]
    p = torch.where(attend, p, torch.zeros_like(p))
    p = torch.where(attend.any(-1, keepdim=True), p, torch.full_like(p, 1.0 / lk))
    keepf = torch.ones_like(p)
    if rate > 0.0:
        keep = keep_mask(b * h, lq, lk, seed, rate, q.device).reshape(b, h, lq, lk)
        keepf = torch.where(keep, keepf / (1.0 - rate), torch.zeros_like(keepf))
    pd = (p * keepf).to(v.dtype).float()
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = torch.where(attend, p * (dp * keepf - delta), torch.zeros_like(p)).to(q.dtype).float()
    qf, gf, kf = q.float(), g.float(), k.float()
    dq_i = [torch.matmul(ds[..., lo:hi], kf[:, :, lo:hi]) for lo, hi in split_ranges(lk, k_splits, BLOCK)]
    dk_i, dv_i = [], []
    for lo, hi in split_ranges(lq, q_splits, BLOCK):
        dk_i.append(torch.matmul(ds[:, :, lo:hi].transpose(-1, -2), qf[:, :, lo:hi]))
        dv_i.append(torch.matmul(pd[:, :, lo:hi].transpose(-1, -2), gf[:, :, lo:hi]))
    return torch.stack(dq_i), torch.stack(dk_i), torch.stack(dv_i)


def sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """parts[0] + parts[1] + ..., in that order (the combine kernel's order)."""
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc


def flash_dropout_bwd_split_plain(q, k, v, key_mask, seed: int, rate: float, out, lse, g,
                                  q_splits: int, k_splits: int):
    """Plain model of the backward kernels' split and combine (tests only):
    (dq, dk, dv) = (scale·Σ dq_i, scale·Σ dk_i, Σ dv_i), each sum in split
    order, rounded once to the input dtypes."""
    dq_i, dk_i, dv_i = flash_dropout_bwd_split_partials(q, k, v, key_mask, seed, rate, out, lse, g,
                                                        q_splits, k_splits)
    scale = q.shape[-1] ** -0.5
    return ((sum_in_order(dq_i) * scale).to(q.dtype), (sum_in_order(dk_i) * scale).to(k.dtype),
            sum_in_order(dv_i).to(v.dtype))


def _check(q, k, v, key_mask, name):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for tn, t, shape in (("q", q, (b, h, lq, d)), ("k", k, (b, h, lk, d)), ("v", v, (b, h, lk, d))):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"{name} kernel: {tn} must be contiguous, aligned bf16 CUDA {shape}")
    if d not in SUPPORTED_D:
        raise ValueError(f"{name} kernel: D={d} not in {SUPPORTED_D}")
    if key_mask is None:
        return None
    if key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, lk) or key_mask.device != q.device:
        raise ValueError(f"{name} kernel: key_mask must be bool [{b}, {lk}] on q's device")
    return key_mask.contiguous()


def _hash_args(seed: int, rate: float, d: int):
    return (float(d**-0.5), (int(seed) * _GOLD) & _M32, keep_threshold(rate),
            float(1.0 / (1.0 - rate)))


def flash_dropout_fwd(q, k, v, key_mask, seed: int, rate: float):
    """Forward kernel: (out bf16, lse [B, H, Lq] f32). CUDA bf16 only."""
    global _fwd_fn
    key_mask = _check(q, k, v, key_mask, "flash_dropout_fwd")
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if _fwd_fn is None:
        _fwd_fn = _lib.fn("usm_flash_dropout_fwd_bf16",
                          [_lib.P] * 6 + [_lib.I] * 5 + [_lib.F, _lib.U, _lib.U, _lib.F, _lib.P])
    rc = _fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b * h, h, lq, k.shape[2], d, *_hash_args(seed, rate, d),
                 _lib.stream_ptr(q))
    _lib.check(rc, "flash_dropout_fwd")
    flash_dropout_fwd.launches += 1
    return out, lse


def _bwd_scratch_floats(bh: int, lq: int, lk: int, d: int, q_splits: int, k_splits: int) -> int:
    """f32 scratch of the backward entry point: delta [bh, lq] (rounded up to
    64 floats), then the dq partials if k_splits > 1 and the dk and dv
    partials if q_splits > 1 (the layout ``csrc/flash_dropout.cu`` carves)."""
    n = -(-bh * lq // 64) * 64
    if k_splits > 1:
        n += k_splits * bh * lq * d
    if q_splits > 1:
        n += 2 * q_splits * bh * lk * d
    return n


def flash_dropout_bwd(q, k, v, key_mask, seed: int, rate: float, out, lse, g):
    """Backward kernels: (dq, dk, dv) bf16 from the forward's (out, lse) and
    the output gradient g. CUDA bf16 only; one count per call, whatever the
    number of kernels (delta = Σ_d g·out per row; the dk/dv and dq blocks in
    one launch; a combine of the splits of each where ``bwd_splits`` gives
    more than one)."""
    global _bwd_fn
    key_mask = _check(q, k, v, key_mask, "flash_dropout_bwd")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype), ("g", g, q.shape, g.dtype),
                                  ("lse", lse, (b, h, lq), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_dropout_bwd kernel: {name} must be {dtype} {tuple(shape)} on q's device")
    g = g.to(q.dtype).contiguous()
    out, lse = out.contiguous(), lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    q_splits, k_splits = bwd_splits(b * h, lq, lk)
    scratch = torch.empty(_bwd_scratch_floats(b * h, lq, lk, d, q_splits, k_splits), dtype=torch.float32,
                          device=q.device)
    if _bwd_fn is None:
        _bwd_fn = _lib.fn("usm_flash_dropout_bwd_bf16",
                          [_lib.P] * 11 + [_lib.I] * 7 + [_lib.F, _lib.U, _lib.U, _lib.F, _lib.P])
    rc = _bwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 None if key_mask is None else key_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), scratch.data_ptr(), b * h, h, lq, lk, d, q_splits, k_splits,
                 *_hash_args(seed, rate, d), _lib.stream_ptr(q))
    _lib.check(rc, "flash_dropout_bwd")
    flash_dropout_bwd.launches += 1
    return dq, dk, dv


_fwd_fn = _bwd_fn = None  # the C entry points, bound at their first launch
flash_dropout_fwd.launches = 0
flash_dropout_bwd.launches = 0


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, seed, rate):
        out, lse = flash_dropout_fwd(q, k, v, key_mask, seed, rate)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_dropout_bwd(q, k, v, key_mask, ctx.seed, ctx.rate, out, lse, g)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, key_mask, seed: int, rate: float):
    """Attention with dropout ``rate`` after the softmax, keep mask from
    ``seed`` (int32). CPU tensors take the plain version (autograd through
    it); a CUDA tensor launches the forward kernel, and the backward kernels
    in the backward pass, or raises."""
    if q.is_cpu:
        return flash_attention_train_plain(q, k, v, key_mask, seed, rate)[0]
    return _FlashTrain.apply(q.contiguous(), k.contiguous(), v.contiguous(), key_mask, int(seed),
                             float(rate))
