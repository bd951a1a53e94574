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
version, both kernels and the JAX package, for any tiling. The seed is an
int or a 0-d integer tensor (the training step draws it on the device); the
kernels read it from device memory as the JAX kernels read their
``seed_ref`` operand, so a launch captured in a CUDA graph draws anew at
each replay, and no host value carries it.

On the H100 both kernels are bound by operations (forward 4·Lq·Lk·D flop,
backward 10·Lq·Lk·D, over the unmasked keys). ``csrc/flash_dropout.cu``
skips key tiles that are all masked when the batch has a valid key. Both
run on ``mma.sync`` with the accumulators in registers and the streamed
tiles in two cp.async stages. The forward's blocks take 128 queries and
split the key tiles too: tile t goes to split t mod S (``fwd_split_tiles``),
S from the shape alone (``fwd_splits``: one wave of the blocks an SM
holds), so the valid tiles of a memory bank fall evenly on the splits
wherever they lie; each split writes its O, running max and sum in f32 and
a second kernel combines them in split order into out and lse. The
backward runs dk/dv blocks over 64 keys and dq blocks over 64 queries in
one launch (blocks run in no order, so nothing is carried across them).
``bwd_splits`` also splits the queries of the dk/dv blocks and the keys of
the dq blocks, from the shape alone, to fill the card's 132 SMs and to keep
the dq blocks no longer than the dk/dv blocks; each split writes f32
partials that a third kernel sums in split order and rounds once. So both
passes give the same bits on every run. ``flash_dropout_fwd_split_plain``
and ``flash_dropout_bwd_split_plain`` are the plain models of the splits,
for the tests.

The forward is the operator ``usm_torch::flash_dropout_fwd``
(``torch.library.custom_op``, ``FLASH_RESID``), the counterpart of the JAX
package's remat form (``FLASH_RESID``, ``flash_attention_train_remat``):
the training step's rematerialisation (``training/train_model.py``) is a
selective checkpoint whose policy sees dispatcher operators, and it saves
this operator's (out, lse), so that the recompute in the backward pass
takes them and the forward kernel runs once a step. Its backward is the
backward kernel on the card; on the CPU the operator runs the plain forward
and its backward is autograd of the plain version, recomputed (the
gradient the plain version has always had here).
"""

from __future__ import annotations

import torch

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.flash_attention import split_ranges

SUPPORTED_D = (256,)
BLOCK = 64  # keys of a tile of either pass, or queries of a backward tile
FWD_BLOCK_Q = 128  # queries of a forward block (8 warps of 16)
TARGET_BLOCKS = 132  # the H100's SMs; one backward block fills an SM (up to 217 KB of shared memory)
# forward blocks an SM holds (205 KB of shared memory, 256 threads); chip_smoke.py
# holds this against cudaOccupancyMaxActiveBlocksPerMultiprocessor
FWD_BLOCKS_PER_SM = 1
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


def _seed_mix(seed, device=None):
    """seed · 0x9e3779b9 mod 2^32: an int for an int seed, else an int64
    tensor on ``device`` (the seed's own by default)."""
    if isinstance(seed, torch.Tensor):
        return (seed.to(device=device, dtype=torch.int64) * _GOLD) & _M32
    return (int(seed) * _GOLD) & _M32


def keep_from_index(idx: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Keep mask of the elements whose global index (bh·Lq + q)·Lk + k is
    ``idx`` (int64, wrapped to 32 bits here, as the int32 index wraps);
    ``seed`` an int or a 0-d integer tensor."""
    h = (idx & _M32) ^ _seed_mix(seed, idx.device)
    h = _mul32(h ^ (h >> 16), _M1)
    h = _mul32(h ^ (h >> 13), _M2)
    h = h ^ (h >> 16)
    return h >= keep_threshold(rate)


def keep_mask(bh: int, lq: int, lk: int, seed, rate: float, device="cpu") -> torch.Tensor:
    """[bh, lq, lk] bool keep mask (the JAX ``keep_mask_reference``)."""
    i = torch.arange(bh, device=device)[:, None, None]
    q = torch.arange(lq, device=device)[None, :, None]
    k = torch.arange(lk, device=device)[None, None, :]
    return keep_from_index((i * lq + q) * lk + k, seed, rate)


def flash_attention_train_plain(q, k, v, key_mask, seed, rate: float):
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


def fwd_splits(bh: int, lq: int, lk: int) -> int:
    """Key splits of the forward for B·H = ``bh``, from the shape alone: at
    most as many as let the (query tile, split, batch·head) blocks run in one
    wave (TARGET_BLOCKS x FWD_BLOCKS_PER_SM), at most one a key tile, and of
    those the fewest whose longest split is as short (more would only add
    partials for the combine to read)."""
    q_tiles, k_tiles = -(-lq // FWD_BLOCK_Q), -(-lk // BLOCK)
    most = max(1, min(k_tiles, TARGET_BLOCKS * FWD_BLOCKS_PER_SM // (bh * q_tiles)))
    return -(-k_tiles // -(-k_tiles // most))


def fwd_split_tiles(lk: int, splits: int) -> list[list[int]]:
    """The key tiles of each forward split: tile t to split t mod ``splits``.
    A memory bank's valid keys lie in runs of whole slots, so dealt out in
    turn its valid tiles fall on the splits within one of each other wherever
    the runs lie; the assignment is the same on every call."""
    return [list(range(s, -(-lk // BLOCK), splits)) for s in range(splits)]


def fwd_attended_keys(key_mask, b: int, lk: int, splits: int, device="cpu") -> torch.Tensor:
    """[splits, B, Lk] bool: the keys each split's blocks score — the keys of
    its tiles, less the tiles with no valid key where the batch has a valid
    key (a batch with none attends every tile)."""
    valid = torch.ones(b, lk, dtype=torch.bool, device=device) if key_mask is None else key_mask.to(device)
    k_tiles = -(-lk // BLOCK)
    tile_valid = torch.nn.functional.pad(valid, (0, k_tiles * BLOCK - lk)).reshape(b, k_tiles, BLOCK).any(-1)
    take = tile_valid | ~valid.any(-1, keepdim=True)
    split_of = torch.zeros(k_tiles, dtype=torch.long, device=device)
    for s, tiles in enumerate(fwd_split_tiles(lk, splits)):
        split_of[tiles] = s
    ours = split_of[None, None, :] == torch.arange(splits, device=device)[:, None, None]
    return (ours & take[None]).repeat_interleave(BLOCK, -1)[..., :lk]


def flash_dropout_fwd_split_partials(q, k, v, key_mask, seed, rate: float, splits: int):
    """Each forward split's O_i [splits, B, H, Lq, D] (f32, P·keep/(1 − rate)
    rounded to v's dtype as the kernel rounds it), running max m_i and
    undropped sum l_i [splits, B, H, Lq] in f32, natural-log units, over the
    keys ``fwd_attended_keys`` gives it. A split that attends no key has O 0,
    m −inf, l 0."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    keepf = torch.ones_like(s)
    if rate > 0.0:
        keep = keep_mask(b * h, lq, lk, seed, rate, q.device).reshape(b, h, lq, lk)
        keepf = torch.where(keep, torch.full_like(s, 1.0 / (1.0 - rate)), torch.zeros_like(s))
    os, ms, ls = [], [], []
    for att in fwd_attended_keys(key_mask, b, lk, splits, q.device):
        si = torch.where(att[:, None, None, :], s, torch.full_like(s, float("-inf")))
        m = si.amax(-1)
        p = torch.exp(si - torch.where(m == float("-inf"), torch.zeros_like(m), m)[..., None])
        os.append(torch.matmul((p * keepf).to(v.dtype).float(), v.float()))
        ms.append(m)
        ls.append(p.sum(-1))
    return torch.stack(os), torch.stack(ms), torch.stack(ls)


def combine_fwd_partials(o, m, l, dtype):
    """The forward's combine kernel: (out, lse) from the splits' (O_i, m_i,
    l_i), summed in split order: w_i = exp(m_i − max_i m_i), 0 for a split
    with m_i = −inf; out = Σ w_i O_i / max(Σ w_i l_i, 1e-30) in ``dtype``,
    lse = max_i m_i + log(max(Σ w_i l_i, 1e-30))."""
    top = m.amax(0)
    w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - top))
    total = sum_in_order(w * l).clamp_min(1e-30)
    return (sum_in_order(w[..., None] * o) / total[..., None]).to(dtype), top + torch.log(total)


def flash_dropout_fwd_split_plain(q, k, v, key_mask, seed, rate: float, splits: int):
    """Plain model of the forward kernels' split over key tiles and their
    combine (tests only): (out, lse [B, H, Lq] f32)."""
    return combine_fwd_partials(*flash_dropout_fwd_split_partials(q, k, v, key_mask, seed, rate, splits),
                                q.dtype)


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


def flash_dropout_bwd_split_partials(q, k, v, key_mask, seed, rate: float, out, lse, g,
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


def flash_dropout_bwd_split_plain(q, k, v, key_mask, seed, rate: float, out, lse, g,
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


def draw_seed(gen: torch.Generator | None, device) -> torch.Tensor:
    """One int32 dropout seed drawn from ``gen`` (``device``'s default
    generator when None), as a 0-d int32 tensor on ``device``: a device draw
    that a captured step repeats at each replay (JAX ``jax.random.bits`` to
    int32)."""
    dev = torch.device(device) if gen is None else gen.device
    return torch.randint(-(2**31), 2**31, (), generator=gen, device=dev, dtype=torch.int32).to(device)


def seed_operand(seed, device) -> torch.Tensor:
    """The kernels' seed operand: one int32 on ``device``. A 0-d int32
    tensor there is taken as it is (the training step's draw); an int is
    wrapped to int32 and written there by a fill (no copy from the host)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
            raise ValueError(f"dropout seed must be one int32 on {device}, got {seed.dtype} {tuple(seed.shape)} "
                             f"on {seed.device}")
        return seed.reshape(())
    return torch.full((), (int(seed) + 2**31) % 2**32 - 2**31, dtype=torch.int32, device=device)


def _hash_args(seed: torch.Tensor, rate: float, d: int):
    return (float(d**-0.5), seed.data_ptr(), keep_threshold(rate), float(1.0 / (1.0 - rate)))


def _fwd_scratch_floats(bh: int, lq: int, d: int, splits: int) -> int:
    """f32 scratch of the forward entry point: each split's O [splits, bh,
    lq, d], then its (m, l) [splits, bh, lq, 2]; none with one split."""
    return 0 if splits == 1 else splits * bh * lq * (d + 2)


def flash_dropout_fwd(q, k, v, key_mask, seed, rate: float):
    """Forward kernels: (out bf16, lse [B, H, Lq] f32). CUDA bf16 only; one
    count per call, whatever the number of kernels (the split blocks, and
    their combine where ``fwd_splits`` gives more than one). ``seed``: see
    ``seed_operand``."""
    global _fwd_fn
    key_mask = _check(q, k, v, key_mask, "flash_dropout_fwd")
    seed = seed_operand(seed, q.device)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    splits = fwd_splits(b * h, lq, lk)
    n = _fwd_scratch_floats(b * h, lq, d, splits)
    scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    if _fwd_fn is None:
        _fwd_fn = _lib.fn("usm_flash_dropout_fwd_bf16",
                          [_lib.P] * 7 + [_lib.I] * 6 + [_lib.F, _lib.P, _lib.U, _lib.F, _lib.P])
    rc = _fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if key_mask is None else key_mask.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), None if scratch is None else scratch.data_ptr(), b * h, h, lq,
                 lk, d, splits, *_hash_args(seed, rate, d), _lib.stream_ptr(q))
    _lib.check(rc, "flash_dropout_fwd")
    flash_dropout_fwd.launches += 1
    return out, lse


def fwd_blocks_per_sm() -> int:
    """How many forward blocks one SM of the card holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); needs the card."""
    import ctypes

    n = ctypes.c_int(0)
    fn = _lib.fn("usm_flash_dropout_fwd_blocks_per_sm", [ctypes.POINTER(ctypes.c_int)])
    _lib.check(fn(ctypes.byref(n)), "flash_dropout_fwd occupancy")
    return n.value


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


def flash_dropout_bwd(q, k, v, key_mask, seed, rate: float, out, lse, g):
    """Backward kernels: (dq, dk, dv) bf16 from the forward's (out, lse) and
    the output gradient g. CUDA bf16 only; one count per call, whatever the
    number of kernels (delta = Σ_d g·out per row; the dk/dv and dq blocks in
    one launch; a combine of the splits of each where ``bwd_splits`` gives
    more than one). ``seed``: see ``seed_operand``."""
    global _bwd_fn
    key_mask = _check(q, k, v, key_mask, "flash_dropout_bwd")
    seed = seed_operand(seed, q.device)
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
                          [_lib.P] * 11 + [_lib.I] * 7 + [_lib.F, _lib.P, _lib.U, _lib.F, _lib.P])
    rc = _bwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 None if key_mask is None else key_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), scratch.data_ptr(), b * h, h, lq, lk, d, q_splits, k_splits,
                 *_hash_args(seed, rate, d), _lib.stream_ptr(q))
    _lib.check(rc, "flash_dropout_bwd")
    flash_dropout_bwd.launches += 1
    return dq, dk, dv


_fwd_fn = _bwd_fn = None  # the C entry points, bound at their first launch
_lib.counted(flash_dropout_fwd)
_lib.counted(flash_dropout_bwd)


@torch.library.custom_op("usm_torch::flash_dropout_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor | None,
                  seed: torch.Tensor, rate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the plain version for CPU tensors, else the forward kernels."""
    if q.is_cpu:
        return flash_attention_train_plain(q, k, v, key_mask, seed, rate)
    return flash_dropout_fwd(q, k, v, key_mask, seed, rate)


# the operator whose outputs the training step's remat policy saves (JAX FLASH_RESID)
FLASH_RESID = torch.ops.usm_torch.flash_dropout_fwd.default


def _fwd_op_setup(ctx, inputs, output):
    q, k, v, key_mask, seed, rate = inputs
    ctx.save_for_backward(q, k, v, key_mask, seed, *output)
    ctx.rate = rate
    ctx.mark_non_differentiable(output[1])


def _fwd_op_backward(ctx, g, _g_lse):
    q, k, v, key_mask, seed, out, lse = ctx.saved_tensors
    if q.is_cpu:  # autograd of the plain version, recomputed
        need = ctx.needs_input_grad[:3]
        args = [x.detach().requires_grad_(n) for x, n in zip((q, k, v), need)]
        with torch.enable_grad():
            res = flash_attention_train_plain(*args, key_mask, seed, ctx.rate)[0]
        grads = iter(torch.autograd.grad(res, [a for a, n in zip(args, need) if n], g))
        dq, dk, dv = (next(grads) if n else None for n in need)
    else:
        dq, dk, dv = flash_dropout_bwd(q, k, v, key_mask, seed, ctx.rate, out, lse, g)
    return dq, dk, dv, None, None, None


_flash_fwd_op.register_autograd(_fwd_op_backward, setup_context=_fwd_op_setup)


def flash_attention_train(q, k, v, key_mask, seed, rate: float):
    """Attention with dropout ``rate`` after the softmax, keep mask from
    ``seed`` (an int32: a 0-d tensor on q's device, or an int), through the
    operator ``FLASH_RESID``. CPU tensors take the plain version (its
    gradient autograd's); a CUDA tensor launches the forward kernel, and the
    backward kernels in the backward pass (the seed tensor saved for them),
    or raises."""
    if q.is_cpu:
        seed = seed if isinstance(seed, torch.Tensor) else torch.tensor(seed, dtype=torch.int64)
        return _flash_fwd_op(q, k, v, key_mask, seed, float(rate))[0]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v, key_mask, "flash_dropout_fwd")  # before the dispatch: a tensor of another device raises here
    return _flash_fwd_op(q, k, v, key_mask, seed_operand(seed, q.device), float(rate))[0]
