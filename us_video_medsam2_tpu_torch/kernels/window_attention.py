"""Windowed multi-head attention on the dense qkv layout — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_window_attention.py``
(``fused_window_attention``, body ``_kernel``). Input is the qkv projection in
the layout the Linear writes it, [B, Hp, Wp, 3·nh·hd] (Hp, Wp multiples of the
window ws); output is [B, Hpo, Wpo, nh·hd] in the spatial layout the output
projection reads. Per (window, head): q optionally 2x2 max-pooled inside the
window, S = q·kᵀ·hd^-½ in f32, row softmax in f32, P normalised and rounded to
the input dtype, O = P·v accumulated in f32 and rounded once. With ``real_h``,
the unpadded map height, the query rows of the last window strip that lie in
the map's bottom padding are cut, as in the JAX kernel: they come back as
exact zeros (the caller slices them off), and every other row is the same as
without the cut.

On the H100 it is bound by bytes: qkv read once and o written once, against
~2·Lk·hd operations a byte, far below the card's ~295. At batch 1 the work is
small and latency-bound, so the CUDA kernel (``csrc/window_attention.cu``,
with the per-warp slab attention in ``csrc/window_attn_core.cuh``) spreads it
over the card: one warp per 16-row query slab with the scores, softmax and P
in ``mma.sync`` registers (the whole key row of a window fits, so the softmax
is exact), and a grid from ``window_tiles``: a window-head's slabs shared out
over several blocks, as many warps a block as let the grid run in one wave
of the blocks an SM holds. K and V are gathered straight from the dense layout
into shared memory with cp.async, so the window partition and unpartition
never touch device memory. The cut rows are neither read nor computed.
hd 96 (Hiera-tiny) and hd 64 (the ViTDet trunks' ws-14 blocks) are
instantiations of the kernel; any other head dim raises on the card.
"""

from __future__ import annotations

import functools

import torch

from us_video_medsam2_tpu_torch.kernels import _lib

SUPPORTED_HD = (64, 96)
MAX_WS = 14
MAX_WARPS = 8
SMS = _lib.SMS
# What the kernel's occupancy depends on, for window_tiles' wave rule (chip_smoke.py
# holds _lib.blocks_per_sm against cudaOccupancyMaxActiveBlocksPerMultiprocessor at
# every grid window_tiles picks): registers a thread of each (hd, key tiles)
# instantiation, from nvcc -Xptxas -v on sm_90a.
REGISTERS = {(96, 13): 231, (96, 4): 128, (96, 1): 128, (64, 13): 221, (64, 4): 93, (64, 1): 80}
SMEM_PER_BLOCK = _lib.SMEM_PER_BLOCK
WARP_CHOICES = (1, 2, 4, 8)


def key_tiles(ws: int) -> int:
    """16-key tiles of the instantiation that holds a ws x ws window (its keys pad to 16, 64 or 208)."""
    return 1 if ws <= 4 else 4 if ws <= 8 else 13


def _last_strip_q_rows(hp: int, ws: int, q_pool: bool, real_h: int | None) -> int:
    """Real input rows of the last window strip of a bottom-padded map, or 0
    when no cut applies: the map is unpadded, or the count is odd under
    q-pooling (a pooled row would mix a real and a pad row). A copy of the JAX
    kernel's helper without its raster-path condition, which belongs to the
    TPU's lane packing: here the cut applies at every window size."""
    if real_h is None or real_h >= hp:
        return 0
    rr = real_h - (hp // ws - 1) * ws
    if rr <= 0 or rr >= ws or (q_pool and rr % 2):
        return 0
    return rr


def cut_query_rows(hp: int, ws: int, q_pool: bool, real_h: int | None) -> int:
    """Real query rows (in the window's row-major order) of each last-strip
    window, or 0 when no cut applies: the kernel's ``q_lq``."""
    rr = _last_strip_q_rows(hp, ws, q_pool, real_h)
    wso = ws // 2 if q_pool else ws
    return (rr // 2 if q_pool else rr) * wso


def window_attention_plain(qkv: torch.Tensor, ws: int, nh: int, q_pool: bool,
                           real_h: int | None = None) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``_xla_ref``), every row computed; with
    ``real_h`` the cut rows are then set to zero, as the kernel leaves them."""
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
    o = o.reshape(b, nwh * wso, nww * wso, nh * hd)
    q_lq = cut_query_rows(hp, ws, q_pool, real_h)
    if q_lq:
        o = o.clone()
        o[:, (nwh - 1) * wso + q_lq // wso:] = 0
    return o


def grid(b: int, hp: int, wp: int, ws: int, nh: int, q_pool: bool, q_lq: int, warps: int) -> list[dict]:
    """The kernel's two grid regions as it computes them (``Geo`` in
    csrc/window_attention.cu): window-heads, slabs of each, parts a
    window-head's slabs are shared over, blocks."""
    wso = ws // 2 if q_pool else ws
    nwh, nww = hp // ws, wp // ws
    lq = wso * wso
    regions = []
    for n_wh, slabs in ((b * (nwh - (1 if q_lq else 0)) * nww * nh, -(-lq // 16)),
                        (b * nww * nh if q_lq else 0, -(-q_lq // 16))):
        parts = -(-slabs // warps) if slabs else 1
        regions.append({"n_wh": n_wh, "slabs": slabs, "parts": parts, "blocks": n_wh * parts})
    return regions


def tile_tasks(b: int, hp: int, wp: int, ws: int, nh: int, q_pool: bool, q_lq: int, warps: int):
    """Yield (block, warp, (batch, window row, window column, head), slab) for
    every warp of the grid that computes a slab, by the kernel's own index
    arithmetic."""
    nwh, nww = hp // ws, wp // ws
    first = 0
    for r, reg in enumerate(grid(b, hp, wp, ws, nh, q_pool, q_lq, warps)):
        rows, wy0 = (1, nwh - 1) if r else (nwh - (1 if q_lq else 0), 0)
        for local in range(reg["blocks"]):
            i, part = divmod(local, reg["parts"])
            lo = part * reg["slabs"] // reg["parts"]
            hi = (part + 1) * reg["slabs"] // reg["parts"]
            i, head = divmod(i, nh)
            i, wx = divmod(i, nww)
            bi, wy = divmod(i, rows)
            for warp in range(min(warps, hi - lo)):
                yield first + local, warp, (bi, wy0 + wy, wx, head), lo + warp
        first += reg["blocks"]


def smem_bytes(hd: int, ws: int, warps: int) -> int:
    """Dynamic shared memory of a block: the window-head's K and V, one q slab a warp."""
    return 2 * (hd + 8) * (2 * 16 * key_tiles(ws) + warps * 16)


def blocks_per_sm(hd: int, ws: int, warps: int) -> int:
    """How many blocks of the kernel one SM holds (``_lib.blocks_per_sm`` of
    its ``REGISTERS``, shared memory and threads)."""
    return _lib.blocks_per_sm(REGISTERS[(hd, key_tiles(ws))], smem_bytes(hd, ws, warps), 32 * warps)


@functools.lru_cache(maxsize=None)  # ~30 us of Python a call otherwise, on every launch
def window_tiles(b: int, hp: int, wp: int, ws: int, nh: int, hd: int, q_pool: bool,
                 real_h: int | None = None) -> int:
    """The kernel's warps a block for this call, from the shape alone. A
    block holds one window-head, whose query slabs are shared out over
    ceil(slabs / warps) blocks. The rule: the most warps a block in
    ``WARP_CHOICES`` whose grid runs in one wave (SMS x ``blocks_per_sm``
    blocks at once); where none does, the fewest waves, the most warps on a
    tie. A block stages its window-head's K and V with all its threads, so
    more warps a block means fewer copies of K and V and a faster copy, as
    long as no block waits for a second wave."""
    q_lq = cut_query_rows(hp, ws, q_pool, real_h)
    best = None
    for w in WARP_CHOICES:
        if smem_bytes(hd, ws, w) > SMEM_PER_BLOCK:
            continue
        cap = SMS * blocks_per_sm(hd, ws, w)
        if not cap:
            continue
        blocks = sum(r["blocks"] for r in grid(b, hp, wp, ws, nh, q_pool, q_lq, w))
        key = (-(-blocks // cap), -w)
        if best is None or key < best[0]:
            best = (key, w)
    if best is None:
        raise ValueError(f"window_attention: no grid fits hd {hd} ws {ws}")
    return best[1]


def window_attention(qkv: torch.Tensor, ws: int, nh: int, q_pool: bool,
                     real_h: int | None = None) -> torch.Tensor:
    """[B, Hp, Wp, 3·nh·hd] -> [B, Hpo, Wpo, nh·hd]; ``real_h``: the map's
    height before padding to whole windows (rows of the last strip past it
    are cut). CPU tensors take the plain version; a CUDA tensor launches the
    kernel (bf16) or raises. The gradient is the plain version's, recomputed
    in the backward pass: the caller crops the cut rows, so their incoming
    gradient is zero and the uncut function's gradient is exact (the JAX
    ``_bwd``'s argument)."""
    if qkv.is_cpu:
        return window_attention_plain(qkv, ws, nh, q_pool, real_h)
    return _lib.with_plain_grad(_kernel, window_attention_plain, qkv, ws, nh, q_pool, real_h)


def _kernel(qkv, ws, nh, q_pool, real_h=None, warps: int | None = None):
    """The launch; ``warps`` overrides ``window_tiles`` (for measurements)."""
    if (qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or qkv.data_ptr() % 16):
        raise ValueError("window_attention kernel takes contiguous, 16-byte aligned bf16 CUDA qkv")
    b, hp, wp, c = qkv.shape
    hd = c // (3 * nh)
    if 3 * nh * hd != c or hd not in SUPPORTED_HD:
        raise ValueError(f"window_attention kernel: channels {c} != 3*{nh}*hd with hd in {SUPPORTED_HD}")
    if not 0 < ws <= MAX_WS or hp % ws or wp % ws or (q_pool and ws % 2):
        raise ValueError(f"window_attention kernel: ws={ws} must divide {hp}x{wp}, <= {MAX_WS}")
    warps = warps or window_tiles(b, hp, wp, ws, nh, hd, q_pool, real_h)
    if not 0 < warps <= MAX_WARPS:
        raise ValueError(f"window_attention kernel: {warps} warps a block, not 1-{MAX_WARPS}")
    wso = ws // 2 if q_pool else ws
    out = torch.empty((b, hp // ws * wso, wp // ws * wso, nh * hd), dtype=qkv.dtype, device=qkv.device)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_window_attention_bf16", [_lib.P, _lib.P] + [_lib.I] * 9 + [_lib.F, _lib.P])
    rc = _fn(qkv.data_ptr(), out.data_ptr(), b, hp, wp, ws, nh, hd, int(q_pool),
             cut_query_rows(hp, ws, q_pool, real_h), warps, float(hd**-0.5), _lib.stream_ptr(qkv))
    _lib.check(rc, "window_attention")
    window_attention.launches += 1
    return out


def card_blocks_per_sm(hd: int, ws: int, warps: int) -> int:
    """How many blocks of the kernel one SM of the card holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); needs the card."""
    import ctypes

    n = ctypes.c_int(0)
    fn = _lib.fn("usm_window_attention_blocks_per_sm", [_lib.I] * 3 + [ctypes.POINTER(ctypes.c_int)])
    _lib.check(fn(hd, ws, warps, ctypes.byref(n)), "window_attention occupancy")
    return n.value


_lib.counted(window_attention)
_fn = None  # usm_window_attention_bf16, bound at the first launch
