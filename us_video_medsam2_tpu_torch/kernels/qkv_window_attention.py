"""qkv projection and windowed multi-head attention in one pass — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/fused_window_attention.py``
(``fused_qkv_window_attention``, body ``_kernel_qkv``). Input is the
post-norm1 token map, zero-padded to whole windows, [B, Hp, Wp, Cin], with the
qkv Linear's weight [3·nh·hd, Cin] and f32 bias; output is [B, Hpo, Wpo,
nh·hd], as ``window_attention`` gives it. The projection accumulates in f32,
adds the f32 bias and rounds once (so pad tokens carry exactly the bias, and
are attended); the attention is ``window_attention``'s: q optionally 2x2
max-pooled inside the window, f32 scores and softmax, P rounded, f32 P·V
rounded once. Every output row is computed (no last-strip cut).

On the H100 it is bound by operations, the projection's 2·Hp·Wp·Cin·3·nh·hd
flop; at B 1 the work is small, and what a call costs is the chain of one
block. The CUDA kernel (``csrc/qkv_window_attention.cu``) cuts the work into
block tiles of (a group of G windows, one head, one rank of a cluster of C
blocks), so the qkv map never reaches device memory: each block projects K
and V for its rank's share of the group's 16-row token tiles and q for its
share of the query slabs (``mma.sync`` products fed by a ``cp.async`` ring
of 32-wide Cin chunks, token rows gathered from the map by address), the
ranks of a cluster swap their K and V shares through distributed shared
memory, and every warp runs ``window_attention``'s slab core on one 16-row
query slab at a time (8 warps a block). ``plan_for`` picks (G, C) from the
shape alone: G > 1 reads each head's weight rows once per G small windows;
C > 1 spreads a large window-head over C SMs. ``plan_blocks`` walks the grid by the
kernel's own index arithmetic, and ``qkv_window_attention_split_plain``
computes the function as a plan cuts it up (for the tests). hd is 64 or 96,
as for ``window_attention``; Cin a multiple of 32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.window_attention import (
    MAX_WS,
    SUPPORTED_HD,
    key_tiles,
    window_attention_plain,
)

CIN_CHUNK = 32  # Cin columns of one stage of the kernel's cp.async ring
STAGES = 3
TILES_A_WARP = 2  # 16-row tiles a warp projects in one pass
MAX_CLUSTER = 8  # the portable cluster size
MAX_GROUP = 8
G_CHOICES = (1, 2, 4, MAX_GROUP)
C_CHOICES = tuple(range(1, MAX_CLUSTER + 1))
WARPS = 8  # warps a block
MAX_GROUP_TILES = 8  # token tiles of a group of G > 1 windows: an M dimension of at most 128 rows
# What the plan's occupancy depends on (chip_smoke.py holds both against the
# card at every plan plan_for picks): registers a thread of each (hd, key
# tiles) instantiation, from nvcc -Xptxas -v on sm_90a, and the clusters of C
# blocks the card runs at once (``_lib.CLUSTERS_AT_ONCE``). At 8 warps and
# these registers an SM holds one block.
REGISTERS = {(96, 13): 254, (96, 4): 244, (96, 1): 244, (64, 13): 254, (64, 4): 166, (64, 1): 167}
# The plan's model of a block's time, in flop: ROUND_FLOPS for its fixed chain
# (launch, pipeline fill, barriers, the slab core's latency), its products,
# and FLOPS_PER_BYTE a byte it reads from L2. Chosen against every plan's
# device time that tools/torch_qkv_window_ab.py --plan prints (H100 80GB HBM3,
# 700 W): at each t512 and S geometry, B 1 and 4, plan_for's pick is within 9%
# of the fastest plan.
FLOPS_PER_BYTE = 64
ROUND_FLOPS = 20_000_000


class Plan(NamedTuple):
    g: int  # windows a group (a block tile's windows)
    c: int  # blocks a cluster (ranks sharing a group-head)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Window(NamedTuple):
    kt: int  # 16-row key tiles of the instantiation
    lk: int  # keys (tokens) of a window
    wso: int  # pooled window side
    lq: int  # queries of a window
    slabs: int  # 16-row query slabs of a window
    qtiles: int  # 16-row q token tiles of a window (4 tokens a query under pooling)


def _window(ws: int, q_pool: bool) -> _Window:
    wso = ws // 2 if q_pool else ws
    lq = wso * wso
    return _Window(key_tiles(ws), ws * ws, wso, lq, cdiv(lq, 16), cdiv((4 if q_pool else 1) * lq, 16))


def _shares(win: _Window, gw: int, c: int, rank: int, q_pool: bool):
    """A rank's share of a group of gw windows, as the kernel splits it:
    token tiles [lo, hi) (tile t: rows 16 t of the group's K and V), slabs
    (group slab g·slabs + s), q token tiles (group tile g·qtiles + i)."""
    tiles, slabs = gw * win.kt, gw * win.slabs
    p = 4 if q_pool else 1

    def qt_start(gs):
        return gs // win.slabs * win.qtiles + min(p * (gs % win.slabs), win.qtiles)

    s_lo, s_hi = rank * slabs // c, (rank + 1) * slabs // c
    return ((rank * tiles // c, (rank + 1) * tiles // c), (s_lo, s_hi), (qt_start(s_lo), qt_start(s_hi)))


def plan_blocks(b: int, hp: int, wp: int, ws: int, nh: int, q_pool: bool, plan: Plan):
    """Yield a dict for every block of the kernel's grid in launch order, by
    its own index arithmetic: block, task (group x head), rank, head, windows
    [(batch, window row, window column)], and the rank's token tiles,
    slabs and q token tiles as [lo, hi) ranges of the group's."""
    win = _window(ws, q_pool)
    nww = wp // ws
    nwin = hp // ws * nww
    n_win = b * nwin
    for task in range(cdiv(n_win, plan.g) * nh):
        head, w0 = task % nh, task // nh * plan.g
        gw = min(plan.g, n_win - w0)
        windows = [((w0 + g) // nwin, (w0 + g) % nwin // nww, (w0 + g) % nwin % nww) for g in range(gw)]
        for rank in range(plan.c):
            tiles, slabs, qtiles = _shares(win, gw, plan.c, rank, q_pool)
            yield {"block": task * plan.c + rank, "task": task, "rank": rank, "head": head, "windows": windows,
                   "tiles": tiles, "slabs": slabs, "qtiles": qtiles}


def smem_bytes(hd: int, ws: int, q_pool: bool, plan: Plan) -> int:
    """Dynamic shared memory of a block (``Smem`` in the CUDA source): the
    head's f32 bias and the token address tables, the group's K and V, the
    rank's q slabs, then the ring's STAGES stages, each
    with room for the most token rows a pass of the plan copies and its
    weight rows."""
    win = _window(ws, q_pool)
    ld = hd + 8
    slabs = cdiv(plan.g * win.slabs, plan.c)  # the most slabs a rank takes
    tables = -(-(4 * 3 * hd + 8 * MAX_GROUP + 2 * 4 * win.kt * 16) // 128) * 128
    ring = -(-(tables + 2 * 2 * plan.g * win.kt * 16 * ld + 2 * slabs * 16 * ld) // 128) * 128
    a_kv = min(WARPS * TILES_A_WARP // 2, cdiv(plan.g * win.kt, plan.c)) * 16
    a_q = min(WARPS * TILES_A_WARP, slabs * (4 if q_pool else 1)) * 16
    return ring + 2 * STAGES * max(a_kv + 2 * hd, a_q + hd) * (CIN_CHUNK + 8)


def blocks_per_sm(hd: int, ws: int, q_pool: bool, plan: Plan) -> int:
    """Blocks of the plan's kernel one SM holds (``_lib.blocks_per_sm``)."""
    return _lib.blocks_per_sm(REGISTERS[(hd, key_tiles(ws))], smem_bytes(hd, ws, q_pool, plan), 32 * WARPS)


def clusters_at_once(hd: int, ws: int, q_pool: bool, plan: Plan) -> int | None:
    """Clusters of the plan the card runs at once, or None where the table
    does not say (a plan the kernel takes but ``plan_for`` does not weigh)."""
    per_sm = blocks_per_sm(hd, ws, q_pool, plan)
    if per_sm == 0:
        return None
    return _lib.SMS * per_sm if plan.c == 1 else _lib.CLUSTERS_AT_ONCE.get((plan.c, per_sm))


def _rank_work(win: _Window, hd: int, cin: int, q_pool: bool, plan: Plan, rank: int) -> tuple[int, int]:
    """(the plan's model of one block's time in flop, its bytes read from L2)
    for a rank of a full group."""
    (t_lo, t_hi), (s_lo, s_hi), (q_lo, q_hi) = _shares(win, plan.g, plan.c, rank, q_pool)
    kv, qt, sl = t_hi - t_lo, q_hi - q_lo, s_hi - s_lo
    flops = 2 * 16 * cin * hd * (2 * kv + qt) + 4 * 16 * win.kt * 16 * hd * sl
    passes_kv = cdiv(kv, WARPS * TILES_A_WARP // 2)
    passes_q = cdiv(qt, WARPS * TILES_A_WARP)
    nbytes = 2 * cin * 16 * (kv + qt) + 2 * cin * hd * (2 * passes_kv + passes_q)
    if plan.c > 1:  # the peers' K and V shares, from their shared memory
        nbytes += 2 * 2 * 16 * hd * (plan.g * win.kt - kv)
    return flops + FLOPS_PER_BYTE * nbytes, nbytes


def plan_cost(b: int, hp: int, wp: int, ws: int, nh: int, hd: int, q_pool: bool, cin: int,
              plan: Plan) -> tuple[int, int] | None:
    """(modelled time, bytes the grid reads) of a plan, or None where it does
    not run (shared memory) or the occupancy table has no entry. Modelled
    time: rounds x the largest block's time (ROUND_FLOPS plus
    ``_rank_work``), where rounds is the waves of clusters
    (``clusters_at_once``) or, where more blocks than SMs run at once, the
    blocks an SM runs in turn."""
    if smem_bytes(hd, ws, q_pool, plan) > _lib.SMEM_PER_BLOCK:
        return None
    at_once = clusters_at_once(hd, ws, q_pool, plan)
    if not at_once:
        return None
    win = _window(ws, q_pool)
    tasks = cdiv(b * (hp // ws) * (wp // ws), plan.g) * nh
    rounds = max(cdiv(tasks, at_once), cdiv(tasks * plan.c, _lib.SMS))
    work = [_rank_work(win, hd, cin, q_pool, plan, r) for r in range(plan.c)]
    return rounds * (ROUND_FLOPS + max(w[0] for w in work)), tasks * sum(w[1] for w in work)


def candidates(ws: int, q_pool: bool):
    """The plans ``plan_for`` weighs: G > 1 (at most MAX_GROUP_TILES token
    tiles a group) with C 1, or G 1 with C up to the window's key tiles (a
    rank with no tile would only copy)."""
    kt = key_tiles(ws)
    for g in G_CHOICES:
        for c in C_CHOICES:
            if (g > 1 and (c > 1 or g * kt > MAX_GROUP_TILES)) or c > g * kt:
                continue
            yield Plan(g, c)


@functools.lru_cache(maxsize=None)  # Python on every launch otherwise
def plan_for(b: int, hp: int, wp: int, ws: int, nh: int, hd: int, q_pool: bool, cin: int) -> Plan:
    """The kernel's (G, C) for this call, from the shape alone: the least
    modelled time (``plan_cost``: rounds of clusters x the largest block's
    products and L2 bytes), then the fewest bytes read. A time, not the
    fewest waves alone: one wave of a plan whose blocks each project a
    whole ws-14 window-head is a longer wave."""
    best = None
    for p in candidates(ws, q_pool):
        cost = plan_cost(b, hp, wp, ws, nh, hd, q_pool, cin, p)
        if cost is None:
            continue
        key = (cost[0], cost[1], p.g, p.c)
        if best is None or key < best[0]:
            best = (key, p)
    if best is None:
        raise ValueError(f"qkv_window_attention: no plan fits hd {hd} ws {ws}")
    return best[1]


def qkv_window_attention_plain(y, w, b, ws: int, nh: int, q_pool: bool) -> torch.Tensor:
    """Plain PyTorch version (the JAX ``_xla_ref_qkv``): the projection in f32
    on the rounded operands plus the f32 bias, rounded to y's dtype, then
    ``window_attention_plain``."""
    qkv = F.linear(y.float(), w.to(y.dtype).float(), b.float()).to(y.dtype)
    return window_attention_plain(qkv, ws, nh, q_pool)


def qkv_window_attention_split_plain(y, w, b, ws: int, nh: int, q_pool: bool, plan: Plan,
                                     drop_rank: int | None = None) -> torch.Tensor:
    """The plain version computed as ``plan`` cuts it up (``plan_blocks``):
    each rank projects K and V of its token tiles (key rows past ws² zero)
    and q of its slabs (under pooling the 2x2 max of the four rounded token
    q); the group's K and V are the ranks' shares put together, and each slab
    attends its window. The same rounding points as the plain version.
    ``drop_rank`` zeroes that rank's K and V share (a check's self-test)."""
    bsz, hp, wp, cin = y.shape
    hd = w.shape[0] // (3 * nh)
    win = _window(ws, q_pool)
    rows = win.kt * 16
    nwh, nww = hp // ws, wp // ws
    dt = y.dtype
    wf, bf = w.to(dt).float(), b.float()
    tok = y.reshape(bsz, nwh, ws, nww, ws, cin).permute(0, 1, 3, 2, 4, 5).reshape(bsz, nwh, nww, ws * ws, cin)
    tok = F.pad(tok, (0, 0, 0, rows - ws * ws))  # key rows past ws² (not tokens) project to zero below
    out = torch.zeros(bsz, nwh * win.wso, nww * win.wso, nh * hd, dtype=dt, device=y.device)
    key_ok = (torch.arange(rows, device=y.device) < win.lk)[:, None]

    def proj(x, which, head):
        r = slice((which * nh + head) * hd, (which * nh + head + 1) * hd)
        return F.linear(x.float(), wf[r], bf[r]).to(dt)

    blocks = list(plan_blocks(bsz, hp, wp, ws, nh, q_pool, plan))
    for i in range(0, len(blocks), plan.c):
        cluster = blocks[i:i + plan.c]
        head, windows = cluster[0]["head"], cluster[0]["windows"]
        x = torch.stack([tok[bi, wy, wx] for bi, wy, wx in windows]).reshape(-1, cin)
        k = torch.zeros(x.shape[0], hd, dtype=dt, device=y.device)
        v = torch.zeros_like(k)
        ok = key_ok.repeat(len(windows), 1)
        for blk in cluster:
            lo, hi = (16 * t for t in blk["tiles"])
            if blk["rank"] != drop_rank:
                k[lo:hi] = torch.where(ok[lo:hi], proj(x[lo:hi], 1, head), 0)
                v[lo:hi] = torch.where(ok[lo:hi], proj(x[lo:hi], 2, head), 0)
        for blk in cluster:
            for gs in range(*blk["slabs"]):
                g, s = divmod(gs, win.slabs)
                bi, wy, wx = windows[g]
                qi = torch.arange(16 * s, min(16 * s + 16, win.lq), device=y.device)
                if q_pool:
                    t = [(2 * (qi // win.wso) + d // 2) * ws + 2 * (qi % win.wso) + d % 2 for d in range(4)]
                    q = torch.stack([proj(tok[bi, wy, wx, ti], 0, head) for ti in t]).amax(0)
                else:
                    q = proj(tok[bi, wy, wx, qi], 0, head)
                kw, vw = k[g * rows:g * rows + win.lk], v[g * rows:g * rows + win.lk]
                sc = torch.matmul(q.float(), kw.float().t()) * (hd**-0.5)
                p = torch.exp(sc - sc.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True)
                o = torch.matmul(p.to(dt).float(), vw.float()).to(dt)
                out[bi, wy * win.wso + qi // win.wso, wx * win.wso + qi % win.wso, head * hd:(head + 1) * hd] = o
    return out


def qkv_window_attention(y, w, b, ws: int, nh: int, q_pool: bool) -> torch.Tensor:
    """[B, Hp, Wp, Cin] -> [B, Hpo, Wpo, nh·hd]. CPU tensors take the plain
    version; a CUDA tensor launches the kernel (bf16 y and w, f32 b) or
    raises. The gradient is the plain version's, recomputed in the backward
    pass (cast w at use to keep f32 master weights)."""
    if y.is_cpu:
        return qkv_window_attention_plain(y, w, b, ws, nh, q_pool)
    return _lib.with_plain_grad(_kernel, qkv_window_attention_plain, y, w, b, ws, nh, q_pool)


def _kernel(y, w, b, ws, nh, q_pool, plan: Plan | None = None):
    """The launch; ``plan`` overrides ``plan_for`` (for measurements)."""
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
    p = plan or plan_for(bsz, hp, wp, ws, nh, hd, bool(q_pool), cin)
    wso = ws // 2 if q_pool else ws
    out = torch.empty((bsz, hp // ws * wso, wp // ws * wso, nh * hd), dtype=y.dtype, device=y.device)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_qkv_window_attention_bf16", [_lib.P] * 4 + [_lib.I] * 10 + [_lib.F, _lib.P])
    rc = _fn(y.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, hp, wp, cin, ws, nh, hd,
             int(q_pool), p.g, p.c, float(hd**-0.5), _lib.stream_ptr(y))
    _lib.check(rc, "qkv_window_attention")
    qkv_window_attention.launches += 1
    return out


def card_occupancy(hd: int, ws: int, q_pool: bool, plan: Plan) -> tuple[int, int, int]:
    """(shared-memory bytes of a block, blocks an SM holds, clusters the card
    runs at once) of the plan's kernel, as the card's occupancy API gives
    them; needs the card."""
    n = [ctypes.c_int(0) for _ in range(3)]
    fn = _lib.fn("usm_qkv_window_attention_occupancy", [_lib.I] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3)
    _lib.check(fn(hd, ws, int(q_pool), plan.g, plan.c, *map(ctypes.byref, n)),
               "qkv_window_attention occupancy")
    return n[0].value, n[1].value, n[2].value


_lib.counted(qkv_window_attention)
_fn = None  # usm_qkv_window_attention_bf16, bound at the first launch
