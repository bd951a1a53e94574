"""The attention half of a Hiera block in one call — kernel and plain version.

Replaces the TPU kernel ``us_video_medsam2_tpu/kernels/rejected/window_attention_v1.py``
(``window_attention``, bodies ``_run`` / ``_kernel``). Unwired, as in the JAX
package: no model calls it. Over a spatial map already padded to whole
windows, x [B, Hp, Wp, C]: optional LayerNorm in f32 rounded to x's dtype
(pad tokens included, so a zero pad token becomes ``beta``); per head, q, k
and v as products with f32 accumulation plus the f32 bias, rounded; q
optionally 2x2 max-pooled inside the window; f32 logits times Dh^-½ and f32
softmax, P normalised before its rounding; o = P·v rounded; and
out = Σ_h o_h·wo_h + bo summed over heads in f32 and rounded once. Output
[B, Hp/ws·wso, Wp/ws·wso, Co]. Pad tokens are attended unmasked.

On the H100 it is bound by operations (the projections, the attention
products and the output projection); at B 1 the work is small, and what a
call costs is the chain of one block. The CUDA source
(``csrc/window_attention_v1.cu``) runs two kernels, since one window's f32
[wso², Co] accumulator can exceed a block's shared memory:
- the attention kernel cuts the work into block tiles of (a group of G
  windows, one head, one rank of a cluster of C blocks), as
  ``qkv_window_attention`` does: each block computes the LN statistics of its
  tokens once and normalises each element once, into a resident bf16 tile of
  its tokens where it fits (``resident``; else on the ``cp.async`` stage it
  lands in), projects K, V and q on ``mma.sync`` (the [C, 96] weights read as
  they lie, through ``ldmatrix.trans``), the ranks of a cluster swap their K
  and V shares through distributed shared memory, and every warp runs
  ``window_attention``'s slab core on one 16-row query slab at a time; o is
  rounded once into a scratch map [B, Hpo, Wpo, H·96];
- the output-projection kernel computes o·wo + bo over every head in f32, a
  64- or 32-row x 96- or 32-column tile a block, ``mma.sync`` with o and wo
  through a ``cp.async`` ring.
``plan_for`` picks (G, C) and the projection's tile from the shape alone:
G > 1 reads a head's weight rows once per G small windows; C > 1 spreads a
large unpooled window-head over C SMs; the tile spreads the projection's
products over the card. ``plan_blocks`` walks both grids by the kernels' own
index arithmetic, and ``window_attention_v1_split_plain`` computes the
function as a plan cuts it up (for the tests). Dh is 96 only, as for the
other window kernels; ws up to 16 (256 tokens a window); C and Co multiples
of 32.

The gradient is that of ``_xla_ref`` (the JAX custom_vjp's XLA recompute):
the plain version's, recomputed in the backward pass, with no kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels import qkv_window_attention as qwa

SUPPORTED_HD = (96,)
HD = 96
MAX_WS = 16
C_CHUNK = 32  # the attention kernel streams C in chunks of 32
STAGES = 3
TILES_A_WARP = 2  # 16-row tiles a warp projects in one pass
WARPS = 8  # warps an attention block
MAX_GROUP = 8
MAX_CLUSTER = 8
G_CHOICES = (1, 2, 4, MAX_GROUP)
C_CHOICES = tuple(range(1, MAX_CLUSTER + 1))
MAX_GROUP_TILES = 8  # token tiles of a group of G > 1 windows: an M dimension of at most 128 rows
PROJ_TILES = ((64, 6), (32, 6), (64, 2), (32, 2))  # output-projection tiles: (rows, 8-column tiles a warp)
# What the plan's occupancy depends on (chip_smoke.py holds it against the
# card at every plan plan_for picks): registers a thread of each key-tiles
# instantiation of the attention kernel and of each tile of the output
# projection, from nvcc -Xptxas -v on sm_90a. At 8 warps and these registers
# an SM holds one attention block.
REGISTERS = {1: 238, 4: 251, 13: 255, 16: 255}
PROJ_REGISTERS = {(64, 6): 74, (32, 6): 76, (64, 2): 58, (32, 2): 50}
# The plan's model of a block's time, in flop (``qkv_window_attention``'s):
# ROUND_FLOPS for a block's fixed chain, its products, FLOPS_PER_BYTE a byte
# it reads from L2.
FLOPS_PER_BYTE = qwa.FLOPS_PER_BYTE
ROUND_FLOPS = qwa.ROUND_FLOPS


class Plan(NamedTuple):
    g: int  # windows a group (an attention block tile's windows)
    c: int  # blocks a cluster (ranks sharing a group-head)
    rows: int  # rows of an output-projection tile (64 or 32: 2 warps of 16 rows a column half)
    nt: int  # 8-column tiles a warp of the output projection (its tile: 16 nt columns)


cdiv = qwa.cdiv


def key_tiles(ws: int) -> int:
    """16-key tiles of the instantiation that holds a ws x ws window (its keys pad to 16, 64, 208 or 256)."""
    return 1 if ws <= 4 else 4 if ws <= 8 else 13 if ws <= 14 else 16


def _window(ws: int, q_pool: bool):
    wso = ws // 2 if q_pool else ws
    lq = wso * wso
    return qwa._Window(key_tiles(ws), ws * ws, wso, lq, cdiv(lq, 16), cdiv((4 if q_pool else 1) * lq, 16))


def _ln(x, gamma, beta, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(x.dtype)


def window_attention_v1_plain(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo,
                              ws: int, q_pool: bool, ln_inside: bool, eps: float):
    """Plain PyTorch version (the JAX ``_xla_ref``)."""
    b, hp, wp, c = x.shape
    nh, _, dh = wq.shape
    co = wo.shape[2]
    dt = x.dtype
    y = _ln(x, gamma, beta, eps) if ln_inside else x
    nwh, nww = hp // ws, wp // ws
    yw = y.reshape(b, nwh, ws, nww, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nwh * nww, ws * ws, c)

    def project(w, bias):
        return (torch.einsum("bnc,hcd->bhnd", yw.float(), w.to(dt).float())
                + bias.float()[None, :, None, :]).to(dt)

    q, k, v = project(wq, bq), project(wk, bk), project(wv, bv)
    wso = ws
    if q_pool:
        wso = ws // 2
        q = q.reshape(-1, nh, wso, 2, wso, 2, dh).amax(dim=(3, 5)).reshape(-1, nh, wso * wso, dh)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh**-0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v.float()).to(dt)
    out = torch.einsum("bhqd,hdc->bqc", o.float(), wo.to(dt).float()) + bo.float()
    out = out.to(dt).reshape(b, nwh, nww, wso, wso, co).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, nwh * wso, nww * wso, co)


def plan_blocks(b: int, hp: int, wp: int, ws: int, nh: int, q_pool: bool, co: int, plan: Plan):
    """Yield a dict for every block of the two kernels' grids in launch
    order, by their own index arithmetic. The attention kernel's: kernel
    "attention", block, task (group x head), rank, head, windows [(batch,
    window row, window column)], and the rank's token tiles, slabs and q
    token tiles as [lo, hi) ranges of the group's. The output projection's:
    kernel "projection", block (row tile, column tile), and its rows of the
    output map (batch-major, row-major) and its columns as [lo, hi)."""
    win = _window(ws, q_pool)
    nww = wp // ws
    nwin = hp // ws * nww
    n_win = b * nwin
    for task in range(cdiv(n_win, plan.g) * nh):
        head, w0 = task % nh, task // nh * plan.g
        gw = min(plan.g, n_win - w0)
        windows = [((w0 + g) // nwin, (w0 + g) % nwin // nww, (w0 + g) % nwin % nww) for g in range(gw)]
        for rank in range(plan.c):
            tiles, slabs, qtiles = qwa._shares(win, gw, plan.c, rank, q_pool)
            yield {"kernel": "attention", "block": task * plan.c + rank, "task": task, "rank": rank, "head": head,
                   "windows": windows, "tiles": tiles, "slabs": slabs, "qtiles": qtiles}
    m = n_win * win.lq
    bn = 16 * plan.nt
    for cy in range(co // bn):
        for rx in range(cdiv(m, plan.rows)):
            yield {"kernel": "projection", "block": (rx, cy), "rows": (rx * plan.rows, min(m, (rx + 1) * plan.rows)),
                   "cols": (cy * bn, (cy + 1) * bn)}


def _smem(ws: int, q_pool: bool, c: int, plan: Plan, res: bool) -> int:
    win = _window(ws, q_pool)
    ld, ldr = HD + 8, C_CHUNK + 8
    slabs = cdiv(plan.g * win.slabs, plan.c)  # the most slabs a rank takes
    tiles = cdiv(plan.g * win.kt, plan.c)  # the most token tiles a rank takes

    def align(n):
        return -(-n // 128) * 128

    st = 4 * 3 * HD + 4 * 2 * c + 8 * MAX_GROUP + 2 * 4 * win.kt * 16
    ys = align(align(st + 8 * tiles * 16) + 2 * 2 * plan.g * win.kt * 16 * ld + 2 * slabs * 16 * ld)
    ring = align(ys + (2 * tiles * 16 * (c + 8) if res else 0))
    a_kv = 0 if res else min(WARPS * TILES_A_WARP // 2, tiles) * 16
    a_q = 0 if res else min(WARPS * TILES_A_WARP, slabs * (4 if q_pool else 1)) * 16
    return ring + 2 * STAGES * max(a_kv * ldr + 2 * C_CHUNK * ld, a_q * ldr + C_CHUNK * ld)


def resident(ws: int, q_pool: bool, c: int, ln: bool, plan: Plan) -> bool:
    """Whether an attention block holds its rank's token rows (all C) in
    shared memory, normalised once (``Geo::res``): with LayerNorm, wherever
    they fit."""
    return ln and _smem(ws, q_pool, c, plan, True) <= _lib.SMEM_PER_BLOCK


def smem_bytes(ws: int, q_pool: bool, c: int, ln: bool, plan: Plan) -> int:
    """Dynamic shared memory of an attention block (``Smem`` in the CUDA
    source): the head's f32 bias, gamma and beta, the token address tables,
    the LN statistics of the rank's tiles, the group's K and V, the rank's q
    slabs, the rank's token rows where they fit (``resident``), then the
    ring's STAGES stages, each with room for the most token rows a pass of
    the plan copies (none with resident rows) and its weight rows."""
    return _smem(ws, q_pool, c, plan, resident(ws, q_pool, c, ln, plan))


def proj_smem_bytes(rows: int, nt: int) -> int:
    """Dynamic shared memory of an output-projection block (``ProjSmem``):
    STAGES stages of its o rows and 96 wo rows (one head's channels)."""
    return 2 * STAGES * (rows * (HD + 8) + HD * (16 * nt + 8))


def blocks_per_sm(ws: int, q_pool: bool, c: int, ln: bool, plan: Plan) -> int:
    """Attention blocks of the plan one SM holds (``_lib.blocks_per_sm``)."""
    return _lib.blocks_per_sm(REGISTERS[key_tiles(ws)], smem_bytes(ws, q_pool, c, ln, plan), 32 * WARPS)


def proj_blocks_per_sm(rows: int, nt: int) -> int:
    """Output-projection blocks of the tile one SM holds (2 warps a 16-row strip)."""
    return _lib.blocks_per_sm(PROJ_REGISTERS[(rows, nt)], proj_smem_bytes(rows, nt), 4 * rows)


def clusters_at_once(ws: int, q_pool: bool, c: int, ln: bool, plan: Plan) -> int | None:
    """Clusters of the plan's attention kernel the card runs at once, or None
    where the table does not say."""
    per_sm = blocks_per_sm(ws, q_pool, c, ln, plan)
    if per_sm == 0:
        return None
    return _lib.SMS * per_sm if plan.c == 1 else _lib.CLUSTERS_AT_ONCE.get((plan.c, per_sm))


def _rank_work(win, c: int, q_pool: bool, ln: bool, plan: Plan, rank: int) -> tuple[int, int]:
    """(modelled time in flop, bytes read from L2) of one rank of a full
    group: ``qkv_window_attention``'s model, plus the LN statistics' two
    reads of the rank's tokens."""
    flops, nbytes = qwa._rank_work(win, HD, c, q_pool, qwa.Plan(plan.g, plan.c), rank)
    if ln:
        (t_lo, t_hi), _, _ = qwa._shares(win, plan.g, plan.c, rank, q_pool)
        stats = 2 * 2 * c * 16 * (t_hi - t_lo)
        flops, nbytes = flops + FLOPS_PER_BYTE * stats, nbytes + stats
    return flops, nbytes


def attention_cost(b: int, hp: int, wp: int, ws: int, nh: int, q_pool: bool, c: int, ln: bool,
                   plan: Plan) -> tuple[int, int] | None:
    """(modelled time, bytes the grid reads) of the attention kernel under
    the plan, or None where it does not run (shared memory) or the occupancy
    table has no entry: rounds of clusters (or of the blocks an SM runs in
    turn) x the largest block's time."""
    if smem_bytes(ws, q_pool, c, ln, plan) > _lib.SMEM_PER_BLOCK:
        return None
    at_once = clusters_at_once(ws, q_pool, c, ln, plan)
    if not at_once:
        return None
    win = _window(ws, q_pool)
    tasks = cdiv(b * (hp // ws) * (wp // ws), plan.g) * nh
    rounds = max(cdiv(tasks, at_once), cdiv(tasks * plan.c, _lib.SMS))
    work = [_rank_work(win, c, q_pool, ln, plan, r) for r in range(plan.c)]
    return rounds * (ROUND_FLOPS + max(w[0] for w in work)), tasks * sum(w[1] for w in work)


def proj_cost(m: int, k: int, co: int, rows: int, nt: int) -> tuple[int, int] | None:
    """(modelled time, bytes the grid reads from L2) of the output projection
    at a tile, or None where the tile does not divide Co. At these sizes the
    products bound it (measured: 56 blocks of 64 x 96 at M 441, K 768 took
    0.0094-0.0101 ms): the time is an SM's share of the blocks, each its
    rows x columns x K products; o is read once a column tile, wo once a row
    tile."""
    bn = 16 * nt
    if co % bn:
        return None
    blocks = cdiv(m, rows) * (co // bn)
    return cdiv(blocks, _lib.SMS) * rows * bn * k, 2 * k * (m * (co // bn) + co * cdiv(m, rows))


def candidates(ws: int, q_pool: bool):
    """The attention plans (G, C) ``plan_for`` weighs: G > 1 (at most
    MAX_GROUP_TILES token tiles a group) with C 1, or G 1 with C up to the
    window's key tiles (a rank with no tile would only copy); C > 1 only
    unpooled, where a rank's query slabs are its token tiles."""
    win = _window(ws, q_pool)
    for g in G_CHOICES:
        for c in C_CHOICES:
            if (g > 1 and (c > 1 or g * win.kt > MAX_GROUP_TILES)) or c > g * win.kt:
                continue
            if c > 1 and (q_pool or win.slabs != win.kt):
                continue
            yield g, c


@functools.lru_cache(maxsize=None)  # Python on every launch otherwise
def plan_for(b: int, hp: int, wp: int, ws: int, nh: int, q_pool: bool, c: int, co: int,
             ln: bool = True) -> Plan:
    """The kernels' plan for this call, from the shape alone: the attention
    kernel's (G, C) with the least modelled time (``attention_cost``), then
    the fewest bytes read; the output projection's tile with the least
    modelled time, then the fewest bytes (``proj_cost``)."""
    best = None
    for g, cl in candidates(ws, q_pool):
        cost = attention_cost(b, hp, wp, ws, nh, q_pool, c, ln, Plan(g, cl, *PROJ_TILES[0]))
        if cost is None:
            continue
        key = (cost[0], cost[1], g, cl)
        if best is None or key < best[0]:
            best = (key, (g, cl))
    if best is None:
        raise ValueError(f"window_attention_v1: no plan fits ws {ws} C {c}")
    m = b * (hp // ws) * (wp // ws) * _window(ws, q_pool).lq
    tiles = {t: proj_cost(m, nh * HD, co, *t) for t in PROJ_TILES}
    tiles = {t: cost for t, cost in tiles.items() if cost is not None}
    if not tiles:
        raise ValueError(f"window_attention_v1: Co={co} is not a multiple of 32")
    return Plan(*best[1], *min(tiles, key=lambda t: (*tiles[t], -t[0], -t[1])))


def window_attention_v1_split_plain(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo, ws: int, q_pool: bool,
                                    ln_inside: bool, eps: float, plan: Plan, drop_head: int | None = None):
    """The plain version computed as ``plan`` cuts it up (``plan_blocks``):
    each rank normalises the tokens of its tiles (LN a token row, as the
    kernel's statistics) and projects K and V of its token tiles (key rows
    past ws² zero) and q of its slabs (under pooling the 2x2 max of the four
    rounded token q); the group's K and V are the ranks' shares put together,
    and each slab attends its window into o. Then each output-projection
    block computes its rows and columns of o·wo + bo over every head's
    channels in f32, rounded once. The same rounding points as the plain
    version. ``drop_head`` leaves that head out of the projection's sum (a
    check's self-test)."""
    bsz, hp, wp, c = x.shape
    nh, _, hd = wq.shape
    co = wo.shape[2]
    win = _window(ws, q_pool)
    rows = win.kt * 16
    nwh, nww = hp // ws, wp // ws
    dt = x.dtype
    w3 = [w.to(dt).float() for w in (wq, wk, wv)]
    b3 = [bias.float() for bias in (bq, bk, bv)]
    tok = x.reshape(bsz, nwh, ws, nww, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(bsz, nwh, nww, ws * ws, c)
    tok = torch.nn.functional.pad(tok, (0, 0, 0, rows - ws * ws))  # key rows past ws²: zero below
    o = torch.zeros(bsz, nwh * win.wso, nww * win.wso, nh, hd, dtype=dt, device=x.device)
    key_ok = (torch.arange(rows, device=x.device) < win.lk)[:, None]

    def norm(t):
        return _ln(t, gamma, beta, eps) if ln_inside else t

    def proj(y, which, head):
        return (y.float() @ w3[which][head] + b3[which][head]).to(dt)

    blocks = [blk for blk in plan_blocks(bsz, hp, wp, ws, nh, q_pool, co, plan) if blk["kernel"] == "attention"]
    for i in range(0, len(blocks), plan.c):
        cluster = blocks[i:i + plan.c]
        head, windows = cluster[0]["head"], cluster[0]["windows"]
        xg = torch.stack([tok[bi, wy, wx] for bi, wy, wx in windows]).reshape(-1, c)
        k = torch.zeros(xg.shape[0], hd, dtype=dt, device=x.device)
        v = torch.zeros_like(k)
        ok = key_ok.repeat(len(windows), 1)
        for blk in cluster:
            lo, hi = (16 * t for t in blk["tiles"])
            y = norm(xg[lo:hi])
            k[lo:hi] = torch.where(ok[lo:hi], proj(y, 1, head), 0)
            v[lo:hi] = torch.where(ok[lo:hi], proj(y, 2, head), 0)
        for blk in cluster:
            for gs in range(*blk["slabs"]):
                g, s = divmod(gs, win.slabs)
                bi, wy, wx = windows[g]
                qi = torch.arange(16 * s, min(16 * s + 16, win.lq), device=x.device)
                if q_pool:
                    t = [(2 * (qi // win.wso) + d // 2) * ws + 2 * (qi % win.wso) + d % 2 for d in range(4)]
                    q = torch.stack([proj(norm(tok[bi, wy, wx, ti]), 0, head) for ti in t]).amax(0)
                else:
                    q = proj(norm(tok[bi, wy, wx, qi]), 0, head)
                kw, vw = k[g * rows:g * rows + win.lk], v[g * rows:g * rows + win.lk]
                sc = torch.matmul(q.float(), kw.float().t()) * (hd**-0.5)
                p = torch.exp(sc - sc.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True)
                o[bi, wy * win.wso + qi // win.wso, wx * win.wso + qi % win.wso, head] = torch.matmul(
                    p.to(dt).float(), vw.float()).to(dt)
    if drop_head is not None:
        o[..., drop_head, :] = 0
    om = o.reshape(-1, nh * hd).float()
    wm = wo.to(dt).float().reshape(nh * hd, co)
    out = torch.empty(om.shape[0], co, dtype=dt, device=x.device)
    for blk in plan_blocks(bsz, hp, wp, ws, nh, q_pool, co, plan):
        if blk["kernel"] == "projection":
            (r0, r1), (c0, c1) = blk["rows"], blk["cols"]
            out[r0:r1, c0:c1] = (om[r0:r1] @ wm[:, c0:c1] + bo.float()[c0:c1]).to(dt)
    return out.reshape(bsz, nwh * win.wso, nww * win.wso, co)


def window_attention_v1(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo,
                        ws: int, q_pool: bool, ln_inside: bool, eps: float):
    """[B, Hp, Wp, C] -> [B, Hp/ws·wso, Wp/ws·wso, Co]. CPU tensors take the
    plain version; a CUDA tensor launches the kernels (bf16 x; the weights
    are cast to x's dtype and the norm and bias vectors to f32, as the TPU
    kernel casts them: no copy where they already are) or raises. The
    gradient is the plain version's, recomputed in the backward pass."""
    args = (x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo, ws, q_pool, ln_inside, eps)
    if x.is_cpu:
        return window_attention_v1_plain(*args)
    return _lib.with_plain_grad(_kernel, window_attention_v1_plain, *args)


def _kernel(x, gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo, ws, q_pool, ln_inside, eps, plan: Plan | None = None):
    """The launch; ``plan`` overrides ``plan_for`` (for measurements)."""
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("window_attention_v1 kernel takes contiguous, 16-byte aligned bf16 CUDA x")
    b, hp, wp, c = x.shape
    nh, _, dh = wq.shape
    co = wo.shape[2]
    if dh not in SUPPORTED_HD or c % C_CHUNK or co % C_CHUNK:
        raise ValueError(f"window_attention_v1 kernel: Dh={dh} not in {SUPPORTED_HD}, or C={c} or Co={co} "
                         f"not a multiple of {C_CHUNK}")
    if not 0 < ws <= MAX_WS or hp % ws or wp % ws or (q_pool and ws % 2):
        raise ValueError(f"window_attention_v1 kernel: ws={ws} must divide {hp}x{wp}, <= {MAX_WS}")

    def cast(t, shape, dtype):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"window_attention_v1 kernel: a parameter of shape {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {x.device}")
        t = t.detach().to(dtype).contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()  # the kernels read 16-byte chunks

    f32, dt = torch.float32, x.dtype
    params = [cast(gamma, (c,), f32), cast(beta, (c,), f32),
              *(cast(w, (nh, c, dh), dt) for w in (wq, wk, wv)),
              *(cast(bias, (nh, dh), f32) for bias in (bq, bk, bv)),
              cast(wo, (nh, dh, co), dt), cast(bo, (co,), f32)]
    p = plan or plan_for(b, hp, wp, ws, nh, bool(q_pool), c, co, bool(ln_inside))
    wso = ws // 2 if q_pool else ws
    hpo, wpo = hp // ws * wso, wp // ws * wso
    o = torch.empty((b, hpo, wpo, nh * dh), dtype=dt, device=x.device)
    out = torch.empty((b, hpo, wpo, co), dtype=dt, device=x.device)
    global _fn
    if _fn is None:
        _fn = _lib.fn("usm_window_attention_v1_bf16", [_lib.P] * 13 + [_lib.I] * 14 + [_lib.F, _lib.F, _lib.P])
    rc = _fn(x.data_ptr(), *(t.data_ptr() for t in params), o.data_ptr(), out.data_ptr(),
             b, hp, wp, c, nh, dh, co, ws, int(q_pool), int(ln_inside), p.g, p.c, p.rows, p.nt, float(eps),
             float(dh**-0.5), _lib.stream_ptr(x))
    _lib.check(rc, "window_attention_v1")
    window_attention_v1.launches += 1
    return out


def card_occupancy(ws: int, q_pool: bool, c: int, ln: bool, plan: Plan) -> tuple[int, int, int, int]:
    """(shared-memory bytes of an attention block, attention blocks an SM
    holds, clusters the card runs at once, output-projection blocks an SM
    holds) of the plan's kernels, as the card's occupancy API gives them;
    needs the card."""
    n = [ctypes.c_int(0) for _ in range(4)]
    fn = _lib.fn("usm_window_attention_v1_occupancy", [_lib.I] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3)
    _lib.check(fn(ws, int(q_pool), c, int(ln), plan.g, plan.c, *map(ctypes.byref, n[:3])),
               "window_attention_v1 occupancy")
    fn = _lib.fn("usm_window_attention_v1_proj_occupancy", [_lib.I, _lib.I, ctypes.POINTER(ctypes.c_int)])
    _lib.check(fn(plan.rows, plan.nt, ctypes.byref(n[3])), "window_attention_v1 projection occupancy")
    return tuple(v.value for v in n)


_lib.counted(window_attention_v1)
_fn = None  # usm_window_attention_v1_bf16, bound at the first launch


def split_qkv_params(wqkv, bqkv, wproj, n_heads: int):
    """[C, 3·Do], [3·Do], [Do, Do] (the Dense layout, inputs first) ->
    per-head wq/wk/wv [H, C, Dh], bq/bk/bv [H, Dh], wo [H, Dh, Do]. A copy of
    the JAX package's ``split_qkv_params``; the port's Linear weights are
    [out, in], so pass ``qkv.weight.T`` and ``proj.weight.T``."""
    c, three_do = wqkv.shape
    do = three_do // 3
    dh = do // n_heads
    w = wqkv.reshape(c, 3, n_heads, dh)
    bqkv_ = bqkv.reshape(3, n_heads, dh)
    wq = w[:, 0].permute(1, 0, 2)
    wk = w[:, 1].permute(1, 0, 2)
    wv = w[:, 2].permute(1, 0, 2)
    wo = wproj.reshape(n_heads, dh, wproj.shape[1])
    return wq, wk, wv, bqkv_[0], bqkv_[1], bqkv_[2], wo
