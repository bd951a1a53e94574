"""PyTorch port: how the window_attention_v1 kernels cut up their work
(``kernels/rejected/window_attention_v1.py``: ``plan_for``, ``plan_blocks``
and the split model ``window_attention_v1_split_plain``).

1. The grids of every plan ``plan_for`` picks, walked by the kernels' own
   index arithmetic (``plan_blocks``), cover the work exactly once: every
   (batch, window, head) in one cluster of the attention kernel, every
   16-row token tile, query slab and q token tile of a group in one rank,
   and every row and column of the output in one block of the output
   projection; at the seven geometries of the nine windowed
   ``sam2.1_hiera_t512`` blocks at B 1 and the six of the JAX package's v1
   test at B 2 (ws 16 included), with and without LayerNorm, and for plans
   the rule does not pick.
2. The plan rule: the least modelled time over the candidates, then the
   fewest bytes; never more clusters than the card runs at once (a cluster
   pick's clusters in one wave); a group of windows at ws 4 and 8, a cluster at B 1's
   ws-14 unpooled block; the output projection's tile with the fewest
   rounds, then the fewest bytes.
3. The split model against the JAX package: ``_xla_ref`` at the seven t512
   geometries in f32 and bf16, both ``ln_inside`` values (the geometries
   take both pooling values), and the Pallas ``_run`` in interpret mode; and
   against ``window_attention_v1_plain`` in f32 (the same function with its
   rows regrouped), for the picked plans and others.
4. A split model that leaves one head out of the output projection's sum is
   told apart from the plain version (chip_smoke.py's self-test of the same).
The kernels themselves are held against the plain version on the card by
chip_smoke.py.

Tolerances: against the JAX package as tests/test_torch_window_attention_v1.py
(f32 1e-4 relative, bf16 the JAX kernel tests' 2e-2); against the plain
version in f32 1e-5 of the output's largest value (the projections and the
head sum are f32 sums over 96-768 terms, and a product over a row or column
subset rounds them in another blocking: 2e-6 of the scale seen at C 384).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels.rejected import window_attention_v1 as jv1
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.rejected import window_attention_v1 as v1

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
EPS = 1e-6

# (hp, wp, c, heads, co, ws, q_pool): the seven geometries of the nine
# windowed sam2.1_hiera_t512 blocks (chip_smoke.py's V1_SHAPES), at B 1
T512 = [
    (128, 128, 96, 1, 96, 8, False),
    (128, 128, 96, 2, 192, 8, True),
    (64, 64, 192, 2, 192, 4, False),
    (64, 64, 192, 4, 384, 4, True),
    (42, 42, 384, 4, 384, 14, False),
    (42, 42, 384, 8, 768, 14, True),
    (21, 21, 768, 8, 768, 7, False),
]
# tests/test_rejected_window_attention_v1.py's CASES, at B 2
JAX_CASES = [
    (32, 32, 96, 1, 96, 8, False),
    (32, 32, 96, 2, 192, 8, True),
    (16, 16, 192, 2, 192, 4, False),
    (42, 42, 384, 4, 384, 14, False),
    (16, 16, 384, 4, 384, 16, False),
    (14, 14, 384, 8, 768, 14, True),
]
GEOMETRIES = [(1, *g) for g in T512] + [(2, *g) for g in JAX_CASES]


def _inputs(b, hp, wp, c, heads, co, seed, pad_rows=1):
    """x (its last pad_rows rows zero: pad tokens) and gamma, beta, wq, wk,
    wv, bq, bk, bv, wo, bo, f32 numpy (tests/test_torch_window_attention_v1.py's draws)."""
    rng = np.random.default_rng(seed)
    dh = 96
    x = rng.standard_normal((b, hp, wp, c)).astype(np.float32)
    if pad_rows:
        x[:, -pad_rows:] = 0.0
    return x, [
        (rng.standard_normal((c,)) * 0.1 + 1.0).astype(np.float32),
        (rng.standard_normal((c,)) * 0.1).astype(np.float32),
        *((rng.standard_normal((heads, c, dh)) / np.sqrt(c)).astype(np.float32) for _ in range(3)),
        *((rng.standard_normal((heads, dh)) * 0.1).astype(np.float32) for _ in range(3)),
        (rng.standard_normal((heads, dh, co)) / np.sqrt(dh)).astype(np.float32),
        (rng.standard_normal((co,)) * 0.1).astype(np.float32),
    ]


def _check_cover(b, hp, wp, ws, heads, q_pool, co, plan):
    win = v1._window(ws, q_pool)
    nww, nwin = wp // ws, (hp // ws) * (wp // ws)
    blocks = list(v1.plan_blocks(b, hp, wp, ws, heads, q_pool, co, plan))
    att = [blk for blk in blocks if blk["kernel"] == "attention"]
    proj = [blk for blk in blocks if blk["kernel"] == "projection"]
    assert len(att) + len(proj) == len(blocks)
    assert [blk["block"] for blk in att] == list(range(len(att)))
    assert len(att) == -(-b * nwin // plan.g) * heads * plan.c
    seen = []
    for i in range(0, len(att), plan.c):
        cluster = att[i:i + plan.c]
        assert [blk["rank"] for blk in cluster] == list(range(plan.c))
        assert len({blk["task"] for blk in cluster}) == 1 and len({blk["head"] for blk in cluster}) == 1
        windows = cluster[0]["windows"]
        assert all(blk["windows"] == windows for blk in cluster) and 1 <= len(windows) <= plan.g
        seen += [(bi, wy, wx, cluster[0]["head"]) for bi, wy, wx in windows]
        gw = len(windows)
        for key, total in (("tiles", gw * win.kt), ("slabs", gw * win.slabs), ("qtiles", gw * win.qtiles)):
            covered = [x for blk in cluster for x in range(*blk[key])]
            assert covered == list(range(total)), key  # every one once, ranks in order
        per_slab = 4 if q_pool else 1
        for blk in cluster:  # a rank's q token tiles are its slabs' own
            want = [g * win.qtiles + ti for gs in range(*blk["slabs"]) for g, s in [divmod(gs, win.slabs)]
                    for ti in range(per_slab * s, min(per_slab * s + per_slab, win.qtiles))]
            assert list(range(*blk["qtiles"])) == want
            if plan.c > 1:  # a cluster splits unpooled windows only: a rank's slabs are its token tiles
                assert not q_pool and blk["slabs"] == blk["tiles"]
    want = [(bi, wy, wx, h) for bi in range(b) for wy in range(hp // ws) for wx in range(nww) for h in range(heads)]
    assert sorted(seen) == want
    # the output projection: every (row, column) of the [b * Hpo * Wpo, co] output once
    m = b * nwin * win.lq
    hits = np.zeros((m, co), np.int64)
    for blk in proj:
        (r0, r1), (c0, c1) = blk["rows"], blk["cols"]
        assert r1 - r0 <= plan.rows and c1 - c0 == 16 * plan.nt
        hits[r0:r1, c0:c1] += 1
    assert (hits == 1).all()
    assert len({blk["block"] for blk in proj}) == len(proj)


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("b,hp,wp,c,heads,co,ws,q_pool", GEOMETRIES)
def test_plan_covers_the_work_exactly_once(b, hp, wp, c, heads, co, ws, q_pool, ln):
    plan = v1.plan_for(b, hp, wp, ws, heads, q_pool, c, co, ln)
    _check_cover(b, hp, wp, ws, heads, q_pool, co, plan)
    others = [v1.Plan(1, 1, 64, 2), v1.Plan(3, 1, 32, 6)]  # partial last groups, other projection tiles
    if not q_pool:
        others.append(v1.Plan(1, min(3, v1.key_tiles(ws)), 32, 2))  # uneven rank shares
    for other in others:
        _check_cover(b, hp, wp, ws, heads, q_pool, co, other)


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("b,hp,wp,c,heads,co,ws,q_pool", GEOMETRIES)
def test_plan_rule(b, hp, wp, c, heads, co, ws, q_pool, ln):
    plan = v1.plan_for(b, hp, wp, ws, heads, q_pool, c, co, ln)
    costs = {}
    for g, cl in v1.candidates(ws, q_pool):
        cost = v1.attention_cost(b, hp, wp, ws, heads, q_pool, c, ln, v1.Plan(g, cl, plan.rows, plan.nt))
        if cost is not None:
            costs[(g, cl)] = cost
    assert (plan.g, plan.c) == min(costs, key=lambda p: (*costs[p], *p))
    assert v1.smem_bytes(ws, q_pool, c, ln, plan) <= _lib.SMEM_PER_BLOCK
    # never more clusters than the card runs at once: every cluster of the pick in one wave
    tasks = -(-b * (hp // ws) * (wp // ws) // plan.g) * heads
    if plan.c > 1:
        assert tasks <= v1.clusters_at_once(ws, q_pool, c, ln, plan)
    assert plan.g == 1 or (plan.c == 1 and plan.g * v1.key_tiles(ws) <= v1.MAX_GROUP_TILES)
    if plan.c > 1:
        assert not q_pool
    if b == 1 and ws in (4, 8):
        assert plan.g > 1  # each head's weight rows read once per group of windows
    if b == 1 and ws == 14 and not q_pool:
        assert plan.c > 1  # t512's ws-14 blocks: 36 window-heads spread over clusters
    m = b * (hp // ws) * (wp // ws) * v1._window(ws, q_pool).lq
    tiles = {tile: v1.proj_cost(m, heads * 96, co, *tile) for tile in v1.PROJ_TILES}
    tiles = {tile: cost for tile, cost in tiles.items() if cost is not None}
    assert (plan.rows, plan.nt) == min(tiles, key=lambda tile: (*tiles[tile], -tile[0], -tile[1]))


def _rows(hp, ws):
    return min(hp, 2 * ws)  # a slice of the rows keeps the larger maps fast


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("hp,wp,c,heads,co,ws,q_pool", T512)
def test_split_model_matches_xla_ref(hp, wp, c, heads, co, ws, q_pool, ln, dtype):
    rows = _rows(hp, ws)
    x, p = _inputs(1, rows, wp, c, heads, co, seed=0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x, jdt)
    want = np.asarray(jv1._xla_ref(jx, *map(jnp.asarray, p), ws, q_pool, ln, EPS), np.float32)
    plan = v1.plan_for(1, hp, wp, ws, heads, q_pool, c, co, ln)  # the full map's cut
    got = v1.window_attention_v1_split_plain(t(np.asarray(jx.astype(jnp.float32))).to(tdt), *map(t, p), ws, q_pool,
                                             ln, EPS, plan)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), want, **(F32 if dtype == "f32" else BF16))


# unpooled with LN at a ws-8 group, pooled without LN; a cluster at ws 14
INTERPRET_CASES = [
    (16, 16, 96, 2, 192, 8, False, True, v1.Plan(2, 1, 64, 6)),
    (16, 16, 96, 2, 192, 8, True, False, v1.Plan(2, 1, 32, 2)),
    (14, 14, 384, 2, 192, 14, False, True, v1.Plan(1, 3, 32, 6)),
]


@pytest.mark.parametrize("hp,wp,c,heads,co,ws,q_pool,ln,plan", INTERPRET_CASES)
def test_split_model_matches_pallas_interpret(hp, wp, c, heads, co, ws, q_pool, ln, plan):
    x, p = _inputs(1, hp, wp, c, heads, co, seed=1)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jv1._run(jx, *map(jnp.asarray, p), ws=ws, q_pool=q_pool, ln_inside=ln, eps=EPS, interpret=True)
    got = v1.window_attention_v1_split_plain(t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16), *map(t, p),
                                             ws, q_pool, ln, EPS, plan)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("b,hp,wp,c,heads,co,ws,q_pool", GEOMETRIES)
def test_split_model_is_the_plain_function(b, hp, wp, c, heads, co, ws, q_pool, ln):
    rows = _rows(hp, ws)
    x, p = _inputs(b, rows, wp, c, heads, co, seed=2)
    x, p = t(x), list(map(t, p))
    want = v1.window_attention_v1_plain(x, *p, ws, q_pool, ln, EPS)
    scale = float(want.abs().max())
    plans = {v1.plan_for(b, hp, wp, ws, heads, q_pool, c, co, ln), v1.Plan(3, 1, 32, 2)}
    if not q_pool:
        plans.add(v1.Plan(1, min(5, v1.key_tiles(ws)), 64, 6 if co % 96 == 0 else 2))
    for plan in plans:
        got = v1.window_attention_v1_split_plain(x, *p, ws, q_pool, ln, EPS, plan)
        assert float((got - want).abs().max()) <= 1e-5 * scale, plan


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("hp,wp,c,heads,co,ws,q_pool", [T512[4], T512[5]])
def test_split_model_without_one_head_is_told_apart(hp, wp, c, heads, co, ws, q_pool, ln):
    x, p = _inputs(1, hp, wp, c, heads, co, seed=3)
    x, p = t(x), list(map(t, p))
    plan = v1.plan_for(1, hp, wp, ws, heads, q_pool, c, co, ln)
    want = v1.window_attention_v1_plain(x, *p, ws, q_pool, ln, EPS)
    for head in (0, heads - 1):
        dropped = v1.window_attention_v1_split_plain(x, *p, ws, q_pool, ln, EPS, plan, drop_head=head)
        rel = float((dropped - want).norm() / want.norm())
        assert rel > 1e-2, (head, rel)  # chip_smoke.py's attention check (rel-L2 <= 1e-2) rejects it


def test_occupancy_models():
    """The tables the plans size their grids by: one attention block an SM
    at every instantiation (registers), the output projection's blocks an
    SM by shared memory and registers, and residency only with LayerNorm."""
    for ws, q_pool, c in ((8, False, 96), (4, True, 192), (14, False, 384), (7, False, 768), (16, False, 384)):
        plan = v1.plan_for(1, 2 * ws, 2 * ws, ws, 2, q_pool, c, 192)
        assert v1.blocks_per_sm(ws, q_pool, c, True, plan) == 1
        assert not v1.resident(ws, q_pool, c, False, plan)
    for tile in v1.PROJ_TILES:
        assert v1.proj_smem_bytes(*tile) <= _lib.SMEM_PER_BLOCK
        assert v1.proj_blocks_per_sm(*tile) >= 2
    # the pooled ws-14 block without a cluster holds its 196 token rows nowhere: they stream through the ring
    assert not v1.resident(14, True, 384, True, v1.Plan(1, 1, 64, 6))
    assert v1.resident(14, False, 384, True, v1.Plan(1, 3, 64, 6))


def test_kernel_override_and_dispatch():
    """A CPU tensor takes the plain version without counting a launch; off
    the CPU the launch raises on what it does not take (a meta tensor stands
    in for a foreign device), whatever the plan."""
    x, p = _inputs(1, 8, 8, 96, 1, 96, seed=4, pad_rows=0)
    x, p = t(x), list(map(t, p))
    before = v1.window_attention_v1.launches
    assert torch.equal(v1.window_attention_v1(x, *p, 8, False, True, EPS),
                       v1.window_attention_v1_plain(x, *p, 8, False, True, EPS))
    assert v1.window_attention_v1.launches == before
    m = dict(device="meta")
    with pytest.raises(ValueError):
        v1._kernel(torch.empty(1, 8, 8, 96, **m), *(torch.empty(a.shape, **m) for a in p), 8, False, True, EPS,
                   plan=v1.Plan(1, 1, 64, 6))
