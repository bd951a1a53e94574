"""PyTorch port: how the qkv window-attention kernel cuts up its work
(``kernels/qkv_window_attention.py``: ``plan_for``, ``plan_blocks`` and the
split model ``qkv_window_attention_split_plain``).

1. The grid of every plan ``plan_for`` picks, walked by the kernel's own
   index arithmetic (``plan_blocks``), covers the work exactly once: every
   (batch, window, head) in one cluster, every 16-row K/V token tile of a
   group in one rank, every query slab in one rank, with that rank's q token
   tiles; at the nine windowed ``sam2.1_hiera_t512`` blocks (seven
   geometries), EfficientMedSAM-S's and -Ti's ws-14 blocks and the edge
   shapes chip_smoke.py holds, at B 1 and B 4, and for plans the rule does
   not pick.
2. The plan rule: the least modelled time over the candidates, then the
   fewest bytes; a group of windows at ws 4 and 8, a
   cluster at B 1's ws-14 t512 and S blocks.
3. The split model against the JAX package: ``_xla_ref_qkv`` at the seven
   t512 geometries in f32 and bf16, and the Pallas ``_run_qkv`` in interpret
   mode at hd 128; and against ``qkv_window_attention_plain`` in f32 (the
   same function with its rows regrouped), for the picked plans and others.
4. A split model that drops one rank's K and V share is told apart from the
   plain version (chip_smoke.py's self-test of the same).
The kernel itself is held against the plain version on the card by
chip_smoke.py.

Tolerances: against the JAX package as tests/test_torch_qkv_window_attention.py
(f32 1e-4 relative, bf16 the JAX kernel tests' 2e-2); against the plain
version in f32 1e-6 of the output's largest value (the projection of a row
subset may round the last bit apart from the whole map's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import fused_window_attention as jwin
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels import qkv_window_attention as qwa
from us_video_medsam2_tpu_torch.kernels.window_attention import REGISTERS, key_tiles

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (Hp, Wp, ws, nh, q_pool, Cin, hd): the seven geometries of the nine windowed
# sam2.1_hiera_t512 blocks with the fused projection
T512 = [
    (128, 128, 8, 1, False, 96, 96),
    (128, 128, 8, 2, True, 96, 96),
    (64, 64, 4, 2, False, 192, 96),
    (64, 64, 4, 4, True, 192, 96),
    (42, 42, 14, 4, False, 384, 96),
    (42, 42, 14, 8, True, 384, 96),
    (21, 21, 7, 8, False, 768, 96),
]
# EfficientMedSAM-S's and -Ti's ws-14 blocks, and chip_smoke.py's edge shapes
VIT = [(42, 42, 14, 6, False, 384, 64), (42, 42, 14, 3, False, 192, 64)]
EDGES = [
    (28, 42, 14, 2, True, 192, 96),
    (14, 21, 7, 3, False, 96, 96),
    (42, 42, 14, 6, False, 384, 64),
    (28, 28, 14, 2, True, 192, 64),
]
GEOMETRIES = T512 + VIT + EDGES


def _inputs(b, rows, wp, cin, c, seed):
    """y [b, rows, wp, cin], w in JAX's [Cin, C] layout, f32 bias [C]
    (tests/test_torch_qkv_window_attention.py's inputs)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, rows, wp, cin)).astype(np.float32)
    w = (rng.standard_normal((cin, c)) * cin**-0.5).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    return y, w, bias


def _check_cover(b, hp, wp, ws, nh, q_pool, plan):
    win = qwa._window(ws, q_pool)
    nww, nwin = wp // ws, (hp // ws) * (wp // ws)
    blocks = list(qwa.plan_blocks(b, hp, wp, ws, nh, q_pool, plan))
    assert [blk["block"] for blk in blocks] == list(range(len(blocks)))
    assert len(blocks) == -(-b * nwin // plan.g) * nh * plan.c
    seen = []
    for i in range(0, len(blocks), plan.c):
        cluster = blocks[i:i + plan.c]
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
    want = [(bi, wy, wx, h) for bi in range(b) for wy in range(hp // ws) for wx in range(nww) for h in range(nh)]
    assert sorted(seen) == want


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin,hd", GEOMETRIES)
def test_plan_covers_the_work_exactly_once(hp, wp, ws, nh, q_pool, cin, hd, b):
    plan = qwa.plan_for(b, hp, wp, ws, nh, hd, q_pool, cin)
    _check_cover(b, hp, wp, ws, nh, q_pool, plan)
    for other in (qwa.Plan(1, 1), qwa.Plan(3, 1), qwa.Plan(1, min(3, key_tiles(ws)))):
        _check_cover(b, hp, wp, ws, nh, q_pool, other)  # partial last groups, uneven rank shares


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin,hd", GEOMETRIES)
def test_plan_rule(hp, wp, ws, nh, q_pool, cin, hd, b):
    plan = qwa.plan_for(b, hp, wp, ws, nh, hd, q_pool, cin)
    costs = {p: qwa.plan_cost(b, hp, wp, ws, nh, hd, q_pool, cin, p) for p in qwa.candidates(ws, q_pool)}
    runs = {p: c for p, c in costs.items() if c is not None}
    assert plan in runs
    assert min(runs, key=lambda p: (runs[p][0], runs[p][1], p.g, p.c)) == plan
    assert qwa.smem_bytes(hd, ws, q_pool, plan) <= _lib.SMEM_PER_BLOCK
    assert qwa.clusters_at_once(hd, ws, q_pool, plan) >= 1
    assert plan.g == 1 or (plan.c == 1 and plan.g * key_tiles(ws) <= qwa.MAX_GROUP_TILES)
    if b == 1 and (hp, wp) == (42, 42) and cin == 384 and not q_pool:
        assert plan.c > 1  # t512's ws-14 blocks and S's: 36-54 window-heads spread over clusters
    if ws in (4, 8) and (hp, wp) in ((64, 64), (128, 128)):
        assert plan.g > 1  # each head's weight rows read once per group of windows


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin,hd", T512)
def test_split_model_matches_xla_ref(hp, wp, ws, nh, q_pool, cin, hd, dtype):
    rows = min(hp, 2 * ws)  # a slice of the rows keeps the larger maps fast
    y, w, b = _inputs(1, rows, wp, cin, 3 * nh * hd, seed=0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jy, jw = jnp.asarray(y, jdt), jnp.asarray(w, jdt)
    want = np.asarray(jwin._xla_ref_qkv(jy, jw, jnp.asarray(b), ws, nh, hd, q_pool), np.float32)
    plan = qwa.plan_for(1, hp, wp, ws, nh, hd, q_pool, cin)
    got = qwa.qkv_window_attention_split_plain(t(np.asarray(jy.astype(jnp.float32))).to(tdt),
                                               t(np.asarray(jw.astype(jnp.float32)).T).to(tdt), t(b), ws, nh,
                                               q_pool, plan)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), want, **(F32 if dtype == "f32" else BF16))


@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin,hd", T512)
def test_split_model_matches_pallas_interpret_hd128(hp, wp, ws, nh, q_pool, cin, hd):
    rows = min(hp, 2 * ws)
    y, w, b = _inputs(1, rows, wp, cin, 3 * nh * 128, seed=1)
    jy, jw = jnp.asarray(y, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jwin._run_qkv(jy, jw, jnp.asarray(b), ws=ws, nh=nh, hd=128, q_pool=q_pool, interpret=True)
    plan = qwa.plan_for(1, hp, wp, ws, nh, hd, q_pool, cin)  # the hd-96 block's cut, at hd 128
    got = qwa.qkv_window_attention_split_plain(t(np.asarray(jy.astype(jnp.float32))).to(torch.bfloat16),
                                               t(np.asarray(jw.astype(jnp.float32)).T).to(torch.bfloat16), t(b),
                                               ws, nh, q_pool, plan)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin,hd", T512 + VIT)
def test_split_model_is_the_plain_function(hp, wp, ws, nh, q_pool, cin, hd):
    rows = min(hp, 2 * ws)
    y, w, b = (t(a) for a in _inputs(2, rows, wp, cin, 3 * nh * hd, seed=2))
    y[:, -1] = 0  # zero pad tokens: their q, k and v are the bias
    w = w.T.contiguous()
    want = qwa.qkv_window_attention_plain(y, w, b, ws, nh, q_pool)
    scale = float(want.abs().max())
    for plan in {qwa.plan_for(1, hp, wp, ws, nh, hd, q_pool, cin), qwa.Plan(3, 1),
                 qwa.Plan(1, min(5, key_tiles(ws)))}:
        got = qwa.qkv_window_attention_split_plain(y, w, b, ws, nh, q_pool, plan)
        assert float((got - want).abs().max()) <= 1e-6 * scale, plan


@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin,hd", [T512[4], VIT[0]])
def test_split_model_without_one_rank_share_is_told_apart(hp, wp, ws, nh, q_pool, cin, hd):
    y, w, b = (t(a) for a in _inputs(1, hp, wp, cin, 3 * nh * hd, seed=3))
    w = w.T.contiguous()
    plan = qwa.plan_for(1, hp, wp, ws, nh, hd, q_pool, cin)
    assert plan.c > 1
    want = qwa.qkv_window_attention_plain(y, w, b, ws, nh, q_pool)
    dropped = qwa.qkv_window_attention_split_plain(y, w, b, ws, nh, q_pool, plan, drop_rank=1)
    rel = float((dropped - want).norm() / want.norm())
    assert rel > 1e-2, rel  # chip_smoke.py's attention check (rel-L2 <= 1e-2) rejects it


def test_blocks_per_sm_model():
    """``_lib.blocks_per_sm``: registers allocated 256 a warp, 1 KB of shared
    memory a block for the runtime, 2048 threads and 32 blocks an SM."""
    assert _lib.blocks_per_sm(255, 1000, 256) == 1  # 8 warps of 8192 registers fill the 65536
    assert _lib.blocks_per_sm(128, 1000, 128) == 4
    assert _lib.blocks_per_sm(32, 1000, 32) == 32
    assert _lib.blocks_per_sm(32, 100_000, 64) == 2  # (100000 + 1024) x 2 <= 233472
    assert _lib.blocks_per_sm(REGISTERS[(96, 13)], 60_000, 256) == 1


def test_kernel_override_and_dispatch():
    """A CPU tensor takes the plain version without counting a launch; off
    the CPU the launch raises on what it does not take (a meta tensor stands
    in for a foreign device), whatever the plan."""
    y, w, b = _inputs(1, 8, 8, 96, 3 * 96, seed=4)
    before = qwa.qkv_window_attention.launches
    assert torch.equal(qwa.qkv_window_attention(t(y), t(w.T), t(b), 8, 1, False),
                       qwa.qkv_window_attention_plain(t(y), t(w.T), t(b), 8, 1, False))
    assert qwa.qkv_window_attention.launches == before
    m = dict(device="meta")
    with pytest.raises(ValueError):
        qwa._kernel(torch.empty(1, 8, 8, 96, **m), torch.empty(288, 96, **m), torch.empty(288, **m), 8, 1, False,
                    plan=qwa.Plan(1, 1))
