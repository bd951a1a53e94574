"""PyTorch port: the plain model of the CXBlock kernel's split
(``cxblock_split_plain``: the depthwise conv by the ranks' channel shares,
each rank's f32 partial over its hidden units, the fixed-order combine)
against the port's plain version and the JAX package's ``fused_cxblock._xla_ref``,
and the properties of ``plan_for`` and ``plan_blocks``. The kernel itself is
held against the same model on the card by chip_smoke.py.

Inputs come from numpy with a seed, at the kernel's width C 256 (the plan
depends on B, H and W only). Tolerances: 1e-4 relative in f32 (the split
only reassociates f32 sums), the 2e-2 of tests/test_torch_cxblock.py in bf16;
a split left out must fail chip_smoke.py's kernel check (|d| <= 0.02 +
0.02 |ref| on out - x). The layer scale γ is 1 ± 0.1 in f32 and 0.3 ± 0.03
in bf16: there an f32 sum taken in another order can land on the other side
of a bf16 rounding boundary of the pointwise output o (one ulp, up to 0.031
where |o| >= 4), which γ 1 passes undamped into x + γ·o; at 0.3 that stays
inside the 0.02 tolerance while the block's contribution is still 15 times
it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cxblock import _inputs, _jax_args, _port_args
from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import fused_cxblock as jcx
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels import cxblock as cx

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
C, F = 256, 1024
# (B, H, W) the kernel is called at: the memory encoder at 512² (t512 and
# EfficientMedSAM-S propagation, B 1), the training path's objects (B 3), and
# chip_smoke.py's edge shapes
PLAN_SHAPES = [(1, 32, 32), (3, 32, 32), (2, 16, 16), (1, 12, 20)]
PICKS = {(1, 32, 32): 6, (3, 32, 32): 2, (2, 16, 16): 8, (1, 12, 20): 8}
SPLITS = tuple(range(1, 9))


def _args(shape, seed, dtype):
    """x in ``dtype`` (the values JAX rounds it to) and the port-layout parameters."""
    x, p = _inputs(*shape, C, seed)
    if dtype == "bf16":
        p["gamma"] = 0.3 * p["gamma"]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x, jdt)
    return jx, p, (t(np.asarray(jx.astype(jnp.float32))).to(tdt), *_port_args(p))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_model_at_the_picked_plan_matches_plain_and_xla_ref(shape, dtype):
    jx, p, args = _args(shape, 0, dtype)
    got = cx.cxblock_split_plain(*args, cx.plan_for(*shape))
    tol = F32 if dtype == "f32" else BF16
    np.testing.assert_allclose(n(got), n(cx.cxblock_plain(*args)), **tol)
    want = np.asarray(jcx._xla_ref(jx, *_jax_args(p), 1e-6), np.float32)
    np.testing.assert_allclose(n(got), want, **tol)
    if dtype == "f32":  # the block's own contribution, not hidden under x
        x = n(args[0])
        np.testing.assert_allclose(n(got) - x, want - x, **tol)


@pytest.mark.parametrize("splits", SPLITS)
def test_split_model_at_every_split_count_matches_plain(splits):
    """Every plan the kernel takes (``--plan`` times them all), at B 1."""
    _, _, args = _args((1, 32, 32), 1, "f32")
    got = cx.cxblock_split_plain(*args, splits)
    want = cx.cxblock_plain(*args)
    np.testing.assert_allclose(n(got), n(want), **F32)
    np.testing.assert_allclose(n(got - args[0]), n(want - args[0]), **F32)


@pytest.mark.parametrize("splits", SPLITS)
def test_blocks_cover_every_token_hidden_unit_and_column_once(splits):
    """plan_blocks walks the grid by the kernel's index arithmetic: every
    in-image token lies in one tile, and within a tile the ranks' hidden
    units and channels (conv and output columns) each cover their axis
    once, in runs of the kernel's chunk and 8-channel group."""
    b, h, w = 2, 12, 20
    blocks = list(cx.plan_blocks(b, h, w, C, F, splits))
    assert len(blocks) == cx.tiles(b, h, w) * splits
    tokens = [(blk["batch"], *tok) for blk in blocks if blk["rank"] == 0 for tok in blk["tokens"]]
    assert sorted(tokens) == [(bi, y, x) for bi in range(b) for y in range(h) for x in range(w)]
    for tile in range(cx.tiles(b, h, w)):
        ranks = [blk for blk in blocks if blk["tile"] == tile]
        assert [blk["rank"] for blk in ranks] == list(range(splits))
        for key, n_, unit in (("hidden", F, cx.F_CHUNK), ("channels", C, cx.GROUP)):
            spans = [blk[key] for blk in ranks]
            assert spans[0][0] == 0 and spans[-1][1] == n_
            assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
            assert all(hi > lo and (hi - lo) % unit == 0 for lo, hi in spans)


@pytest.mark.parametrize("splits", SPLITS)
def test_every_plan_fits_one_block_an_sm(splits):
    """The shared memory the model gives fits a block, and an SM holds one
    (chip_smoke.py holds both against the card's occupancy API)."""
    assert cx.smem_bytes(splits) <= _lib.SMEM_PER_BLOCK
    assert cx.blocks_per_sm(splits) == 1
    assert cx.clusters_at_once(splits) == (_lib.SMS if splits == 1 else _lib.CLUSTERS_AT_ONCE[(splits, 1)])


@pytest.mark.parametrize("shape", [(bsz, 32, 32) for bsz in (1, 2, 3, 4, 6, 8, 12, 16)] + [(2, 16, 16), (1, 12, 20),
                                                                                       (1, 64, 64)])
def test_plan_fills_one_wave_where_the_shape_allows(shape):
    """The pick is the most splits whose clusters all run at once; a plan of
    clusters never has more than the card runs at once; one split where no
    cluster size fits one wave."""
    splits = cx.plan_for(*shape)
    tiles = cx.tiles(*shape)
    one_wave = [s for s in SPLITS if s > 1 and tiles <= cx.clusters_at_once(s)]
    if splits > 1:
        assert tiles <= cx.clusters_at_once(splits)
    assert splits == max(one_wave, default=1)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_picks(shape):
    """B 1 at 32²: 16 tiles; 8 splits would be 16 clusters of 8 where 15 run
    at once, 6 gives 16 of the 17 clusters of 6."""
    assert cx.plan_for(*shape) == PICKS[shape]


@pytest.mark.parametrize("drop", range(PICKS[(1, 32, 32)]))
def test_a_dropped_split_is_caught(drop):
    """The split model combined without one rank's partial fails the check
    chip_smoke.py holds the kernel to."""
    _, _, args = _args((1, 32, 32), 2, "bf16")
    splits = cx.plan_for(1, 32, 32)
    x = n(args[0])
    want = n(cx.cxblock_plain(*args)) - x
    assert np.all(np.abs(n(cx.cxblock_split_plain(*args, splits)) - x - want) <= 0.02 + 0.02 * np.abs(want))
    bad = n(cx.cxblock_split_plain(*args, splits, drop_split=drop)) - x
    assert not np.all(np.abs(bad - want) <= 0.02 + 0.02 * np.abs(want))


def test_split_ranges_refuses_more_splits_than_units():
    with pytest.raises(ValueError):
        cx.split_ranges(C, 33, cx.GROUP)
    assert cx.split_ranges(F, 6, cx.F_CHUNK) == [(0, 128), (128, 320), (320, 512), (512, 640), (640, 832),
                                                (832, 1024)]
