"""PyTorch port: ops/connected_components.py on the CPU against the JAX module.

``small_component_mask`` against the JAX function and against cv2's
8-connectivity labelling (the pixels of every component of at most
``max_area`` px, border-touching ones included) on random masks of three
densities; ``fill_holes_in_mask_scores`` and ``remove_small_sprinkles``
against the JAX functions, exactly, on holes and specks placed by hand.
The labeller ``connected_components``: its labels a bijection with JAX's
and with cv2's (in fact JAX's own ids) and its areas equal, converged or
cut short; ``fill_holes_fast`` and both ``method``s of
``fill_holes_in_mask_scores`` bit for bit against JAX on the cases of
tests/test_connected_components.py and on seeded random logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from us_video_medsam2_tpu.ops import connected_components as jcc
from us_video_medsam2_tpu_torch.ops import connected_components as tcc

cv2 = pytest.importorskip("cv2")


def _cv2_small(mask, max_area):
    """Pixels of the 8-connected components of ``mask`` with <= max_area px."""
    n, labels, stats, _ = cv2.connectedComponentsWithStats(mask.astype(np.uint8), connectivity=8)
    small = stats[:, cv2.CC_STAT_AREA] <= max_area
    small[0] = False  # the background label
    return small[labels] & mask


def _masks(seed, density, shape=(3, 48, 56)):
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < density
    m[2] = False
    m[2, 5:30, 4:40] = True  # one ring with a hole
    m[2, 12:20, 12:20] = False
    return m


@pytest.mark.parametrize("max_area", [2, 8])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
def test_small_component_mask_against_jax_and_cv2(seed, density, max_area):
    mask = _masks(seed, density)
    got = tcc.small_component_mask(torch.from_numpy(mask), max_area).numpy()
    want = np.asarray(jcc.small_component_mask(jnp.asarray(mask), max_area))
    np.testing.assert_array_equal(got, want)
    for b in range(mask.shape[0]):
        np.testing.assert_array_equal(got[b], _cv2_small(mask[b], max_area))


def _logits_with_holes(rng):
    logits = rng.uniform(1.0, 3.0, (4, 40, 36)).astype(np.float32)
    logits[:, 10:14, 10:13] = -2.0  # a 12-px hole
    logits[:, 20, 20] = -1.0  # a 1-px hole
    logits[:, 30:32, 5:7] = -1.5  # a 4-px hole
    logits[:, 0, :4] = -3.0  # a 4-px pocket on the border
    return logits


@pytest.mark.parametrize("max_area", [2, 8])
def test_fill_holes_matches_jax(max_area):
    logits = _logits_with_holes(np.random.default_rng(4))
    got = tcc.fill_holes_in_mask_scores(torch.from_numpy(logits), max_area).numpy()
    want = np.asarray(jcc.fill_holes_in_mask_scores(jnp.asarray(logits), max_area))
    np.testing.assert_array_equal(got, want)
    filled = got != logits
    assert filled[:, 20, 20].all()
    assert filled[:, 30:32, 5:7].all() == filled[:, 0, :4].all() == (max_area >= 4)
    assert not filled[:, 10:14, 10:13].any()
    assert (got[filled] == np.float32(0.1)).all()


@pytest.mark.parametrize("max_area", [2, 8])
def test_remove_small_sprinkles_matches_jax(max_area):
    logits = -_logits_with_holes(np.random.default_rng(5))  # the holes become specks
    got = tcc.remove_small_sprinkles(torch.from_numpy(logits), max_area).numpy()
    want = np.asarray(jcc.remove_small_sprinkles(jnp.asarray(logits), max_area))
    np.testing.assert_array_equal(got, want)
    removed = got != logits
    assert removed[:, 20, 20].all() and removed[:, 30:32, 5:7].all() == (max_area >= 4)
    assert not removed[:, 10:14, 10:13].any()
    assert (got[removed] == np.float32(-10.0)).all()


def test_zero_area_leaves_logits_alone():
    logits = torch.from_numpy(_logits_with_holes(np.random.default_rng(6)))
    assert tcc.fill_holes_in_mask_scores(logits, 0) is logits
    assert tcc.remove_small_sprinkles(logits, 0) is logits


# ------------------------------------------------ the labeller, the fast filler
def _bijection(a, b, fg):
    pairs = set(zip(a[fg].tolist(), b[fg].tolist()))
    return len(pairs) == len({x for x, _ in pairs}) == len({y for _, y in pairs})


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
def test_connected_components_matches_jax_and_cv2(seed, density):
    mask = _masks(seed, density, shape=(3, 64, 64))
    labels, areas = (x.numpy() for x in tcc.connected_components(torch.from_numpy(mask)))
    jl, ja = (np.asarray(x) for x in jcc.connected_components(jnp.asarray(mask)))
    assert labels.dtype == areas.dtype == np.int32
    np.testing.assert_array_equal(areas, ja)
    np.testing.assert_array_equal(labels, jl)  # the same ids, not only the same partition
    for b in range(mask.shape[0]):
        assert _bijection(labels[b], jl[b], mask[b])
        n, ref, stats, _ = cv2.connectedComponentsWithStats(mask[b].astype(np.uint8), connectivity=8)
        assert _bijection(labels[b], ref, mask[b]) and len(np.unique(labels[b][mask[b]])) == n - 1
        np.testing.assert_array_equal(areas[b], np.where(mask[b], stats[ref, cv2.CC_STAT_AREA], 0))
        assert (labels[b][~mask[b]] == 0).all() and (labels[b][mask[b]] > 0).all()


@pytest.mark.parametrize("num_iters", [1, 2])
def test_connected_components_cut_short_matches_jax(num_iters):
    """Too few rounds for a 1-px snake: both packages stop at the same labels."""
    mask = np.zeros((1, 40, 40), bool)
    mask[0, 5, 1:39] = True
    mask[0, 5:35, 38] = True
    mask[0, 20:30, 3:9] = True
    labels, areas = (x.numpy() for x in tcc.connected_components(torch.from_numpy(mask), num_iters))
    jl, ja = (np.asarray(x) for x in jcc.connected_components(jnp.asarray(mask), num_iters))
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(areas, ja)
    assert len(np.unique(labels[mask])) > 2  # not converged


def _hole_in_blob():
    mask = -np.ones((1, 32, 32), np.float32)
    mask[0, 8:24, 8:24] = 5.0
    mask[0, 14:16, 14:16] = -3.0  # 4-px hole
    return mask


def _donut():
    mask = -np.ones((1, 64, 64), np.float32)
    mask[0, 6:58, 6:58] = 4.0
    mask[0, 30:42, 30:42] = -2.0  # 12x12 interior pocket
    mask[0, 12:14, 12:14] = -1.5  # small true hole, > 8 px from the pocket
    return mask


def _isolated_holes():
    rng = np.random.default_rng(0)
    mask = -np.ones((2, 64, 64), np.float32) * 3
    mask[:, 8:56, 8:56] = 5.0
    for b in range(2):
        for cy, cx in [(16, 16), (16, 44), (44, 16), (44, 44)]:
            s = int(rng.integers(1, 3))
            mask[b, cy: cy + s, cx: cx + s] = -2.0
    return mask


def _border_pocket():
    mask = np.full((1, 32, 32), 5.0, np.float32)
    mask[0, 0:2, 10:12] = -1.0
    return mask


def _random_logits(seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((2, 1, 64, 64)) < 0.7, rng.uniform(0.5, 3, (2, 1, 64, 64)),
                    rng.uniform(-3, -0.5, (2, 1, 64, 64))).astype(np.float32)


# tests/test_connected_components.py's cases (test_fill_holes, ..._keeps_large_interior_pocket,
# ..._fast_matches_exact_on_isolated_holes, test_exact_fill_holes_fills_border_pockets), then random logits
FILL_CASES = {"hole_in_blob": (_hole_in_blob, (8, 2)), "donut": (_donut, (8,)),
              "isolated_holes": (_isolated_holes, (8,)), "border_pocket": (_border_pocket, (8,)),
              "random_0": (lambda: _random_logits(0), (1, 4, 8)), "random_1": (lambda: _random_logits(1), (2, 6))}


@pytest.mark.parametrize("method", ["fast", "exact"])
@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_fill_holes_methods_match_jax(case, method):
    make, areas = FILL_CASES[case]
    logits = make()
    for max_area in areas + (0,):
        got = tcc.fill_holes_in_mask_scores(torch.from_numpy(logits), max_area, method=method).numpy()
        want = np.asarray(jcc.fill_holes_in_mask_scores(jnp.asarray(logits), max_area, method=method))
        np.testing.assert_array_equal(got, want, err_msg=f"max_area {max_area}")
        if method == "fast":
            direct = tcc.fill_holes_fast(torch.from_numpy(logits), max_area).numpy()
            np.testing.assert_array_equal(direct, want)
            np.testing.assert_array_equal(direct, np.asarray(jcc.fill_holes_fast(jnp.asarray(logits), max_area)))


def test_fill_holes_fast_cases():
    """The JAX tests' expectations, on the port: the 4-px hole filled at 8
    and kept at 2, the donut's pocket kept, the fast filler equal to the
    exact one on isolated holes and leaving a border pocket unfilled."""
    fast = tcc.fill_holes_fast
    out = fast(torch.from_numpy(_hole_in_blob()), 8).numpy()
    assert (out[0, 14:16, 14:16] == np.float32(0.1)).all() and out[0, 0, 0] == -1.0
    assert (fast(torch.from_numpy(_hole_in_blob()), 2).numpy()[0, 14:16, 14:16] == -3.0).all()
    out = fast(torch.from_numpy(_donut()), 8).numpy()
    assert (out[0, 30:42, 30:42] == -2.0).all() and (out[0, 12:14, 12:14] == np.float32(0.1)).all()
    iso = torch.from_numpy(_isolated_holes())
    np.testing.assert_array_equal(fast(iso, 8).numpy(), tcc.fill_holes_in_mask_scores(iso, 8).numpy())
    border = torch.from_numpy(_border_pocket())
    assert (fast(border, 8).numpy()[0, 0:2, 10:12] == -1.0).all()
    assert (tcc.fill_holes_in_mask_scores(border, 8).numpy()[0, 0:2, 10:12] == np.float32(0.1)).all()


def test_fill_holes_fast_flood_iters():
    """A pocket reached from the border only through a winding corridor
    longer than ``flood_iters`` dilations counts as a pocket, as in JAX."""
    logits = np.full((1, 24, 24), 2.0, np.float32)
    logits[0, 1:23, 1] = logits[0, 22, 1:23] = -1.0  # an L-shaped corridor from the border at (0, 1)
    logits[0, 0, 1] = -1.0
    for it in (4, 256):
        got = tcc.fill_holes_fast(torch.from_numpy(logits), 8, flood_iters=it).numpy()
        want = np.asarray(jcc.fill_holes_fast(jnp.asarray(logits), 8, flood_iters=it))
        np.testing.assert_array_equal(got, want)
