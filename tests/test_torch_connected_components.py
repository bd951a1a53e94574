"""PyTorch port: ops/connected_components.py's exact small-component path on the CPU.

``small_component_mask`` against the JAX function and against cv2's
8-connectivity labelling (the pixels of every component of at most
``max_area`` px, border-touching ones included) on random masks of three
densities; ``fill_holes_in_mask_scores`` and ``remove_small_sprinkles``
against the JAX functions, exactly, on holes and specks placed by hand.
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
