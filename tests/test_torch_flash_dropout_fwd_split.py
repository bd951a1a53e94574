"""PyTorch port: the dropout-flash forward's split over key tiles and its combine.

The CUDA forward deals the key tiles out to splits in turn (tile t to split
t mod S, ``fwd_split_tiles``), S from the shape alone (``fwd_splits``); each
split's block skips its tiles with no valid key when the batch has one and
writes its O, running max and sum, and a combine kernel writes out and lse
from them in split order. ``flash_dropout_fwd_split_plain`` is the plain
model of that. It is held here, in f32, against the JAX kernel's forward
(``_fwd_call`` in Pallas interpret mode, as the JAX package's tests run it
on the CPU) and against ``flash_attention_train_plain``, to 1e-5 absolute on
out and lse (the same math; the sums run in another order). The kernel
itself needs a GPU and is held against both in chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import flash_dropout as jfd
from us_video_medsam2_tpu_torch.kernels import flash_dropout as tfd
from us_video_medsam2_tpu_torch.kernels.flash_attention import split_ranges

ATOL = 1e-5


def _inputs(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    mask = rng.random((b, lk)) > 0.3
    mask[:, 64:128] = False  # one masked tile, as an invalid memory slot gives
    return q, k, v, mask


# (name, Lk, splits): at 64-key tiles Lk 300 has 5 tiles, its last one ragged
FWD_SPLIT_CASES = [
    ("one split, no mask", 300, 1),
    ("ragged last ranges", 300, 3),  # tiles {0, 3}, {1, 4}, {2}
    ("a split whose tiles are all masked", 300, 2),  # split 1: tiles 1 and 3
    ("a split with no tile", 300, 7),  # splits 5 and 6 take none
    ("a batch with no valid key", 300, 3),
    ("Lk past a tile edge", 257, 2),  # tile 4 holds one key
]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name,lk,splits", FWD_SPLIT_CASES)
def test_fwd_split_plain_matches_jax_kernel_and_plain(name, lk, splits, rate):
    """out and lse of the split model against the JAX forward and the plain
    version, 1e-5 absolute in f32. On a batch whose keys are all masked the
    JAX kernel scores its pad keys (Lk up to the 64-key tile) -1e30 too, so
    its uniform average runs over the padded Lk: that batch is held against
    the plain version alone."""
    b, h, lq, d, seed = 2, 1, 64, 64, 17
    q, k, v, mask = _inputs(b, h, lq, lk, d, seed=3)
    tiles = tfd.fwd_split_tiles(lk, splits)
    if name == "a split whose tiles are all masked":
        for tile in tiles[1]:
            mask[0, tile * 64: (tile + 1) * 64] = False
        assert mask[0].any()
    if name == "a split with no tile":
        assert [len(x) for x in tiles] == [1, 1, 1, 1, 1, 0, 0]
    if name == "ragged last ranges":
        assert [len(x) for x in tiles] == [2, 2, 1] and lk % 64
    all_masked = name == "a batch with no valid key"
    if all_masked:
        mask[1] = False
    m = None if name == "one split, no mask" else mask
    tm = None if m is None else t(m)

    got_out, got_lse = tfd.flash_dropout_fwd_split_plain(t(q), t(k), t(v), tm, seed, rate, splits)
    plain_out, plain_lse = tfd.flash_attention_train_plain(t(q), t(k), t(v), tm, seed, rate)
    out, lse = jfd._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if m is None else jnp.asarray(m), seed, rate, 32, 64, True)
    jax_out, jax_lse = np.asarray(out), np.asarray(lse)[:, :lq, 0].reshape(b, h, lq)
    for x in (got_out, got_lse):
        assert torch.isfinite(x).all()
    np.testing.assert_allclose(n(got_out), n(plain_out), rtol=0, atol=ATOL)
    np.testing.assert_allclose(n(got_lse), n(plain_lse), rtol=0, atol=ATOL)
    rows = slice(0, 1) if all_masked else slice(None)
    np.testing.assert_allclose(n(got_out)[rows], jax_out[rows], rtol=0, atol=ATOL)
    np.testing.assert_allclose(n(got_lse)[rows], jax_lse[rows], rtol=0, atol=ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fwd_split_partials_skip_masked_tiles_and_combine_needs_every_part(rate):
    """A split of masked tiles beside valid ones attends nothing (m -inf,
    l 0, O 0); the combine without one split's partial, or without the
    exp(m_i - m) weights, no longer gives the plain version."""
    q, k, v, mask = _inputs(1, 1, 32, 300, 64, seed=5)
    for tile in tfd.fwd_split_tiles(300, 3)[1]:
        mask[0, tile * 64: (tile + 1) * 64] = False
    o, m, l = tfd.flash_dropout_fwd_split_partials(t(q), t(k), t(v), t(mask), 3, rate, 3)
    assert torch.all(m[1] == float("-inf")) and torch.all(l[1] == 0) and torch.all(o[1] == 0)
    want, want_lse = tfd.flash_attention_train_plain(t(q), t(k), t(v), t(mask), 3, rate)
    out, lse = tfd.combine_fwd_partials(o, m, l, torch.float32)
    np.testing.assert_allclose(n(out), n(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(n(lse), n(want_lse), rtol=0, atol=ATOL)
    dropped, _ = tfd.combine_fwd_partials(o[1:], m[1:], l[1:], torch.float32)  # split 0 left out
    unweighted = o.sum(0) / l.sum(0).clamp_min(1e-30)[..., None]  # w_i = 1
    for bad in (dropped, unweighted):
        assert (bad - want).norm() / want.norm() > 0.1


def _training_cross_mask(objects=3, frames=4):
    """The memory cross-attention key mask of the training path's last tracked
    frame (frames 0..T-2 in the bank, frame 0 conditioning) at
    ``sam2.1_hiera_t512``: [O, Lk] bool, Lk 10,268, 3,084 valid."""
    from us_video_medsam2_tpu_torch.core.config import resolve_config
    from us_video_medsam2_tpu_torch.models.memory_bank import init_memory_bank, select_memories

    c = resolve_config("sam2.1_hiera_t512")
    bank = init_memory_bank(objects, frames, 1, 1, 1)
    bank.valid[:, : frames - 1] = True
    bank.is_cond[:, 0] = True
    sel = select_memories(bank, frames - 1, c, frames, is_training=True)
    return torch.cat([sel.mem_valid.repeat_interleave(c.feat_size**2, 1),
                      sel.ptr_valid.repeat_interleave(c.tokens_per_obj_ptr, 1)], 1)


def test_fwd_splits_fill_one_wave_from_the_shape():
    """At the training shapes (B·H 3, Lq 1024) the grid fills one wave of the
    card's 132 SMs at one block an SM: no more splits fit, and no fewer give
    as short a longest split."""
    for lk, want in ((1024, 4), (10268, 5)):
        splits = tfd.fwd_splits(3, 1024, lk)
        assert splits == want
        q_tiles, k_tiles = 1024 // tfd.FWD_BLOCK_Q, -(-lk // 64)
        most = tfd.TARGET_BLOCKS * tfd.FWD_BLOCKS_PER_SM // (3 * q_tiles)
        assert 3 * q_tiles * most <= tfd.TARGET_BLOCKS < 3 * q_tiles * (most + 1)
        assert splits <= most and -(-k_tiles // splits) == -(-k_tiles // most)
        assert -(-k_tiles // (splits - 1)) > -(-k_tiles // most)
    assert tfd.fwd_splits(260, 4096, 4096) == 1  # 8,320 query tiles already fill the card
    assert tfd.fwd_splits(4, 1000, 1100) == 4  # 32 blocks a split: 4 splits fit
    assert tfd.fwd_splits(1, 128, 100) == 2  # at most one split a key tile


@pytest.mark.parametrize("lk,splits", [(10268, 5), (1024, 4), (300, 7), (257, 2), (64, 1)])
def test_fwd_split_tiles_cover_every_tile_once(lk, splits):
    tiles = tfd.fwd_split_tiles(lk, splits)
    assert len(tiles) == splits
    assert sorted(x for part in tiles for x in part) == list(range(-(-lk // 64)))
    assert max(map(len, tiles)) - min(map(len, tiles)) <= 1


def test_fwd_split_tiles_balance_the_valid_tiles_of_a_memory_bank():
    """At the training cross shape the 49 valid tiles of 161 fall 11 / 9 / 9 /
    10 / 10 on the five splits, where contiguous ranges of tiles would give
    16 / 0 / 0 / 4 / 29; the attended keys are those of the valid tiles, each
    in exactly one split."""
    mask = _training_cross_mask()
    assert mask.shape == (3, 10268) and int(mask[0].sum()) == 3084
    splits = tfd.fwd_splits(3, 1024, 10268)
    k_tiles = -(-10268 // 64)
    valid = torch.nn.functional.pad(mask[0], (0, k_tiles * 64 - 10268)).reshape(k_tiles, 64).any(-1)
    dealt = [int(valid[x].sum()) for x in tfd.fwd_split_tiles(10268, splits)]
    ranges = [int(valid[lo // 64: -(-hi // 64)].sum()) for lo, hi in split_ranges(10268, splits, 64)]
    assert sum(dealt) == int(valid.sum()) == 49
    assert max(dealt) - min(dealt) <= 2 and max(dealt) == 11
    assert max(ranges) == 29
    att = tfd.fwd_attended_keys(mask, 3, 10268, splits)
    assert torch.equal(att.sum(0), valid.repeat_interleave(64)[:10268].expand(3, -1).long())
