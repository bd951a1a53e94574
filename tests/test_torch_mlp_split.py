"""PyTorch port: the plain model of the ln_mlp_residual kernel's split of the
hidden axis across blocks (``ln_mlp_residual_split_plain``) against the JAX
package's ``_xla_ref`` and its Pallas kernel's own chunked W2 contraction
(``fused_mlp._run(..., f_chunks=k, interpret=True)``), and the properties of
``mlp_splits``. The kernel itself is held against the same model on the card
by chip_smoke.py.

Tolerances: 1e-4 relative in f32 (the split only reassociates f32 sums); the
JAX kernel tests' 2e-2 in bf16. The Pallas kernel evaluates GELU with a
polynomial erf (|err| <= 1.3e-4, ``fused_mlp._erf_pallas``), which alone
moves an f32 output by ~5e-5; the f32 cases swap in ``jax.lax.erf`` for the
call, so that they see the split and not the polynomial. The bf16 cases run
the Pallas kernel as it is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import _mlp_inputs
from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import fused_mlp
from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import (
    BLOCK_M,
    BLOCKS_PER_SM,
    HIDDEN_CHUNK,
    SMS,
    combine_partials,
    ln_mlp_residual_plain,
    ln_mlp_residual_split_partials,
    ln_mlp_residual_split_plain,
    mlp_splits,
    split_ranges,
)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32), "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
PARAMS = ("gamma", "beta", "w1", "b1", "w2", "b2")

# (N, D, F) the main path gives the kernel: sam2.1_hiera_t512's four stages
# (EfficientMedSAM-S runs the third), the training path's T·B = 4 frames, and
# an off-path shape with a ragged last token tile
T512_SHAPES = [(16384, 96, 384), (4096, 192, 768), (1024, 384, 1536), (256, 768, 3072)]
TRAIN_SHAPES = [(4 * n_, d, f) for n_, d, f in T512_SHAPES]
EDGE_SHAPES = [(1000, 192, 768), (1005, 384, 1536)]

# the narrow-width model runs in chunks of 16 hidden units, so that it can
# take as many splits as the kernel picks at the full-width shapes
NARROW_CHUNK = 16
SPLIT_CASES = [("splits 1", 1), ("splits 2", 2), ("splits 3", 3)] + [
    (f"pick at ({n_},{d},{f})", mlp_splits(n_, d, f)) for n_, d, f in T512_SHAPES
]


def _port_args(x, p, dtype):
    """The port's arguments (Linear layout), x and the weights in ``dtype``
    with the values JAX rounds them to."""
    jdt, tdt, _ = DTYPES[dtype]
    tx = t(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))).to(tdt)
    return (tx, t(p["gamma"]), t(p["beta"]), t(p["w1"].T).to(tdt), t(p["b1"]), t(p["w2"].T).to(tdt),
            t(p["b2"]))


def _jax_refs(x, p, dtype, f_chunks, monkeypatch):
    """(_xla_ref, the Pallas kernel in interpret mode with ``f_chunks``)."""
    jx = jnp.asarray(x, DTYPES[dtype][0])
    jp = [jnp.asarray(p[k]) for k in PARAMS]
    ref = fused_mlp._xla_ref(jx, *jp, 1e-6, "gelu")
    if dtype == "f32":
        monkeypatch.setattr(fused_mlp, "_erf_pallas", jax.lax.erf)
    pallas = fused_mlp._run(jx, *jp, eps=1e-6, act="gelu", block_n=64, f_chunks=f_chunks, interpret=True)
    return ref, pallas


def _close(got, want, dtype):
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,splits", SPLIT_CASES)
@pytest.mark.parametrize("d", [96, 192])
def test_split_plain_matches_xla_ref_and_pallas_f_chunks(d, name, splits, dtype, monkeypatch):
    f = 4 * d
    x, p = _mlp_inputs(d, f, 96, seed=11)
    # the Pallas kernel takes F in f_chunks equal chunks: its own split where it divides F
    f_chunks = splits if f % splits == 0 else 1
    ref, pallas = _jax_refs(x, p, dtype, f_chunks, monkeypatch)
    got = ln_mlp_residual_split_plain(*_port_args(x, p, dtype), splits, 1e-6, NARROW_CHUNK)
    _close(got, ref, dtype)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [96, 192])
def test_split_plain_in_the_kernels_own_chunks(d, dtype, monkeypatch):
    """Three splits of the kernel's 64-unit chunks (6 at D 96, 12 at D 192)."""
    f = 4 * d
    assert f // HIDDEN_CHUNK[d] >= 3
    x, p = _mlp_inputs(d, f, 64, seed=12)
    ref, pallas = _jax_refs(x, p, dtype, 3, monkeypatch)
    got = ln_mlp_residual_split_plain(*_port_args(x, p, dtype), 3)
    _close(got, ref, dtype)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_plain_ragged_token_count(dtype, monkeypatch):
    """N 1005: the last token tile holds 45 of 64 rows; the split the kernel
    picks there (16 tiles: 8 splits of 3 chunks at D 384, where one SM holds
    one block)."""
    d, f = 384, 1536
    splits = mlp_splits(1005, d, f)
    assert splits == 8
    x, p = _mlp_inputs(d, f, 1005, seed=13)
    ref, pallas = _jax_refs(x, p, dtype, 3, monkeypatch)
    got = ln_mlp_residual_split_plain(*_port_args(x, p, dtype), splits)
    _close(got, ref, dtype)
    _close(got, pallas, dtype)


def test_one_split_is_the_plain_version_bit_for_bit():
    x, p = _mlp_inputs(96, 384, 80, seed=14)
    args = _port_args(x, p, "bf16")
    assert torch.equal(ln_mlp_residual_split_plain(*args, 1), ln_mlp_residual_plain(*args))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a_combine_without_one_split_is_rejected(dtype):
    """The comparison the card's check makes must see a combine that leaves
    out one split's partial."""
    x, p = _mlp_inputs(192, 768, 96, seed=15)
    args = _port_args(x, p, dtype)
    parts = ln_mlp_residual_split_partials(*args[:6], 9)
    assert parts.shape == (9, 96, 192) and parts.dtype == torch.float32
    want = n(ln_mlp_residual_plain(*args))
    _close(combine_partials(args[0], parts, args[6]), want, dtype)
    with pytest.raises(AssertionError):
        _close(combine_partials(args[0], parts[1:], args[6]), want, dtype)


# ---------------------------------------------------------------- mlp_splits
@pytest.mark.parametrize("shape", T512_SHAPES + TRAIN_SHAPES + EDGE_SHAPES)
def test_mlp_splits_fill_one_wave_of_blocks(shape):
    """The (token tile, split) grid fits in one wave of SMS x BLOCKS_PER_SM
    blocks, and one split more would not (or every chunk has its own split,
    or the token tiles alone fill the wave)."""
    n_tok, d, f = shape
    splits = mlp_splits(n_tok, d, f)
    tiles = -(-n_tok // BLOCK_M[d])
    wave = SMS * BLOCKS_PER_SM[d]
    assert 1 <= splits <= f // HIDDEN_CHUNK[d]
    if splits > 1:
        assert tiles * splits <= wave
    assert tiles * (splits + 1) > wave or splits == f // HIDDEN_CHUNK[d]


@pytest.mark.parametrize("shape", T512_SHAPES)
def test_mlp_splits_leave_no_sm_idle_that_a_split_could_fill(shape):
    """At t512's shapes the grid reaches the SMs (132 or more blocks) or
    falls short of them by less than one split's token tiles."""
    n_tok, d, f = shape
    tiles = -(-n_tok // BLOCK_M[d])
    assert tiles * mlp_splits(n_tok, d, f) > SMS - tiles


def test_mlp_splits_picks():
    """The splits the sweep on an H100 found fastest (tools/torch_mlp_splits_sweep.py)."""
    assert [mlp_splits(*s) for s in T512_SHAPES] == [1, 4, 8, 16]
    assert [mlp_splits(*s) for s in TRAIN_SHAPES] == [1, 1, 2, 4]


def test_mlp_splits_one_where_the_token_tiles_fill_the_card():
    assert mlp_splits(16384, 96, 384) == 1
    assert mlp_splits(16384, 192, 768) == 1  # the training path's stage 2
    assert mlp_splits(0, 96, 384) == 1


@pytest.mark.parametrize("shape", T512_SHAPES)
def test_mlp_splits_fewer_at_the_training_token_counts(shape):
    n_tok, d, f = shape
    assert mlp_splits(4 * n_tok, d, f) <= mlp_splits(n_tok, d, f)


@pytest.mark.parametrize("shape", T512_SHAPES + TRAIN_SHAPES + EDGE_SHAPES)
def test_split_ranges_take_every_chunk_exactly_once(shape):
    n_tok, d, f = shape
    splits = mlp_splits(n_tok, d, f)
    chunk = HIDDEN_CHUNK[d]
    ranges = split_ranges(f, splits, chunk)
    assert len(ranges) == splits
    covered = [c for lo, hi in ranges for c in range(lo // chunk, hi // chunk)]
    assert covered == list(range(f // chunk))
    assert all(hi > lo and lo % chunk == 0 and hi % chunk == 0 for lo, hi in ranges)


def test_split_ranges_refuse_more_splits_than_chunks():
    with pytest.raises(ValueError):
        split_ranges(384, 7, 64)
    with pytest.raises(ValueError):
        split_ranges(390, 1, 64)
