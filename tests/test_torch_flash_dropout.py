"""PyTorch port: dropout flash attention (training) against the JAX package.

The keep mask must be bit-identical to ``keep_mask_reference`` (no
tolerance), including where the int32 element index wraps past 2^31 and
2^32. The plain forward (out, lse) is held against the JAX kernel run in
Pallas interpret mode, in f32, to 1e-5 absolute (the same math: the kernel
accumulates the softmax online in tiles, the plain version in one pass), and
dq/dk/dv from autograd of the plain version against ``jax.grad`` through the
JAX custom_vjp (its backward kernel, interpret mode) to 1e-4 relative per
gradient. The plain model of the backward kernels' split over queries and
keys (``flash_dropout_bwd_split_plain``) is held against both at every
split case. The kernels themselves need a GPU and are held against the
plain version in chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import flash_dropout as jfd
from us_video_medsam2_tpu_torch.kernels import flash_dropout as tfd


@pytest.mark.parametrize("bh,lq,lk,seed,rate", [
    (3, 17, 33, 42, 0.1), (2, 64, 100, -7, 0.1), (1, 32, 48, 2**31 - 1, 0.5), (2, 8, 16, 5, 0.0),
])
def test_keep_mask_is_bit_identical_to_jax(bh, lq, lk, seed, rate):
    want = np.asarray(jfd.keep_mask_reference(bh, lq, lk, seed, rate))
    got = tfd.keep_mask(bh, lq, lk, seed, rate).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", [205, 409])  # index passes 2^31, and 2^32
def test_keep_mask_wraps_as_int32_index(i):
    lq, lk, q0, k0, bq, bk, seed, rate = 1024, 10268, 512, 4096, 64, 256, 123, 0.1
    idx0 = (i * lq + q0) * lk + k0
    assert idx0 > (2**31 if i == 205 else 2**32)
    want = np.asarray(jfd._tile_keep(jnp.int32(i), q0, k0, bq, bk, lq, lk, jnp.int32(seed),
                                     jfd._thr_i32(rate)))
    q = torch.arange(q0, q0 + bq)[:, None]
    k = torch.arange(k0, k0 + bk)[None, :]
    got = tfd.keep_from_index((i * lq + q) * lk + k, seed, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.85 < got.mean() < 0.95


def _inputs(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d))
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    mask = rng.random((b, lk)) > 0.3
    mask[:, : lk // 4] = False  # a masked run, as invalid memory slots give
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_forward_matches_jax_kernel(rate, masked):
    q, k, v, mask = _inputs(2, 1, 96, 160, 64, seed=1)
    m = mask if masked else None
    out, lse = jfd._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None if m is None else jnp.asarray(m), 11, rate, 32, 64, True)
    tm = None if m is None else t(m)
    got_out, got_lse = tfd.flash_attention_train_plain(t(q), t(k), t(v), tm, 11, rate)
    np.testing.assert_allclose(n(got_out), np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(got_lse), np.asarray(lse)[:, :96, 0].reshape(2, 1, 96), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_gradients_match_jax_kernel(rate):
    q, k, v, mask = _inputs(1, 2, 72, 136, 64, seed=2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def loss(qq, kk, vv):
        out = jfd.flash_attention_train(qq, kk, vv, jnp.asarray(mask), 5, rate, 32, 64, True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out = tfd.flash_attention_train(tq, tk, tv, t(mask), 5, rate)  # CPU: the plain version
    (out * t(g)).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        rel = np.linalg.norm(n(got) - w) / np.linalg.norm(w)
        assert rel <= 1e-4, f"d{name}: rel {rel:.3e}"


def test_fully_masked_batch_is_finite():
    q, k, v, mask = _inputs(2, 1, 16, 40, 32, seed=4)
    mask[1] = False
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tfd.flash_attention_train_plain(tq, tk, tv, t(mask), 9, 0.1)
    out.square().sum().backward()
    for x in (out, lse, tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(x).all()
    # every key masked: uniform attention over all Lk keys, then the dropout
    keep = tfd.keep_mask(2, 16, 40, 9, 0.1).reshape(2, 1, 16, 40)[1:]
    want = torch.matmul(keep.float() / 40 / 0.9, t(v)[1:])
    torch.testing.assert_close(out[1:].detach(), want, rtol=1e-5, atol=1e-6)


def test_wrappers_take_the_plain_version_on_cpu_and_raise_elsewhere():
    before = (tfd.flash_dropout_fwd.launches, tfd.flash_dropout_bwd.launches)
    q, k, v, mask = _inputs(1, 1, 8, 24, 256, seed=5)
    got = tfd.flash_attention_train(t(q), t(k), t(v), t(mask), 1, 0.1)
    assert torch.equal(got, tfd.flash_attention_train_plain(t(q), t(k), t(v), t(mask), 1, 0.1)[0])
    assert (tfd.flash_dropout_fwd.launches, tfd.flash_dropout_bwd.launches) == before
    meta = [torch.empty(1, 1, 8, 256, device="meta")] * 3
    with pytest.raises(ValueError):
        tfd.flash_attention_train(*meta, None, 1, 0.1)
    with pytest.raises(ValueError):
        tfd.flash_dropout_bwd(*meta, None, 1, 0.1, meta[0], torch.empty(1, 1, 8, device="meta"), meta[0])


# (name, q_splits, k_splits): the plain model of the backward kernels' split
# over queries (dk, dv) and keys (dq), at Lq 200 and Lk 300 in 64-row tiles:
# ragged last tiles and ranges, and a query range past Lq at (3, 2)
BWD_SPLIT_CASES = [
    ("splits 1 1", 1, 1),
    ("splits 3 2", 3, 2),
    ("splits 2 5, last ranges ragged", 2, 5),
    ("a key range of masked keys only", 2, 5),
    ("a batch with every key masked", 3, 2),
]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name,q_splits,k_splits", BWD_SPLIT_CASES)
def test_bwd_split_plain_matches_jax_kernel_and_autograd(name, q_splits, k_splits, rate):
    """f32, so the model's roundings of P·keep and dS are exact: its sums over
    the splits against autograd of the plain version and ``jax.grad`` through
    the JAX kernel (interpret mode), 1e-4 relative per gradient. On a batch
    whose keys are all masked the JAX backward recomputes P = exp(0) = 1 at
    the -1e30 floor instead of its forward's 1/Lk, so that batch is held
    against autograd alone."""
    from us_video_medsam2_tpu_torch.kernels.flash_attention import split_ranges

    b, h, lq, lk, d = 2, 1, 200, 300, 64
    q, k, v, mask = _inputs(b, h, lq, lk, d, seed=6)
    if name == "a key range of masked keys only":
        lo, hi = split_ranges(lk, k_splits, tfd.BLOCK)[1]
        mask[0, lo:hi] = False
        assert mask[0].any() and not mask[0, lo:hi].any()
    all_masked = name == "a batch with every key masked"
    if all_masked:
        mask[1] = False
    go = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    seed = 13

    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tfd.flash_attention_train_plain(tq, tk, tv, t(mask), seed, rate)
    out.backward(t(go))
    got = tfd.flash_dropout_bwd_split_plain(t(q), t(k), t(v), t(mask), seed, rate, out.detach(),
                                            lse.detach(), t(go), q_splits, k_splits)

    def loss(qq, kk, vv):
        o = jfd.flash_attention_train(qq, kk, vv, jnp.asarray(mask), seed, rate, 32, 64, True)
        return jnp.sum(o * jnp.asarray(go))

    want_jax = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jax_rows = slice(0, 1) if all_masked else slice(None)
    for gname, g, w_auto, w_jax in zip(("dq", "dk", "dv"), got, (tq.grad, tk.grad, tv.grad), want_jax):
        assert torch.isfinite(g).all()
        for ref, rows, label in ((n(w_auto), slice(None), "autograd"), (np.asarray(w_jax), jax_rows, "jax")):
            w = ref[rows]
            rel = np.linalg.norm(n(g)[rows] - w) / np.linalg.norm(w)
            assert rel <= 1e-4, f"{gname} vs {label}: rel {rel:.3e}"


def test_bwd_splits_fill_the_card_from_the_shape():
    assert tfd.bwd_splits(3, 1024, 1024) == (2, 2)  # 48-block grids at the training self-attention
    # 483 dk/dv blocks already fill the card; each walks 16 query tiles, so
    # the dq blocks walk at most 16 of the 161 key tiles
    assert tfd.bwd_splits(3, 1024, 10268) == (1, 11)
    assert tfd.bwd_splits(260, 4096, 4096) == (1, 1)
    assert tfd.bwd_splits(1, 1000, 1100) == (7, 6)  # 18 key tiles x 7; walks of 3 tiles
    assert tfd.bwd_splits(8, 1024, 1000) == (1, 1)
