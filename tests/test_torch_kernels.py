"""PyTorch port: the plain versions of the four hand-written kernels against the
JAX package's references and its Pallas kernels (interpret mode on CPU), and
the wrappers' dispatch. Kernel-versus-plain comparisons need a GPU and run in
chip_smoke.py.

Tolerances: 1e-4 relative in f32 (same math, reassociation only); the JAX
kernel tests' 2e-2 in bf16 (rounding points may differ by one ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import fused_ln, fused_mlp
from us_video_medsam2_tpu.kernels import fused_window_attention as jwin
from us_video_medsam2_tpu.ops.attention import sdpa as jax_sdpa
from us_video_medsam2_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_split_plain,
    split_ranges,
)
from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm, layer_norm_plain
from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32), "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}

# (Hp, Wp, ws, nh, q_pool): the nine windowed hiera-t512 blocks
WIN_GEOMETRIES = [
    (128, 128, 8, 1, False),
    (128, 128, 8, 2, True),
    (64, 64, 4, 2, False),
    (64, 64, 4, 4, True),
    (42, 42, 14, 4, False),
    (42, 42, 14, 8, True),
    (21, 21, 7, 8, False),
]
LN_SHAPES = [(16384, 96), (4096, 192), (1024, 384), (256, 768)]
MLP_SHAPES = [(96, 384), (192, 768), (384, 1536), (768, 3072)]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of the dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, t(np.asarray(j.astype(jnp.float32))).to(tdt)


def _close(got, want, dtype):
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **DTYPES[dtype][2])


# ------------------------------------------------------------ window attention
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hp,wp,ws,nh,q_pool", WIN_GEOMETRIES)
def test_window_attention_plain_matches_xla_ref_hd96(hp, wp, ws, nh, q_pool, dtype):
    rng = np.random.default_rng(0)
    # a slice of the rows keeps the larger maps fast while covering every window shape
    rows = min(hp, 2 * ws)
    a = rng.standard_normal((1, rows, wp, 3 * nh * 96)).astype(np.float32)
    jq, tq = _pair(a, dtype)
    want = jwin._xla_ref(jq, ws, nh, 96, q_pool)
    got = window_attention_plain(tq, ws, nh, q_pool)
    assert tuple(got.shape) == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("hp,wp,ws,nh,q_pool", WIN_GEOMETRIES)
def test_window_attention_plain_matches_pallas_interpret_hd128(hp, wp, ws, nh, q_pool):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((1, hp, wp, 3 * nh * 128)).astype(np.float32)
    jq, tq = _pair(a, "bf16")
    want = jwin._run(jq, ws=ws, nh=nh, hd=128, q_pool=q_pool, interpret=True)
    _close(window_attention_plain(tq, ws, nh, q_pool), want, "bf16")


# ------------------------------------------------------------------ layer norm
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d", LN_SHAPES)
def test_layer_norm_plain_matches_xla_ref(rows, d, dtype):
    rng = np.random.default_rng(2)
    rows = min(rows, 512)
    jx, tx = _pair(rng.standard_normal((rows, d)) * 3 + 1, dtype)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    want = fused_ln._xla_ref(jx, jnp.asarray(w), jnp.asarray(b), 1e-6, jx.dtype)
    _close(layer_norm_plain(tx, t(w), t(b), 1e-6), want, dtype)


@pytest.mark.parametrize("rows,d", LN_SHAPES)
def test_layer_norm_plain_matches_pallas_interpret(rows, d):
    rng = np.random.default_rng(3)
    rows = min(rows, 256)
    jx, tx = _pair(rng.standard_normal((rows, d)), "bf16")
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    want = fused_ln._run(jx, jnp.asarray(w), jnp.asarray(b), 1e-6, interpret=True)
    _close(layer_norm_plain(tx, t(w), t(b), 1e-6), want, "bf16")


# ------------------------------------------------------- LN -> MLP -> residual
def _mlp_inputs(d, f, n_tok, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_tok, d)).astype(np.float32)
    p = dict(
        gamma=(1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
        b1=(0.1 * rng.standard_normal(f)).astype(np.float32),
        w2=(rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
    )
    return x, p


def _port_mlp(tx, p, dtype):
    wdt = DTYPES[dtype][1]
    return ln_mlp_residual_plain(tx, t(p["gamma"]), t(p["beta"]), t(p["w1"].T).to(wdt),
                                 t(p["b1"]), t(p["w2"].T).to(wdt), t(p["b2"]), 1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,f", MLP_SHAPES)
def test_ln_mlp_residual_plain_matches_xla_ref(d, f, dtype):
    x, p = _mlp_inputs(d, f, 96, seed=4)
    jx, tx = _pair(x, dtype)
    want = fused_mlp._xla_ref(jx, *(jnp.asarray(p[k]) for k in ("gamma", "beta", "w1", "b1", "w2", "b2")),
                              1e-6, "gelu")
    _close(_port_mlp(tx, p, dtype), want, dtype)


@pytest.mark.parametrize("d,f", MLP_SHAPES[:2])
def test_ln_mlp_residual_plain_matches_pallas_interpret(d, f):
    x, p = _mlp_inputs(d, f, 64, seed=5)
    jx, tx = _pair(x, "bf16")
    want = fused_mlp._run(jx, *(jnp.asarray(p[k]) for k in ("gamma", "beta", "w1", "b1", "w2", "b2")),
                          eps=1e-6, act="gelu", block_n=64, interpret=True)
    _close(_port_mlp(tx, p, "bf16"), want, "bf16")


# ------------------------------------------------------------- flash attention
def _attn_inputs(b, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, 1, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, 1, lk, d)).astype(np.float32)
    mask = rng.random((b, lk)) > 0.3
    mask[:, : lk // 4] = False  # a whole masked block, as invalid memory slots give
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lq,lk,d", [(128, 384, 128), (256, 576, 256)])
def test_flash_plain_matches_jax_sdpa(lq, lk, d, dtype):
    q, k, v, mask = _attn_inputs(2, lq, lk, d, seed=6)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jax_sdpa(jq, jk, jv, key_mask=jnp.asarray(mask))
    _close(flash_attention_plain(tq, tk, tv, t(mask)), want, dtype)
    want_nomask = jax_sdpa(jq, jk, jv)
    _close(flash_attention_plain(tq, tk, tv), want_nomask, dtype)


def test_flash_plain_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    from us_video_medsam2_tpu.kernels import flash_attention as jfa

    q, k, v, mask = _attn_inputs(2, 128, 384, 128, seed=7)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(mask), block_q=128, block_k=128)
    _close(flash_attention_plain(t(q), t(k), t(v), t(mask)), want, "f32")


# (name, splits): the plain model of the kernel's split over keys and its
# combine, at Lk 384 in 64-key tiles (no key padding on the JAX side, so an
# all-masked batch averages the same 384 keys in both)
SPLIT_CASES = [
    ("splits 1", 1),
    ("splits 3", 3),
    ("splits 8", 8),  # 6 tiles: splits 6 and 7 hold no key
    ("a split of keys past Lk only", 4),
    ("a split of masked keys only", 3),
    ("an all-masked batch", 3),
]


@pytest.mark.parametrize("name,splits", SPLIT_CASES)
def test_flash_split_plain_matches_plain_and_pallas_interpret(name, splits):
    from jax.experimental.pallas import tpu as pltpu

    from us_video_medsam2_tpu.kernels import flash_attention as jfa

    lq, lk = 128, 384
    q, k, v, mask = _attn_inputs(2, lq, lk, 128, seed=9)
    mask[:, :] = np.random.default_rng(10).random((2, lk)) > 0.3
    ranges = split_ranges(lk, splits)
    if name == "a split of keys past Lk only":
        assert ranges[-1][0] == ranges[-1][1] == lk
    if name == "a split of masked keys only":
        lo, hi = ranges[1]
        mask[0, lo:hi] = False
        assert mask[0].any() and not mask[0, lo:hi].any()
    if name == "an all-masked batch":
        mask[1] = False
    got = flash_attention_split_plain(t(q), t(k), t(v), t(mask), splits)
    _close(got, flash_attention_plain(t(q), t(k), t(v), t(mask)), "f32")
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_masked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(mask), block_q=128, block_k=128)
    _close(got, want, "f32")


# ------------------------------------------------------------------- wrappers
def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(8)
    before = [w.launches for w in (layer_norm, ln_mlp_residual, window_attention, flash_attention)]
    x = t(rng.standard_normal((64, 96)).astype(np.float32))
    w, b = torch.ones(96), torch.zeros(96)
    assert torch.equal(layer_norm(x, w, b), layer_norm_plain(x, w, b))
    w1, w2 = torch.randn(384, 96) * 0.1, torch.randn(96, 384) * 0.1
    b1, b2 = torch.zeros(384), torch.zeros(96)
    assert torch.equal(ln_mlp_residual(x, w, b, w1, b1, w2, b2),
                       ln_mlp_residual_plain(x, w, b, w1, b1, w2, b2))
    qkv = t(rng.standard_normal((1, 16, 16, 3 * 2 * 96)).astype(np.float32))
    assert torch.equal(window_attention(qkv, 8, 2, True), window_attention_plain(qkv, 8, 2, True))
    q = t(rng.standard_normal((1, 1, 64, 256)).astype(np.float32))
    assert torch.equal(flash_attention(q, q, q), flash_attention_plain(q, q, q))
    after = [w.launches for w in (layer_norm, ln_mlp_residual, window_attention, flash_attention)]
    assert after == before


def test_wrappers_raise_on_other_devices():
    """Off the CPU the wrappers launch their kernel or raise; they never fall
    back to the plain version (a meta tensor stands in for a foreign device)."""
    m = dict(device="meta")
    with pytest.raises(ValueError):
        layer_norm(torch.empty(8, 96, **m), torch.empty(96, **m), torch.empty(96, **m))
    with pytest.raises(ValueError):
        ln_mlp_residual(torch.empty(8, 96, **m), *[torch.empty(1, **m)] * 6)
    with pytest.raises(ValueError):
        window_attention(torch.empty(1, 8, 8, 288, **m), 8, 1, False)
    with pytest.raises(ValueError):
        flash_attention(*[torch.empty(1, 1, 8, 256, **m)] * 3)
