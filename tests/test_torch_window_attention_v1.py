"""PyTorch port: the attention half of a Hiera block in one call
(``kernels/rejected/window_attention_v1.py``, unwired as in the JAX package).

Its plain version against the JAX package's ``_xla_ref`` at the geometries of
``tests/test_rejected_window_attention_v1.py`` and against the Pallas kernel
in interpret mode, the wrapper's gradient against ``jax.vjp`` of ``_xla_ref``
(the JAX custom_vjp's backward), ``split_qkv_params`` against the JAX one,
the plain version against the port's own Hiera attention half, the pad rule
with ``ln_inside`` (a zero pad token is normalised to ``beta``), and the
wrapper's dispatch. The kernel against its plain version needs a GPU and runs
in chip_smoke.py.

Tolerances: f32 1e-4 relative (the same math, reassociated), bf16 the JAX
kernel tests' 2e-2 (rounding points may differ by one ulp); gradients 1e-4
relative L2 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels.rejected import window_attention_v1 as jv1
from us_video_medsam2_tpu.models.hiera import MultiScaleBlock as JaxBlock
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.kernels.rejected.window_attention_v1 import (
    split_qkv_params,
    window_attention_v1,
    window_attention_v1_plain,
)
from us_video_medsam2_tpu_torch.models.hiera import MultiScaleBlock

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
EPS = 1e-6

# (hp, wp, c, heads, co, ws, q_pool, ln_inside): tests/test_rejected_window_attention_v1.py's CASES
CASES = [
    (32, 32, 96, 1, 96, 8, False, True),
    (32, 32, 96, 2, 192, 8, True, False),
    (16, 16, 192, 2, 192, 4, False, True),
    (42, 42, 384, 4, 384, 14, False, True),
    (16, 16, 384, 4, 384, 16, False, True),
    (14, 14, 384, 8, 768, 14, True, False),
]


def _params(rng, c, n_heads, co):
    """gamma, beta, wq, wk, wv, bq, bk, bv, wo, bo as f32 numpy (the JAX test's draws)."""
    dh = co // n_heads
    return [
        (rng.standard_normal((c,)) * 0.1 + 1.0).astype(np.float32),
        (rng.standard_normal((c,)) * 0.1).astype(np.float32),
        *((rng.standard_normal((n_heads, c, dh)) / np.sqrt(c)).astype(np.float32) for _ in range(3)),
        *((rng.standard_normal((n_heads, dh)) * 0.1).astype(np.float32) for _ in range(3)),
        (rng.standard_normal((n_heads, dh, co)) / np.sqrt(dh)).astype(np.float32),
        (rng.standard_normal((co,)) * 0.1).astype(np.float32),
    ]


def _x(rng, b, hp, wp, c, jdt):
    """x drawn in f32 and rounded to the dtype: the same values for both packages."""
    jx = jnp.asarray(rng.standard_normal((b, hp, wp, c)), jdt)
    return jx, t(np.asarray(jx.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hp,wp,c,h,co,ws,q_pool,ln_inside", CASES)
def test_window_attention_v1_plain_matches_xla_ref(hp, wp, c, h, co, ws, q_pool, ln_inside, dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jx, tx = _x(rng, 2, hp, wp, c, jdt)
    p = _params(rng, c, h, co)
    want = np.asarray(jv1._xla_ref(jx, *map(jnp.asarray, p), ws, q_pool, ln_inside, EPS), np.float32)
    got = window_attention_v1_plain(tx.to(tdt), *map(t, p), ws, q_pool, ln_inside, EPS)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), want, **(F32 if dtype == "f32" else BF16))


# no pool with LN, pool without LN, ws 14 with 8 heads and pool
INTERPRET_CASES = [
    (16, 16, 96, 1, 96, 8, False, True),
    (16, 16, 96, 2, 192, 8, True, False),
    (14, 14, 384, 8, 768, 14, True, False),
]


@pytest.mark.parametrize("hp,wp,c,h,co,ws,q_pool,ln_inside", INTERPRET_CASES)
def test_window_attention_v1_plain_matches_pallas_interpret(hp, wp, c, h, co, ws, q_pool, ln_inside):
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, 1, hp, wp, c, jnp.bfloat16)
    p = _params(rng, c, h, co)
    want = jv1._run(jx, *map(jnp.asarray, p), ws=ws, q_pool=q_pool, ln_inside=ln_inside, eps=EPS,
                    interpret=True)
    got = window_attention_v1_plain(tx.to(torch.bfloat16), *map(t, p), ws, q_pool, ln_inside, EPS)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("q_pool,ln_inside", [(False, True), (True, False)])
def test_window_attention_v1_gradient_matches_jax_vjp(q_pool, ln_inside):
    """The wrapper's gradient on the CPU (autograd of the plain version; on
    the card ``_lib.with_plain_grad`` recomputes the same) for x and all ten
    parameters against ``jax.vjp`` of ``_xla_ref``, f32, on a padded map."""
    ws, c, h, co = 4, 96, 2, 192
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 12, c)).astype(np.float32)
    x[:, 6:] = 0.0  # zero pad rows, as a caller pads to whole windows
    p = _params(rng, c, h, co)
    args = [t(a).requires_grad_(True) for a in (x, *p)]
    out = window_attention_v1(*args, ws, q_pool, ln_inside, EPS)
    g = np.cos(np.arange(out.numel(), dtype=np.float32)).reshape(out.shape)
    got = torch.autograd.grad(out, args, torch.from_numpy(g), allow_unused=True)
    got = [torch.zeros_like(a) if d is None else d for a, d in zip(args, got)]  # LN unused
    _, vjp = jax.vjp(lambda *a: jv1._xla_ref(*a, ws, q_pool, ln_inside, EPS), *map(jnp.asarray, (x, *p)))
    want = vjp(jnp.asarray(g))
    names = ["x", "gamma", "beta", "wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo"]
    scale = np.linalg.norm(np.asarray(want[names.index("bq")]))
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        if not ln_inside and name in ("gamma", "beta"):
            assert not np.abs(b).any() and not n(a).any(), name
            continue
        if name == "bk":
            # a bias on k shifts a softmax row by a constant: its gradient is 0 up to rounding
            assert max(np.linalg.norm(n(a)), np.linalg.norm(b)) <= 1e-4 * scale, name
            continue
        rel = np.linalg.norm(n(a) - b) / np.linalg.norm(b)
        assert rel <= 1e-4, f"{name}: gradient rel {rel:.3e}"


def test_split_qkv_params_matches_jax():
    rng = np.random.default_rng(3)
    c, heads, do = 96, 4, 192
    wqkv = rng.standard_normal((c, 3 * do)).astype(np.float32)
    bqkv = rng.standard_normal((3 * do,)).astype(np.float32)
    wproj = rng.standard_normal((do, do)).astype(np.float32)
    want = jv1.split_qkv_params(jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wproj), heads)
    got = split_qkv_params(t(wqkv), t(bqkv), t(wproj), heads)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(n(a), np.asarray(b))


def _block(c, heads, ws, seed):
    """The port's MultiScaleBlock with the weights of a JAX-initialised one
    (drawn again from numpy at the JAX test's scale, biases included)."""
    rng = np.random.default_rng(seed)
    x0 = jnp.zeros((1, 2 * ws, 2 * ws, c), jnp.float32)
    params = JaxBlock(dim=c, dim_out=c, num_heads=heads, window_size=ws).init(jax.random.PRNGKey(0), x0)
    params = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) / np.sqrt(max(p.shape[0], 4)), p.dtype), params)
    block = MultiScaleBlock(c, c, heads, ws, None, 4.0)
    block.load_state_dict(from_jax_params(params), strict=True)
    return block.eval()


def _v1_args(block, heads):
    """The block's norm1 and attention weights in window_attention_v1's layout."""
    a = block.attn
    wq, wk, wv, bq, bk, bv, wo = split_qkv_params(a.qkv.weight.T, a.qkv.bias, a.proj.weight.T, heads)
    return block.norm1.weight, block.norm1.bias, wq, wk, wv, bq, bk, bv, wo, a.proj.bias


@torch.no_grad()
def test_window_attention_v1_plain_matches_port_module_path():
    """As test_xla_ref_matches_module_path: the port's Hiera attention half
    (norm1, then MultiScaleAttention: qkv Linear, window partition, SDPA,
    proj) on an unpadded map equals the one-call form, f32."""
    c, heads, ws = 96, 2, 8
    block = _block(c, heads, ws, seed=4)
    x = t(np.random.default_rng(5).standard_normal((1, 24, 24, c)).astype(np.float32))
    want = block.attn(block.norm1(x), ws)
    got = window_attention_v1_plain(x, *_v1_args(block, heads), ws, False, True, EPS)
    np.testing.assert_allclose(n(got), n(want), **F32)


@torch.no_grad()
def test_window_attention_v1_ln_inside_normalises_pad_tokens_to_beta():
    """With ln_inside, LN runs on the already padded map, so a zero pad token
    enters the projection as ``beta`` (the kernel's ``_ln_f32`` on whole rows,
    ``_xla_ref``): the same as padding the normalised map with ``beta``, and
    not the same as padding it with 0 (the module path pads after LN)."""
    c, heads, ws, real = 96, 2, 8, 20
    block = _block(c, heads, ws, seed=6)
    with torch.no_grad():
        block.norm1.bias.copy_(t(0.5 * np.random.default_rng(7).standard_normal(c).astype(np.float32)))
    xr = t(np.random.default_rng(8).standard_normal((1, real, real, c)).astype(np.float32))
    x = torch.zeros(1, 24, 24, c)
    x[:, :real, :real] = xr
    args = _v1_args(block, heads)
    got = window_attention_v1_plain(x, *args, ws, False, True, EPS)
    y = block.norm1.bias.expand(1, 24, 24, c).clone()
    y[:, :real, :real] = block.norm1(xr)
    np.testing.assert_allclose(n(got), n(window_attention_v1_plain(y, *args, ws, False, False, EPS)), **F32)
    y[:, real:] = 0.0
    y[:, :, real:] = 0.0
    zero_pad = window_attention_v1_plain(y, *args, ws, False, False, EPS)
    assert np.abs(n(got) - n(zero_pad)).max() > 0.1


def test_window_attention_v1_wrapper_dispatch():
    """A CPU tensor takes the plain version without counting a launch; off
    the CPU the wrapper launches its kernels or raises (a meta tensor stands
    in for a foreign device)."""
    rng = np.random.default_rng(9)
    x = t(rng.standard_normal((1, 8, 8, 96)).astype(np.float32))
    p = list(map(t, _params(rng, 96, 1, 96)))
    before = window_attention_v1.launches
    assert torch.equal(window_attention_v1(x, *p, 8, False, True, EPS),
                       window_attention_v1_plain(x, *p, 8, False, True, EPS))
    assert window_attention_v1.launches == before
    m = dict(device="meta")
    with pytest.raises(ValueError):
        window_attention_v1(torch.empty(1, 8, 8, 96, **m), *(torch.empty(a.shape, **m) for a in p),
                            8, False, True, EPS)
