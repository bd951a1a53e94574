"""PyTorch port, temporal fusion: ``models/temporal_fusion.py`` against the
JAX package's modules and the reference fixture, on the CPU at C 32, T 4,
8x8 maps, B 2 (the counterpart of tests/test_temporal_fusion.py).

- Eval (running statistics): TCE, GFTE and ATSF with the fixture's imported
  weights against the reference modules' outputs (rtol 2e-4, atol 2e-5, the
  JAX test's) and against the JAX modules (rtol 1e-5); GP on its JAX init
  weights.
- Training (batch statistics): all four against the JAX modules in output
  and in the gradients of the input and of every parameter (``jax.grad``;
  rel-L2 <= 1e-4 per leaf; the few leaves whose exact gradient is 0 below
  1e-5 of the input gradient's norm on both sides). The random draws are substituted on both sides
  with numpy-made values: GFTE's attention dropout at rate 0 and with one
  keep mask (``jax.random.bernoulli`` / ``gfte_attention_keep``), GP's
  Gumbel noise (``jax.random.gumbel`` / ``gp_gumbel``).
- The identity at T 1 and on a channel mismatch, GFTE's eigenbasis against
  JAX's at T 2-8 and its spectral round trip, and the BatchNorm buffers
  unchanged by a training forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import require_fixture
from tests.torch_port_helpers import n, nchw_to_nhwc, t
from us_video_medsam2_tpu.core.import_torch import convert_fusion_module
from us_video_medsam2_tpu.models import temporal_fusion as jtf
from us_video_medsam2_tpu_torch.core.config import TemporalFusionConfig
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.models import temporal_fusion as ttf

T = 4
C = 32
VARIANTS = ["tce", "gfte", "atsf", "gp"]
GRAD_REL_L2 = 1e-4
# Leaves (or parts) whose exact gradient in training is 0, so that both sides
# hold rounding noise only: a per-channel constant added ahead of a
# batch-statistics BatchNorm (GFTE's conv biases, the attention's output bias
# broadcast over frames and pixels, refine_fc2's bias; GP's pooling bias ahead
# of the bias-free projection), the key third of GFTE's in_proj bias (the
# same shift of every logit of a row) and, without dropout, its value third
# (rows of probabilities sum to 1, so it is such a constant too). Each is held
# below this share of the input gradient's norm on both sides instead.
ZERO_GRAD = {"gfte": {"msdw_3_bias": slice(None), "msdw_5_bias": slice(None), "msdw_7_bias": slice(None),
                      "tattn_out_proj.bias": slice(None), "refine_fc2.bias": slice(None),
                      "tattn_in_proj.bias": slice(C, 2 * C)},
             "gp": {"tpool_bias": slice(None)}}
ZERO_GRAD_OF_INPUT = 1e-5


def _fixture():
    return np.load(require_fixture("temporal_fusion.npz"))


def _fixture_variables(fx, variant):
    sd = {k[len(f"{variant}_sd."):]: fx[k] for k in fx.files if k.startswith(f"{variant}_sd.")}
    params, stats = convert_fusion_module(sd, variant)
    return {"params": params, "batch_stats": stats}


def _init_variables(variant, x, key=0):
    mod = jtf.VARIANTS[variant](channels=C)
    k = jax.random.PRNGKey(key)
    return jax.tree.map(np.asarray, mod.init({"params": k, "dropout": k}, jnp.asarray(x), T, True))


def _variables(variant, x):
    """The fixture's imported weights (GP: its JAX init weights, no fixture)."""
    return _init_variables(variant, x) if variant == "gp" else _fixture_variables(_fixture(), variant)


def _port(variant, variables, **kw):
    mod = ttf.VARIANTS[variant](channels=C, **kw)
    mod.load_state_dict(from_jax_params(variables), strict=True)
    return mod


def _x():
    return nchw_to_nhwc(_fixture()["x"])  # [B·T = 8, 8, 8, 32]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ eval mode
@pytest.mark.parametrize("variant", ["tce", "gfte", "atsf"])
def test_eval_matches_reference_fixture_and_jax(variant):
    fx = _fixture()
    x = nchw_to_nhwc(fx["x"])
    variables = _fixture_variables(fx, variant)
    mod = _port(variant, variables)
    with torch.no_grad():
        got = n(mod(t(x), int(fx["t"]), True))
    np.testing.assert_allclose(got, nchw_to_nhwc(fx[f"{variant}_out"]), rtol=2e-4, atol=2e-5)
    want = np.asarray(jtf.VARIANTS[variant](channels=C).apply(variables, jnp.asarray(x), T, True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gp_eval_matches_jax_on_init_weights():
    x = _x()
    variables = _init_variables("gp", x)
    with torch.no_grad():
        got = n(_port("gp", variables)(t(x), T, True))
    want = np.asarray(jtf.VARIANTS["gp"](channels=C).apply(variables, jnp.asarray(x), T, True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert float(np.abs(got - x).max()) > 1e-3  # the residual is not a no-op


# -------------------------------------------------------------- training mode
def _substitute_draws(monkeypatch, keep=None, gumbel=None):
    """The same numpy-made draws on both sides: GFTE's keep mask [B, 8, T, T]
    and GP's Gumbel noise [B, T]."""
    if keep is not None:
        monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None, **kw: jnp.asarray(keep))
        monkeypatch.setattr(ttf, "gfte_attention_keep",
                            lambda b, h, tt, rate, gen, device: torch.from_numpy(keep).to(device))
    if gumbel is not None:
        monkeypatch.setattr(jax.random, "gumbel", lambda key, shape=(), *a, **kw: jnp.asarray(gumbel))
        monkeypatch.setattr(ttf, "gp_gumbel", lambda b, tt, gen, device: torch.from_numpy(gumbel).to(device))


def _train_case(variant, monkeypatch, dropout):
    """(port module, JAX module, variables, x, cotangent) with the draws fixed."""
    rng = np.random.default_rng(7)
    x = _x()
    variables = _variables(variant, x)
    kw = {}
    if variant == "gfte":
        kw = {"dropout": dropout}
        keep = rng.random((2, 8, T, T)) >= dropout if dropout > 0 else None
        _substitute_draws(monkeypatch, keep=keep)
    if variant == "gp":
        _substitute_draws(monkeypatch, gumbel=rng.gumbel(size=(2, T)).astype(np.float32))
    jmod = jtf.VARIANTS[variant](channels=C, **kw)
    return _port(variant, variables, **kw), jmod, variables, x, rng.standard_normal(x.shape).astype(np.float32)


CASES = [("tce", 0.0), ("gfte", 0.0), ("gfte", 0.1), ("atsf", 0.0), ("gp", 0.0)]


@pytest.mark.parametrize("variant,dropout", CASES, ids=["tce", "gfte_rate0", "gfte_keep_mask", "atsf", "gp"])
def test_train_mode_output_and_every_gradient_match_jax(variant, dropout, monkeypatch):
    mod, jmod, variables, x, w = _train_case(variant, monkeypatch, dropout)

    def loss(params, xx):
        y = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, T, False,
                       rngs={"dropout": jax.random.PRNGKey(3)})
        return jnp.sum(y * w), y

    (_, want), (jg_params, jg_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    y = mod(xt, T, False, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(n(y), np.asarray(want), rtol=1e-5, atol=1e-5)
    (y * t(w)).sum().backward()
    assert _rel_l2(n(xt.grad), np.asarray(jg_x)) <= GRAD_REL_L2
    want_grads = from_jax_params({"params": jg_params})
    named = dict(mod.named_parameters())
    assert set(named) == set(want_grads)
    floor = ZERO_GRAD_OF_INPUT * np.linalg.norm(np.asarray(jg_x))
    zero = dict(ZERO_GRAD.get(variant, {}))
    if variant == "gfte" and dropout == 0.0:
        zero["tattn_in_proj.bias"] = slice(C, 3 * C)
    for name, p in named.items():
        assert p.grad is not None, name
        got, wg = n(p.grad).reshape(-1), want_grads[name].numpy().reshape(-1)
        rows = np.zeros(got.shape, bool)
        if name in zero:
            rows[zero[name]] = True
            assert np.linalg.norm(got[rows]) <= floor and np.linalg.norm(wg[rows]) <= floor, name
        if (~rows).any():
            rel = _rel_l2(got[~rows], wg[~rows])
            assert rel <= GRAD_REL_L2, f"{name}: rel-L2 {rel:.3e}"


@pytest.mark.parametrize("variant", VARIANTS)
def test_batchnorm_buffers_unchanged_by_training(variant):
    x = _x()
    mod = _port(variant, _variables(variant, x))
    before = {k: v.clone() for k, v in mod.named_buffers()}
    assert before and all(k.endswith((".mean", ".var")) for k in before)
    xt = t(x).requires_grad_(True)
    mod(xt, T, False, torch.Generator().manual_seed(0)).square().sum().backward()
    for k, v in mod.named_buffers():
        assert torch.equal(v, before[k]), k
        assert not v.requires_grad
    with torch.no_grad():  # eval reads them: other statistics give other outputs
        y0 = mod(t(x), T, True)
        for v in mod.buffers():
            v.add_(0.5)
        assert not torch.equal(mod(t(x), T, True), y0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_identity_on_one_frame_or_a_channel_mismatch(variant):
    mod = ttf.VARIANTS[variant](channels=C)
    x = torch.randn(2, 8, 8, C)
    assert torch.equal(mod(x, 1, True), x)
    assert torch.equal(mod(x, 1, False), x)
    x_bad = torch.randn(2 * T, 8, 8, C + 1)
    assert torch.equal(mod(x_bad, T, True), x_bad)
    jmod = jtf.VARIANTS[variant](channels=C)
    jx = jnp.asarray(n(x))
    variables = jmod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}, jx, 1, True)
    np.testing.assert_array_equal(np.asarray(jmod.apply(variables, jx, 1, True)), n(x))


# -------------------------------------------------------------- GFTE's basis
@pytest.mark.parametrize("frames", range(2, 9))
def test_gfte_eigenbasis_equals_jax(frames):
    got = ttf._gfte_eigenbasis(frames)
    np.testing.assert_array_equal(got, jtf._gfte_eigenbasis(frames))
    assert got.dtype == np.float32 and got.shape == (frames, frames)


def test_gfte_spectral_roundtrip_is_the_per_channel_gain():
    """U (U^T x) * filt with a frequency-independent filter equals x * filt,
    the identity GFTE's branch (1) is written in."""
    rng = np.random.default_rng(0)
    for frames in (2, 4, 7):
        e = ttf._gfte_eigenbasis(frames).astype(np.float64)
        np.testing.assert_allclose(e @ e.T, np.eye(frames), atol=1e-6)
        x = rng.standard_normal((2, frames, 3, 3, 8)).astype(np.float32)
        filt = rng.standard_normal(8).astype(np.float32)
        literal = np.einsum("tk,bkhwc->bthwc", e, np.einsum("kt,bthwc->bkhwc", e.T, x) * filt)
        np.testing.assert_allclose(literal, x * filt, atol=1e-5)


# -------------------------------------------------------------------- draws
def test_draws_come_from_the_generator():
    """The same generator state gives the same draws; GFTE's mask is the
    dropout hash under a seed drawn from it, GP's noise Gumbel-distributed."""
    from us_video_medsam2_tpu_torch.kernels.flash_dropout import keep_mask

    a = ttf.gfte_attention_keep(2, 8, T, 0.1, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(5)
    seed = int(torch.randint(-(2**31), 2**31, (), generator=g))
    assert torch.equal(a, keep_mask(16, T, T, seed, 0.1).reshape(2, 8, T, T))
    g1 = ttf.gp_gumbel(2, T, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(g1, ttf.gp_gumbel(2, T, torch.Generator().manual_seed(5), "cpu"))
    big = ttf.gp_gumbel(200, 500, torch.Generator().manual_seed(1), "cpu")
    assert big.dtype == torch.float32 and abs(float(big.mean()) - 0.5772) < 0.02  # Euler-Mascheroni


def test_build_temporal_fusion_one_module_a_level():
    assert ttf.build_temporal_fusion(TemporalFusionConfig()) is None
    mods = ttf.build_temporal_fusion(TemporalFusionConfig("gfte", C, 3))
    assert len(mods) == 3 and all(isinstance(m, ttf.GFTE) and m.channels == C for m in mods)
    assert mods[0].dropout == 0.1 and mods[0].num_heads == 8
