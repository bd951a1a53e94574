"""PyTorch port: the qkv projection inside the window-attention kernel
(``qkv_window_attention``).

Its plain version against the JAX package's ``_xla_ref_qkv`` and its Pallas
kernel ``_run_qkv`` (interpret mode on the CPU), the Hiera attention module
with ``US_MEDSAM2_FUSE_QKV_WINDOW_ATTN`` set against the same module unset,
the wrapper's gradient against the JAX custom_vjp's, and its dispatch. The
kernel against its plain version needs a GPU and runs in chip_smoke.py.

Tolerances: f32 1e-4 relative (the same math, reassociated), bf16 the JAX
kernel tests' 2e-2 (rounding points may differ by one ulp); the module with
the switch set against unset 1e-5 in f32 (the same function: a zero-padded
map projected in full, against the unpadded map projected and its pad filled
with the bias); gradients 1e-4 relative L2 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import fused_window_attention as jwin
from us_video_medsam2_tpu_torch.kernels.qkv_window_attention import (
    qkv_window_attention,
    qkv_window_attention_plain,
)
from us_video_medsam2_tpu_torch.models import hiera as hiera_mod

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (Hp, Wp, ws, nh, q_pool, Cin): the nine windowed hiera-t512 blocks with the
# fused projection
GEOMETRIES = [
    (128, 128, 8, 1, False, 96),
    (128, 128, 8, 2, True, 96),
    (64, 64, 4, 2, False, 192),
    (64, 64, 4, 4, True, 192),
    (42, 42, 14, 4, False, 384),
    (42, 42, 14, 8, True, 384),
    (21, 21, 7, 8, False, 768),
]


def _inputs(b, rows, wp, cin, c, seed):
    """y [b, rows, wp, cin], w in JAX's [Cin, C] layout, f32 bias [C]."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, rows, wp, cin)).astype(np.float32)
    w = (rng.standard_normal((cin, c)) * cin**-0.5).astype(np.float32)
    bias = (0.5 * rng.standard_normal(c)).astype(np.float32)
    return y, w, bias


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin", GEOMETRIES)
def test_qkv_window_attention_plain_matches_xla_ref_hd96(hp, wp, ws, nh, q_pool, cin, dtype):
    # a slice of the rows keeps the larger maps fast while covering every window shape
    rows = min(hp, 2 * ws)
    y, w, b = _inputs(1, rows, wp, cin, 3 * nh * 96, seed=0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jy, jw = jnp.asarray(y, jdt), jnp.asarray(w, jdt)
    want = np.asarray(jwin._xla_ref_qkv(jy, jw, jnp.asarray(b), ws, nh, 96, q_pool), np.float32)
    got = qkv_window_attention_plain(t(np.asarray(jy.astype(jnp.float32))).to(tdt),
                                     t(np.asarray(jw.astype(jnp.float32)).T).to(tdt), t(b), ws, nh, q_pool)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), want, **(F32 if dtype == "f32" else BF16))


@pytest.mark.parametrize("hp,wp,ws,nh,q_pool,cin", GEOMETRIES)
def test_qkv_window_attention_plain_matches_pallas_interpret_hd128(hp, wp, ws, nh, q_pool, cin):
    y, w, b = _inputs(1, hp, wp, cin, 3 * nh * 128, seed=1)
    jy, jw = jnp.asarray(y, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jwin._run_qkv(jy, jw, jnp.asarray(b), ws=ws, nh=nh, hd=128, q_pool=q_pool, interpret=True)
    got = qkv_window_attention_plain(t(np.asarray(jy.astype(jnp.float32))).to(torch.bfloat16),
                                     t(np.asarray(jw.astype(jnp.float32)).T).to(torch.bfloat16), t(b),
                                     ws, nh, q_pool)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **BF16)


# (map side, ws, q_pool): unpadded, padded, and padded with pooling
MODULE_CASES = [(16, 8, True), (10, 4, True), (9, 7, False)]


@pytest.mark.parametrize("side,ws,q_pool", MODULE_CASES)
def test_attention_module_with_the_switch_is_the_same_function(side, ws, q_pool, monkeypatch):
    torch.manual_seed(0)
    attn = hiera_mod.MultiScaleAttention(32, 64, 2, q_pool)
    with torch.no_grad():
        attn.qkv.bias.normal_(0.0, 0.5)  # pad tokens carry it
    x = t(np.random.default_rng(2).standard_normal((2, side, side, 32)).astype(np.float32))
    calls = []
    monkeypatch.setattr(hiera_mod, "qkv_window_attention",
                        lambda *a: calls.append(1) or qkv_window_attention(*a))
    monkeypatch.delenv("US_MEDSAM2_FUSE_QKV_WINDOW_ATTN", raising=False)
    want = attn(x, ws)
    assert not calls
    monkeypatch.setenv("US_MEDSAM2_FUSE_QKV_WINDOW_ATTN", "1")
    got = attn(x, ws)
    assert len(calls) == 1
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(attn(x, 0), attn(x, 0))  # global attention: the switch does not apply
    assert len(calls) == 1


@pytest.mark.parametrize("q_pool", [False, True])
def test_qkv_window_attention_gradient_matches_jax(q_pool):
    """The wrapper's gradient on the CPU (autograd of the plain version; on
    the card ``_lib.with_plain_grad`` gives the same, tests/
    test_torch_training_parts.py) against ``jax.grad`` of the JAX custom_vjp
    (forward the Pallas kernel in interpret mode, backward the XLA
    recompute), for y, w and b, f32, hd 64."""
    ws, nh, hd = 4, 2, 64
    y, w, b = _inputs(2, 8, 8, 32, 3 * nh * hd, seed=3)
    args = [t(y).requires_grad_(True), t(w.T).requires_grad_(True), t(b).requires_grad_(True)]
    out = qkv_window_attention(*args, ws, nh, q_pool)
    g = np.cos(np.arange(out.numel(), dtype=np.float32)).reshape(out.shape)
    got = torch.autograd.grad(out, args, torch.from_numpy(g))
    want_plain = torch.autograd.grad(qkv_window_attention_plain(*args, ws, nh, q_pool), args,
                                     torch.from_numpy(g))
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want_plain))
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: jnp.sum(jwin.fused_qkv_window_attention(*a, ws, nh, hd, q_pool) * g),
                        argnums=(0, 1, 2))(*map(jnp.asarray, (y, w, b)))
    want = [np.asarray(a) for a in want]
    want[1] = want[1].T  # Dense [in, out] -> Linear [out, in]
    for i, (a, b_) in enumerate(zip(got, want)):
        rel = np.linalg.norm(n(a) - b_) / np.linalg.norm(b_)
        assert rel <= 1e-4, f"argument {i}: gradient rel {rel:.3e}"


def test_qkv_window_attention_wrapper_dispatch():
    """A CPU tensor takes the plain version without counting a launch; off
    the CPU the wrapper launches its kernel or raises (a meta tensor stands
    in for a foreign device)."""
    y, w, b = _inputs(1, 8, 8, 96, 3 * 96, seed=4)
    before = qkv_window_attention.launches
    assert torch.equal(qkv_window_attention(t(y), t(w.T), t(b), 8, 1, False),
                       qkv_window_attention_plain(t(y), t(w.T), t(b), 8, 1, False))
    assert qkv_window_attention.launches == before
    m = dict(device="meta")
    with pytest.raises(ValueError):
        qkv_window_attention(torch.empty(1, 8, 8, 96, **m), torch.empty(288, 96, **m),
                             torch.empty(288, **m), 8, 1, False)
