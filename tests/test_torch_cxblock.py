"""PyTorch port: the memory encoder's whole-block ConvNeXt kernel (``cxblock``).

Its plain version against the JAX package's ``fused_cxblock._xla_ref`` and
its Pallas kernel (interpret mode on the CPU), the CXBlock module with
``US_MEDSAM2_ENABLE_FUSED_CXBLOCK`` set against the same module unset, the
wrapper's gradient against the JAX custom_vjp's, and its dispatch. The kernel against its plain version
needs a GPU and runs in chip_smoke.py.

Inputs come from numpy with a seed; γ is 1 ± 0.1, since at the model's
layer-scale init (1e-6) the output equals x and any block would pass.
Tolerances: f32 1e-4 relative (the same math, reassociated: a 49-tap sum and
products over 256 and 1024 terms), 1e-5 absolute; bf16 the JAX kernel tests'
2e-2 (rounding points may differ by one ulp, and the Pallas kernel's erf is a
polynomial within 1.3e-4); the module with the switch set against unset
1e-5 in f32 (the same function through other PyTorch calls); gradients 1e-4
relative L2 in f32 (the same math, reassociated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_fused_cxblock import _params as jax_cxblock_params
from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import fused_cxblock as jcx
from us_video_medsam2_tpu_torch.kernels.cxblock import cxblock, cxblock_plain
from us_video_medsam2_tpu_torch.models import memory as memory_mod

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
SHAPES = [(1, 32, 32, 256), (2, 16, 16, 128)]


def _inputs(b, h, w, c, seed):
    """x and the JAX-layout parameters (dwconv HWIO [7, 7, 1, C], Dense [in, out])."""
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(np.float32)

    x = a(b, h, w, c)
    p = dict(dw_w=a(7, 7, 1, c, scale=0.1), dw_b=a(c, scale=0.1), ln_s=a(c, scale=0.1, offset=1.0),
             ln_b=a(c, scale=0.1), w1=a(c, 4 * c, scale=c**-0.5), b1=a(4 * c, scale=0.3),
             w2=a(4 * c, c, scale=(4 * c) ** -0.5), b2=a(c, scale=0.1), gamma=a(c, scale=0.1, offset=1.0))
    return x, p


def _port_args(p):
    """The same parameters in the port's layouts: depthwise [C, 1, 7, 7], Linear [out, in]."""
    return (t(p["dw_w"].transpose(3, 2, 0, 1)), t(p["dw_b"]), t(p["ln_s"]), t(p["ln_b"]), t(p["w1"].T),
            t(p["b1"]), t(p["w2"].T), t(p["b2"]), t(p["gamma"]))


def _jax_args(p):
    return [jnp.asarray(v) for v in p.values()]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cxblock_plain_matches_xla_ref(shape, dtype):
    x, p = _inputs(*shape, seed=0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x, jdt)
    tx = t(np.asarray(jx.astype(jnp.float32))).to(tdt)
    want = np.asarray(jcx._xla_ref(jx, *_jax_args(p), 1e-6), np.float32)
    got = cxblock_plain(tx, *_port_args(p), 1e-6)
    assert tuple(got.shape) == want.shape
    tol = F32 if dtype == "f32" else BF16
    np.testing.assert_allclose(n(got), want, **tol)
    if dtype == "f32":  # the block's own contribution, not hidden under x
        np.testing.assert_allclose(n(got) - x, want - x, **tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_cxblock_plain_matches_pallas_interpret(shape):
    """With the inputs of tests/test_fused_cxblock.py (γ ~ 0.01): at γ ~ 1 a
    one-ulp difference of the bf16 pointwise output passes undamped into
    x + γ·o near 0 (one element in 262,144 then lies 0.023 apart)."""
    rng = np.random.default_rng(0)
    jx = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    p = {k: np.asarray(v) for k, v in jax_cxblock_params(rng, shape[-1]).items()}
    want = jcx._run(jx, *_jax_args(p), eps=1e-6, interpret=True)
    got = cxblock_plain(t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16), *_port_args(p), 1e-6)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **BF16)


def _block(c, seed):
    """A CXBlock with seeded parameters and γ 1 ± 0.1."""
    x, p = _inputs(2, 12, 12, c, seed)
    blk = memory_mod.CXBlock(c)
    with torch.no_grad():
        for name, v in zip(("dwconv.conv.weight", "dwconv.conv.bias", "norm.weight", "norm.bias",
                            "pwconv1.weight", "pwconv1.bias", "pwconv2.weight", "pwconv2.bias", "gamma"),
                           _port_args(p)):
            blk.get_parameter(name).copy_(v)
    return blk, t(x)


def test_cxblock_module_with_the_switch_is_the_same_function(monkeypatch):
    blk, x = _block(64, seed=2)
    calls = []
    monkeypatch.setattr(memory_mod, "cxblock", lambda *a: calls.append(1) or cxblock(*a))
    monkeypatch.delenv("US_MEDSAM2_ENABLE_FUSED_CXBLOCK", raising=False)
    want = blk(x)
    assert not calls
    monkeypatch.setenv("US_MEDSAM2_ENABLE_FUSED_CXBLOCK", "1")
    got = blk(x)
    assert len(calls) == 1
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(got - x), n(want - x), rtol=1e-5, atol=1e-5)


def test_cxblock_gradient_matches_jax():
    """The wrapper's gradient on the CPU (autograd of the plain version; on
    the card ``_lib.with_plain_grad`` gives the same, tests/
    test_torch_training_parts.py) against ``jax.grad`` of the JAX custom_vjp
    (forward the Pallas kernel in interpret mode, backward the XLA
    recompute), every argument, f32."""
    x, p = _inputs(1, 8, 8, 128, seed=3)
    args = [t(x).requires_grad_(True)] + [a.requires_grad_(True) for a in _port_args(p)]
    out = cxblock(*args, 1e-6)
    g = np.cos(np.arange(out.numel(), dtype=np.float32)).reshape(out.shape)
    got = torch.autograd.grad(out, args, torch.from_numpy(g))
    want_plain = torch.autograd.grad(cxblock_plain(*args, 1e-6), args, torch.from_numpy(g))
    assert all(torch.equal(a, b) for a, b in zip(got, want_plain))
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: jnp.sum(jcx.fused_cxblock(*a, 1e-6) * g), argnums=tuple(range(10)))(
            jnp.asarray(x), *_jax_args(p))
    # back to the port's layouts: depthwise HWIO -> [C, 1, 7, 7], Dense [in, out] -> Linear [out, in]
    want = [np.asarray(w) for w in want]
    want[1] = want[1].transpose(3, 2, 0, 1)
    want[5], want[7] = want[5].T, want[7].T
    for i, (a, b) in enumerate(zip(got, want)):
        rel = np.linalg.norm(n(a) - b) / np.linalg.norm(b)
        assert rel <= 1e-4, f"argument {i}: gradient rel {rel:.3e}"


def test_cxblock_wrapper_dispatch():
    """A CPU tensor takes the plain version without counting a launch; off
    the CPU the wrapper launches its kernel or raises (a meta tensor stands
    in for a foreign device)."""
    x, p = _inputs(1, 8, 8, 32, seed=4)
    before = cxblock.launches
    assert torch.equal(cxblock(t(x), *_port_args(p)), cxblock_plain(t(x), *_port_args(p)))
    assert cxblock.launches == before
    m = dict(device="meta")
    with pytest.raises(ValueError):
        cxblock(torch.empty(1, 8, 8, 256, **m), *[torch.empty(1, **m)] * 9)
