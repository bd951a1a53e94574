"""PyTorch port: the window-attention kernel's last-strip row cut (``real_h``)
and its grid (``window_tiles``).

1. ``window_attention_plain(..., real_h=rh)`` against the JAX package's
   Pallas kernel with the same cut (``_run(..., real_h=rh, interpret=True)``)
   at the JAX test's four cut geometries, and against ``_xla_ref`` on the real
   rows at the seven windowed ``sam2.1_hiera_t512`` geometries: the real rows
   agree, the cut rows are exact zeros in both, and the real rows are
   bit-identical to the call without the cut.
2. ``window_tiles``' grid, walked by the kernel's own index arithmetic
   (``tile_tasks``): every (batch, window, head, real query slab) exactly
   once and no slab of cut rows; at batch 1 one wave of the blocks an SM
   holds; where no choice fits one wave (the training path's batch 4), the
   stated rule; and the grids of every warps count the kernel takes (1-8),
   each covering every real slab once.
3. The port's Hiera ``MultiScaleAttention``, which passes the unpadded height,
   at padded maps against the JAX module.
4. The gradient with ``real_h`` through ``_lib.with_plain_grad`` against
   ``jax.vjp`` of the JAX ``fused_window_attention`` (its Pallas forward in
   interpret mode), through the caller's crop.
The kernel itself is held against the plain version on the card by
chip_smoke.py.

Tolerances: the JAX kernel tests' 2e-2 in bf16; 1e-4 relative in f32 (the
same math, reassociated); gradients 1e-4 relative L2 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_port_helpers import n, t
from us_video_medsam2_tpu.kernels import fused_window_attention as jwin
from us_video_medsam2_tpu.models.hiera import MultiScaleAttention as JaxAttention
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels import window_attention as wa
from us_video_medsam2_tpu_torch.models import hiera as hiera_mod

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# the JAX test's cut geometries (real_h, hp, wp, ws, nh, hd, q_pool)
CUT_GEOMETRIES = [
    (32, 42, 42, 14, 6, 64, False),
    (32, 42, 42, 14, 4, 128, False),
    (32, 42, 42, 14, 8, 128, True),
    (16, 21, 21, 7, 8, 128, False),
]
# (Hp, ws, nh, q_pool, real side): the nine windowed sam2.1_hiera_t512 blocks, hd 96
T512 = [
    (128, 8, 1, False, 128),
    (128, 8, 2, True, 128),
    (64, 4, 2, False, 64),
    (64, 4, 4, True, 64),
    (42, 14, 4, False, 32),
    (42, 14, 8, True, 32),
    (21, 7, 8, False, 16),
]
# (hd, Hp, ws, nh, q_pool, real side) of every call the serving and training paths make:
# t512 at hd 96, EfficientMedSAM-S (nh 6) and -Ti (nh 3) at hd 64
PATH_GEOMETRIES = [(96, *g) for g in T512] + [(64, 42, 14, 6, False, 32), (64, 42, 14, 3, False, 32)]


def _real_out_rows(hp, ws, q_pool, real_h):
    """Output rows of the map that the caller keeps."""
    return real_h // 2 if q_pool else real_h


@pytest.mark.parametrize("rh,hp,wp,ws,nh,hd,q_pool", CUT_GEOMETRIES)
def test_plain_real_h_matches_pallas_interpret(rh, hp, wp, ws, nh, hd, q_pool):
    rng = np.random.default_rng(31)
    jq = jnp.asarray(rng.standard_normal((2, hp, wp, 3 * nh * hd)), jnp.bfloat16)
    tq = t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    want = np.asarray(jwin._run(jq, ws=ws, nh=nh, hd=hd, q_pool=q_pool, real_h=rh, interpret=True), np.float32)
    got = n(wa.window_attention_plain(tq, ws, nh, q_pool, rh))
    assert got.shape == want.shape
    ro = _real_out_rows(hp, ws, q_pool, rh)
    np.testing.assert_allclose(got[:, :ro], want[:, :ro], **BF16)
    wso = ws // 2 if q_pool else ws
    cut = (hp // ws - 1) * wso + wa.cut_query_rows(hp, ws, q_pool, rh) // wso
    assert wa.cut_query_rows(hp, ws, q_pool, rh) > 0
    assert not got[:, cut:].any() and not want[:, cut:].any()
    assert got[:, :cut].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hp,ws,nh,q_pool,real", T512)
def test_plain_real_h_matches_xla_ref_hd96(hp, ws, nh, q_pool, real, dtype):
    rng = np.random.default_rng(0)
    # a slice of the rows keeps the unpadded large maps fast; the padded ones run whole
    rows = hp if real < hp else 2 * ws
    real_h = real if real < hp else rows
    jdt, tdt, tol = (jnp.float32, torch.float32, F32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16, BF16)
    jq = jnp.asarray(rng.standard_normal((1, rows, hp, 3 * nh * 96)), jdt)
    tq = t(np.asarray(jq.astype(jnp.float32))).to(tdt)
    want = np.asarray(jwin._xla_ref(jq, ws, nh, 96, q_pool), np.float32)
    got = wa.window_attention_plain(tq, ws, nh, q_pool, real_h)
    full = wa.window_attention_plain(tq, ws, nh, q_pool)
    ro = _real_out_rows(rows, ws, q_pool, real_h)
    np.testing.assert_allclose(n(got)[:, :ro], want[:, :ro], **tol)
    assert torch.equal(got[:, :ro], full[:, :ro])
    q_lq = wa.cut_query_rows(rows, ws, q_pool, real_h)
    assert (q_lq > 0) == (real < hp and not (q_pool and (real % ws) % 2))
    if q_lq:
        wso = ws // 2 if q_pool else ws
        assert not got[:, (rows // ws - 1) * wso + q_lq // wso:].any()


def test_cut_rows_are_the_jax_helpers():
    """``_last_strip_q_rows`` is the JAX helper's (off its TPU raster path)."""
    for hp, ws in ((42, 14), (21, 7), (24, 8), (12, 4), (28, 14)):
        for q_pool in (False, True):
            if q_pool and ws % 2:
                continue
            for real_h in [None] + list(range(hp - ws + 1, hp + 1)):
                assert wa._last_strip_q_rows(hp, ws, q_pool, real_h) == jwin._last_strip_q_rows(
                    hp, ws, q_pool, real_h, 0), (hp, ws, q_pool, real_h)


def _assert_every_real_slab_once(b, hp, ws, nh, q_pool, real_h, warps):
    """The grid of ``warps`` warps a block, walked by the kernel's index
    arithmetic, computes every real query slab of every window-head once,
    no slab of cut rows, and gives each warp at most one slab."""
    q_lq = wa.cut_query_rows(hp, ws, q_pool, real_h)
    tasks = list(wa.tile_tasks(b, hp, hp, ws, nh, q_pool, q_lq, warps))
    wso = ws // 2 if q_pool else ws
    lq, nwh = wso * wso, hp // ws
    want = set()
    for bi in range(b):
        for wy in range(nwh):
            rows = q_lq if q_lq and wy == nwh - 1 else lq  # real query rows of the window
            for wx in range(nwh):
                for head in range(nh):
                    want |= {((bi, wy, wx, head), s) for s in range(-(-rows // 16))}
    got = [(wh, s) for _, _, wh, s in tasks]
    assert len(got) == len(set(got)), "a slab is computed twice"
    assert set(got) == want
    assert len({(blk, w) for blk, w, _, _ in tasks}) == len(tasks), "a warp takes two slabs"
    assert all(0 <= w < warps for _, w, _, _ in tasks)
    # a block stages the K and V of one window-head
    per_block = {}
    for blk, _, wh, _ in tasks:
        per_block.setdefault(blk, set()).add(wh)
    assert max(len(v) for v in per_block.values()) == 1


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("hd,hp,ws,nh,q_pool,real", PATH_GEOMETRIES)
@pytest.mark.parametrize("cut", [False, True])
def test_window_tiles_cover_every_real_slab_once(hd, hp, ws, nh, q_pool, real, b, cut):
    real_h = real if cut else None
    warps = wa.window_tiles(b, hp, hp, ws, nh, hd, q_pool, real_h)
    _assert_every_real_slab_once(b, hp, ws, nh, q_pool, real_h, warps)


# one geometry of each key-tile instantiation, with the cut where the map is padded
# (ws 14 unpooled and pooled: a partial last slab of 4 and 14 real rows)
WARPS_GEOMETRIES = [(128, 8, 2, True, 128), (64, 4, 4, True, 64), (42, 14, 4, False, 32), (42, 14, 8, True, 32)]


@pytest.mark.parametrize("warps", [1, 3, 5, 8])
@pytest.mark.parametrize("hp,ws,nh,q_pool,real", WARPS_GEOMETRIES)
def test_every_warps_count_covers_every_real_slab_once(hp, ws, nh, q_pool, real, warps):
    """The kernel takes any count of warps a block from 1 to 8 (the sweep
    and ``_kernel``'s override use those that ``window_tiles`` does not
    pick), and its grid is right at each: also where the slabs of a
    window-head do not divide evenly over the blocks."""
    _assert_every_real_slab_once(2, hp, ws, nh, q_pool, real if real < hp else None, warps)


@pytest.mark.parametrize("hd,hp,ws,nh,q_pool,real", PATH_GEOMETRIES)
@pytest.mark.parametrize("cut", [False, True])
def test_window_tiles_wave_rule(hd, hp, ws, nh, q_pool, real, cut):
    """At batch 1 every grid runs in one wave of the blocks an SM holds; the
    pick is the most warps a block that fit one wave, else the fewest waves
    with the most warps on a tie (the training path's batch 4 at ws 14)."""
    real_h = real if cut else None
    q_lq = wa.cut_query_rows(hp, ws, q_pool, real_h)
    for b in (1, 4):
        warps = wa.window_tiles(b, hp, hp, ws, nh, hd, q_pool, real_h)

        def waves(w):
            cap = wa.SMS * wa.blocks_per_sm(hd, ws, w)
            return sum(r["blocks"] for r in wa.grid(b, hp, hp, ws, nh, q_pool, q_lq, w)) / cap

        choices = [w for w in wa.WARP_CHOICES if wa.smem_bytes(hd, ws, w) <= wa.SMEM_PER_BLOCK]
        assert warps in choices
        if b == 1:
            assert waves(warps) <= 1, (warps, waves(warps))
        fewest = min(np.ceil(waves(c)) for c in choices)
        assert np.ceil(waves(warps)) == fewest
        assert warps == max(c for c in choices if np.ceil(waves(c)) == fewest)


# (map side, ws, q_pool): a cut strip unpooled and pooled, at ws 7, and a pooled
# map whose odd real row count takes no cut; and an unpadded map
MODULE_CASES = [(10, 4, False), (10, 4, True), (9, 7, False), (9, 4, True), (16, 8, True)]


@pytest.mark.parametrize("side,ws,q_pool", MODULE_CASES)
def test_attention_module_at_a_padded_map_matches_jax(side, ws, q_pool, monkeypatch):
    """The port's MultiScaleAttention (which passes the unpadded height, so
    the last strip's pad query rows are cut and cropped) against the JAX
    module (on the CPU its XLA path, which computes every row), f32."""
    dim, dim_out, heads = 32, 64, 2
    x = np.random.default_rng(2).standard_normal((2, side, side, dim)).astype(np.float32)
    jm = JaxAttention(dim_out=dim_out, num_heads=heads, q_pool=q_pool)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), window_size=ws)
    rng = np.random.default_rng(3)  # biases drawn too: pad tokens carry the qkv bias
    params = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.3, p.dtype), params)
    want = np.asarray(jm.apply(params, jnp.asarray(x), window_size=ws))
    attn = hiera_mod.MultiScaleAttention(dim, dim_out, heads, q_pool)
    attn.load_state_dict(from_jax_params(params), strict=True)
    seen = []
    monkeypatch.setattr(hiera_mod, "window_attention",
                        lambda qkv, ws_, nh, qp, real_h: seen.append(real_h) or wa.window_attention(
                            qkv, ws_, nh, qp, real_h))
    with torch.no_grad():
        got = attn(t(x), ws)
    assert seen == [side]
    hp = -(-side // ws) * ws
    assert (wa.cut_query_rows(hp, ws, q_pool, side) > 0) == (side % ws != 0 and not (q_pool and side % 2))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), want, **F32)


@pytest.mark.parametrize("q_pool", [False, True])
def test_gradient_with_real_h_matches_jax_vjp(q_pool):
    """With ``real_h`` the wrapper's gradient (``with_plain_grad``: the
    forward given, the plain version's vjp recomputed) through the caller's
    crop against ``jax.vjp`` of the JAX ``fused_window_attention`` (Pallas
    forward in interpret mode, XLA backward), f32, hd 64."""
    ws, nh, hd, real_h, hp = 4, 2, 64, 10, 12
    qkv = np.random.default_rng(4).standard_normal((2, hp, 8, 3 * nh * hd)).astype(np.float32)
    ro = _real_out_rows(hp, ws, q_pool, real_h)
    assert wa.cut_query_rows(hp, ws, q_pool, real_h) > 0
    a = t(qkv).requires_grad_(True)
    out = _lib.with_plain_grad(wa.window_attention_plain, wa.window_attention_plain, a, ws, nh, q_pool, real_h)
    g = np.cos(np.arange(out[:, :ro].numel(), dtype=np.float32)).reshape(out[:, :ro].shape)
    (got,) = torch.autograd.grad(out[:, :ro], [a], torch.from_numpy(g))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x: jwin.fused_window_attention(x, ws, nh, hd, q_pool, real_h)[:, :ro],
                         jnp.asarray(qkv))
        (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    rel = np.linalg.norm(n(got) - want) / np.linalg.norm(want)
    assert rel <= 1e-4, f"gradient rel {rel:.3e}"


def test_wrapper_with_real_h_dispatch():
    """A CPU tensor takes the plain version with the cut, without counting a
    launch; off the CPU the wrapper launches its kernel or raises (a meta
    tensor stands in for a foreign device)."""
    qkv = t(np.random.default_rng(5).standard_normal((1, 14, 14, 3 * 2 * 64)).astype(np.float32))
    before = wa.window_attention.launches
    assert torch.equal(wa.window_attention(qkv, 7, 2, False, 10), wa.window_attention_plain(qkv, 7, 2, False, 10))
    assert wa.window_attention.launches == before
    m = dict(device="meta")
    with pytest.raises(ValueError):
        wa.window_attention(torch.empty(1, 14, 14, 384, **m), 7, 2, False, 10)
