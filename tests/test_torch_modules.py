"""PyTorch port at the MINI config: each module against the JAX package on the
same weights and inputs, and against the reference golden fixtures at
tests/test_parity.py's tolerances. Also the ops the modules stand on:
positional tables, resizing, exact hole filling, memory selection.

Everything runs in f32 on the CPU. Port vs JAX: 1e-4 relative (the same math;
reassociation only). The memory bank is f32 here, as in test_parity.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import require_fixture
from tests.test_parity import MINI
from tests.torch_port_helpers import mini_port_model, mini_weights, n, nchw_to_nhwc, port_config, t
from us_video_medsam2_tpu.models import memory_bank as jbank
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu.ops import connected_components as jcc
from us_video_medsam2_tpu.ops import posenc as jpos
from us_video_medsam2_tpu.ops.resize import resize2d as jresize
from us_video_medsam2_tpu_torch.models import memory_bank as tbank
from us_video_medsam2_tpu_torch.ops import connected_components as tcc
from us_video_medsam2_tpu_torch.ops import posenc as tpos
from us_video_medsam2_tpu_torch.ops.resize import resize2d as tresize

VS_JAX = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    params, _ = mini_weights()
    return mini_port_model(), JaxSAM2Model(MINI), params


@functools.lru_cache(maxsize=None)
def _jit(method: str, *static):
    model = JaxSAM2Model(MINI)

    def f(params, *args):
        return model.apply(params, *args, *static, method=getattr(model, method))

    return jax.jit(f)


def test_forward_image(models):
    port, _, params = models
    fx = np.load(require_fixture("image_encoder.npz"))
    img = nchw_to_nhwc(fx["img"])
    with torch.no_grad():
        got = port.forward_image(t(img))["backbone_fpn"]
    want = _jit("forward_image")(params, jnp.asarray(img))["backbone_fpn"]
    for i in range(3):
        np.testing.assert_allclose(n(got[i]), nchw_to_nhwc(fx[f"fpn{i}"]), rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(n(got[i]), np.asarray(want[i]), **VS_JAX, err_msg=f"fpn{i}")


@pytest.mark.parametrize("kind,multimask", [("point", True), ("box", False)])
def test_sam_heads(models, kind, multimask):
    port, _, params = models
    fx = np.load(require_fixture(f"sam_heads_{kind}.npz"))
    bf, s0, s1 = (nchw_to_nhwc(fx[k]) for k in ("bf", "s0", "s1"))
    with torch.no_grad():
        got = port.sam_heads(t(bf), t(fx["pts"]), t(fx["lbl"]), None, [t(s0), t(s1)],
                             multimask_output=multimask)
    want = _jit("sam_heads", multimask)(params, jnp.asarray(bf), jnp.asarray(fx["pts"]),
                                        jnp.asarray(fx["lbl"]), None, [jnp.asarray(s0), jnp.asarray(s1)])
    keys = ["low_res_masks", "obj_ptr"] + (["low_res_multimasks", "ious", "object_score_logits"]
                                           if multimask else [])
    for k in keys:
        np.testing.assert_allclose(n(got[k]), fx[k], rtol=1e-3, atol=5e-4, err_msg=k)
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), **VS_JAX, err_msg=k)


def test_memory_attention(models):
    port, jmodel, params = models
    fx = np.load(require_fixture("memory_attention.npz"))
    arrs = [fx[k].transpose(1, 0, 2) for k in ("curr", "memory", "curr_pe", "memory_pe")]
    n_ptr = int(fx["n_ptr"])
    curr, memory, curr_pe, memory_pe = arrs
    with torch.no_grad():
        got = port.memory_attention(t(curr), t(memory), t(curr_pe), t(memory_pe), n_ptr)
    want = jax.jit(lambda p, *a: jmodel.apply(p, *a, n_ptr, method=lambda m, *b: m.memory_attention(*b)))(
        params, *(jnp.asarray(a) for a in (curr, memory, curr_pe, memory_pe)))
    np.testing.assert_allclose(n(got), fx["out"].transpose(1, 0, 2), rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(n(got), np.asarray(want), **VS_JAX)


def test_memory_attention_key_mask_matches_jax(models):
    """Masked memory slots and pointer tokens, as the fixed-shape bank gives them."""
    port, jmodel, params = models
    rng = np.random.default_rng(0)
    lq, hw, slots, n_ptr = 256, 256, 3, 8
    curr = rng.standard_normal((1, lq, 64)).astype(np.float32)
    curr_pe = rng.standard_normal((1, lq, 64)).astype(np.float32)
    memory = rng.standard_normal((1, slots * hw + n_ptr, 16)).astype(np.float32)
    memory_pe = rng.standard_normal((1, slots * hw + n_ptr, 16)).astype(np.float32)
    mask = np.ones((1, slots * hw + n_ptr), bool)
    mask[:, hw: 2 * hw] = False
    mask[:, -3:] = False
    with torch.no_grad():
        got = port.memory_attention(t(curr), t(memory), t(curr_pe), t(memory_pe), n_ptr, t(mask))
    want = jmodel.apply(params, *(jnp.asarray(a) for a in (curr, memory, curr_pe, memory_pe)), n_ptr,
                        jnp.asarray(mask), method=lambda m, *b: m.memory_attention(*b))
    np.testing.assert_allclose(n(got), np.asarray(want), **VS_JAX)


def test_encode_memory(models):
    port, _, params = models
    fx = np.load(require_fixture("memory_encoder.npz"))
    feats = nchw_to_nhwc(fx["feats"])
    with torch.no_grad():
        got = port.encode_memory(t(feats), t(fx["mask_logits"]), torch.tensor([[5.0]]), False)
    want = _jit("encode_memory", False)(params, jnp.asarray(feats), jnp.asarray(fx["mask_logits"]),
                                        jnp.asarray([[5.0]]))
    np.testing.assert_allclose(n(got), nchw_to_nhwc(fx["maskmem"]), rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(n(got), np.asarray(want), **VS_JAX)


def test_track_step_loop(models):
    """4-frame tracking with memory-bank selection (test_parity.py:161-218)."""
    port, jmodel, params = models
    fx = np.load(require_fixture("track_video.npz"))
    frames = nchw_to_nhwc(fx["frames"])
    with torch.no_grad():
        fpn = port.forward_image(t(frames))["backbone_fpn"]
    jfpn = _jit("forward_image")(params, jnp.asarray(frames))["backbone_fpn"]
    tb = tbank.init_memory_bank(1, 4, 16 * 16, MINI.mem_dim, MINI.hidden_dim)
    jb = jbank.init_memory_bank(1, 4, 16 * 16, MINI.mem_dim, MINI.hidden_dim)

    def jstep(params, t_, feats, bank, pc, pl, init):
        kw = dict(is_init_cond_frame=True, is_cond_frame=True) if init else {}
        return jmodel.apply(params, t_, feats, bank, 4, pc, pl, multimask_output=True,
                            method=jmodel.track_step, **kw)

    jstep = jax.jit(jstep, static_argnums=(6,))
    for i in range(4):
        feats = {"top": fpn[2][i: i + 1], "s0": fpn[0][i: i + 1], "s1": fpn[1][i: i + 1]}
        jfeats = {"top": jfpn[2][i: i + 1], "s0": jfpn[0][i: i + 1], "s1": jfpn[1][i: i + 1]}
        pc = np.array([[[130.0, 120.0]]], np.float32) if i == 0 else None
        pl = np.array([[1]], np.int32) if i == 0 else None
        with torch.no_grad():
            out, tb = port.track_step(i, feats, tb, 4, None if pc is None else t(pc),
                                      None if pl is None else t(pl), multimask_output=True,
                                      is_init_cond_frame=i == 0, is_cond_frame=i == 0)
        jout, jb = jstep(params, jnp.asarray(i), jfeats, jb, pc, pl, i == 0)
        mm = n(tb.maskmem[:, i]).reshape(1, 16, 16, 16)
        np.testing.assert_allclose(n(out["low_res_masks"]), fx[f"pred_masks_{i}"], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(n(out["obj_ptr"]), fx[f"obj_ptr_{i}"], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(mm, nchw_to_nhwc(fx[f"maskmem_{i}"]), rtol=2e-3, atol=2e-3)
        for k in ("low_res_masks", "obj_ptr", "object_score_logits"):
            np.testing.assert_allclose(n(out[k]), np.asarray(jout[k]), **VS_JAX, err_msg=f"{k} {i}")
        np.testing.assert_allclose(n(tb.maskmem), np.asarray(jb.maskmem), **VS_JAX)
        assert np.array_equal(tb.valid.numpy(), np.asarray(jb.valid))
        assert np.array_equal(tb.is_cond.numpy(), np.asarray(jb.is_cond))


# ----------------------------------------------------------------------- ops
def test_posenc_tables_match_jax():
    np.testing.assert_allclose(n(tpos.sine_pos_embed_2d(16, 12, 64)),
                               np.asarray(jpos.sine_pos_embed_2d(16, 12, 64)), **VS_JAX)
    pos = np.linspace(-3, 7, 11).astype(np.float32)
    np.testing.assert_allclose(n(tpos.sine_pe_1d(t(pos), 64)),
                               np.asarray(jpos.sine_pe_1d(jnp.asarray(pos), 64)), **VS_JAX)
    cos, sin = tpos.compute_axial_rope(64, 16, 16)
    jcos, jsin = jpos.compute_axial_rope(64, 16, 16)
    np.testing.assert_allclose(n(cos), np.asarray(jcos), **VS_JAX)
    np.testing.assert_allclose(n(sin), np.asarray(jsin), **VS_JAX)
    x = np.random.default_rng(0).standard_normal((2, 1, 3 * 256 + 8, 64)).astype(np.float32)
    ck, sk = tpos.rope_key_tables(cos, sin, 3 * 256, 3 * 256 + 8)
    jck = jnp.concatenate([jnp.tile(jcos, (3, 1)), jnp.ones((8, 32))])
    jsk = jnp.concatenate([jnp.tile(jsin, (3, 1)), jnp.zeros((8, 32))])
    np.testing.assert_allclose(n(tpos.apply_rope_halfsplit(t(x), ck, sk)),
                               np.asarray(jpos.apply_rope_halfsplit(jnp.asarray(x), jck, jsk)), **VS_JAX)


@pytest.mark.parametrize("src,dst,mode,aa", [
    (7, 64, "cubic", False), (64, 256, "linear", False), (256, 64, "linear", True),
    (48, 200, "linear", False),
])
def test_resize_matches_jax(src, dst, mode, aa):
    x = np.random.default_rng(1).standard_normal((2, src, src, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tresize(t(x), (dst, dst), mode, aa)),
                               np.asarray(jresize(jnp.asarray(x), (dst, dst), mode, aa)), **VS_JAX)


def _blob_masks(seed, b=3, h=48, w=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = rng.standard_normal((b, h, w)).astype(np.float32) * 0.3
    for i in range(b):
        for _ in range(4):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 12)
            out[i] += np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r * r, 2.0, -0.5)
    return out


@pytest.mark.parametrize("max_area", [1, 8])
def test_hole_filling_and_sprinkles_exact_vs_jax(max_area):
    m = _blob_masks(max_area)
    got = tcc.fill_holes_in_mask_scores(t(m), max_area)
    want = jcc.fill_holes_in_mask_scores(jnp.asarray(m), max_area)
    assert np.array_equal(n(got), np.asarray(want))
    assert (n(got) != m).any() or max_area == 1
    got = tcc.remove_small_sprinkles(t(m), max_area)
    want = jcc.remove_small_sprinkles(jnp.asarray(m), max_area)
    assert np.array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("reverse", [False, True])
def test_select_memories_matches_jax(reverse):
    rng = np.random.default_rng(2 + reverse)
    s = 20
    valid = rng.random((2, s)) > 0.3
    is_cond = valid & (rng.random((2, s)) > 0.7)
    tb = tbank.init_memory_bank(2, s, 4, 8, 16)
    tb.valid[:] = t(valid)
    tb.is_cond[:] = t(is_cond)
    jb = jbank.init_memory_bank(2, s, 4, 8, 16).replace(valid=jnp.asarray(valid),
                                                        is_cond=jnp.asarray(is_cond))
    cfg = MINI
    for frame in (0, 3, 11, 19):
        for mcs in (None, 2):
            got = tbank.select_memories(tb, frame, port_config(cfg), s, reverse, mcs)
            want = jbank.select_memories(jb, frame, cfg, s, reverse, max_cond_slots=mcs)
            mv, pv = n(got.mem_valid).astype(bool), n(got.ptr_valid).astype(bool)
            assert np.array_equal(mv, np.asarray(want.mem_valid))
            assert np.array_equal(pv, np.asarray(want.ptr_valid))
            assert np.array_equal(n(got.mem_idx)[mv], np.asarray(want.mem_idx)[mv])
            assert np.array_equal(n(got.ptr_idx)[pv], np.asarray(want.ptr_idx)[pv])
            assert np.array_equal(n(got.ptr_pos)[pv], np.asarray(want.ptr_pos)[pv])
            assert np.array_equal(n(got.mem_tpos), np.asarray(want.mem_tpos))
            assert got.t_diff_max == want.t_diff_max
