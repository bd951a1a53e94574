"""PyTorch port: the EfficientTAM family (ViTDet trunk, its neck, landmark-pooled
memory cross-attention) and the head-dim-64 window attentions it runs on.

1. The plain window attention and its qkv variant at hd 64 against the JAX
   package's ``_xla_ref`` / ``_xla_ref_qkv`` (f32 and bf16) and its Pallas
   kernels in interpret mode, at a small geometry and at EfficientMedSAM-S's
   and -Ti's ws-14 blocks; the wrappers' CPU dispatch at hd 64.
2. ``ViTDet`` and ``ViTDetNeck`` (with and without ``neck_norm``) against the
   JAX modules on the same weights through ``from_jax_params``.
3. Landmark attention, variants 1 and 2, against the reference fixtures and
   against the JAX ``RoPEAttention(landmark_pool=2)`` with a key mask.
4. ``MINI_EFF`` (tests/test_efficienttam.py) from the reference state dict:
   three tracked frames against ``efftam_track.npz``, and the port's video
   predictor against the JAX predictor with ``efficient_pool_size`` 0 and 2.
5. The presets and the full-width parameter trees against the JAX package.

Tolerances: f32 port vs JAX 1e-4 relative (the same math, reassociated);
bf16 the JAX kernel tests' 2e-2 (rounding points may differ by one ulp);
against the reference fixtures the JAX tests' own (2e-4 landmark, 2e-3
tracking).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import require_fixture
from tests.test_efficienttam import MINI_EFF
from tests.test_torch_predictor import _iou
from tests.torch_port_helpers import n, port_config, t
from us_video_medsam2_tpu.core.config import PRESETS as JAX_PRESETS
from us_video_medsam2_tpu.core.config import FpnNeckConfig as JaxNeckConfig
from us_video_medsam2_tpu.core.config import ViTDetConfig as JaxViTDetConfig
from us_video_medsam2_tpu.inference.video_predictor import SAM2VideoPredictor as JaxPredictor
from us_video_medsam2_tpu.kernels import fused_window_attention as jwin
from us_video_medsam2_tpu.models import neck as jneck
from us_video_medsam2_tpu.models import vitdet as jvitdet
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu.models.transformer import RoPEAttention as JaxRoPEAttention
from us_video_medsam2_tpu.ops import posenc as jpos
from us_video_medsam2_tpu_torch.core.config import PRESETS
from us_video_medsam2_tpu_torch.core.weights import from_jax_params
from us_video_medsam2_tpu_torch.inference.video_predictor import (
    SAM2VideoPredictor,
    build_efficienttam_video_predictor,
)
from us_video_medsam2_tpu_torch.kernels.qkv_window_attention import (
    qkv_window_attention,
    qkv_window_attention_plain,
)
from us_video_medsam2_tpu_torch.kernels.window_attention import (
    SUPPORTED_HD,
    window_attention,
    window_attention_plain,
)
from us_video_medsam2_tpu_torch.models import memory_bank as tbank
from us_video_medsam2_tpu_torch.models import transformer
from us_video_medsam2_tpu_torch.models.neck import ViTDetNeck
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model
from us_video_medsam2_tpu_torch.models.transformer import RoPEAttention, landmark_attention
from us_video_medsam2_tpu_torch.models.vitdet import ViTDet
from us_video_medsam2_tpu_torch.ops.posenc import compute_axial_rope, rope_key_tables

VS_JAX = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, VS_JAX), "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}
EFF_PRESETS = ("efficientmedsam_s_512", "efficientmedsam_ti_512", "efficienttam_ti_512")

# (B, Hp, ws, nh, q_pool): a small map, EfficientMedSAM-S's and -Ti's ws-14
# blocks (32x32 tokens padded to 42x42), and a pooled map at B 2
WIN64 = [(1, 28, 14, 2, False), (1, 42, 14, 6, False), (1, 42, 14, 3, False), (2, 28, 14, 2, True)]
# (Hp, ws, nh, Cin) of the qkv variant: a small map, -S, -Ti
QKV64 = [(28, 14, 2, 96), (42, 14, 6, 384), (42, 14, 3, 192)]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of the dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, t(np.asarray(j.astype(jnp.float32))).to(tdt)


def _random_like(tree, seed):
    """A parameter tree of the same structure with N(0, 0.1^2) + 1 on LN scales
    and N(0, 1/fan_in) elsewhere, so every parameter moves the output."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 50
        return (rng.standard_normal(a.shape) * fan_in**-0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


# --------------------------------------------------------- window attention at hd 64
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,hp,ws,nh,q_pool", WIN64)
def test_window_attention_plain_matches_xla_ref_hd64(b, hp, ws, nh, q_pool, dtype):
    a = np.random.default_rng(0).standard_normal((b, hp, hp, 3 * nh * 64)).astype(np.float32)
    jq, tq = _pair(a, dtype)
    want = jwin._xla_ref(jq, ws, nh, 64, q_pool)
    got = window_attention_plain(tq, ws, nh, q_pool)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **DTYPES[dtype][2])


@pytest.mark.parametrize("b,hp,ws,nh,q_pool", [WIN64[0], WIN64[1]])
def test_window_attention_plain_matches_pallas_interpret_hd64(b, hp, ws, nh, q_pool):
    a = np.random.default_rng(1).standard_normal((b, hp, hp, 3 * nh * 64)).astype(np.float32)
    jq, tq = _pair(a, "bf16")
    want = jwin._run(jq, ws=ws, nh=nh, hd=64, q_pool=q_pool, interpret=True)
    np.testing.assert_allclose(n(window_attention_plain(tq, ws, nh, q_pool)), np.asarray(want, np.float32),
                               **BF16)


def test_window_attention_heads_are_not_interchangeable_hd64():
    """Swapping two heads' k (the gather offset a hd-64 kernel could get wrong)
    moves the output beyond the bf16 tolerance: the check can see it."""
    a = np.random.default_rng(2).standard_normal((1, 42, 42, 3 * 6 * 64)).astype(np.float32)
    q = t(a)
    swapped = q.clone().reshape(1, 42, 42, 3, 6, 64)
    swapped[:, :, :, 1, [0, 1]] = swapped[:, :, :, 1, [1, 0]]
    want = window_attention_plain(q, 14, 6, False)
    got = window_attention_plain(swapped.reshape(q.shape), 14, 6, False)
    assert not np.allclose(n(got), n(want), **BF16)


def _qkv_inputs(b, hp, nh, cin, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, hp, hp, cin)).astype(np.float32)
    w = (rng.standard_normal((cin, 3 * nh * 64)) * cin**-0.5).astype(np.float32)
    bias = (0.5 * rng.standard_normal(3 * nh * 64)).astype(np.float32)
    return y, w, bias


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hp,ws,nh,cin", QKV64)
def test_qkv_window_attention_plain_matches_xla_ref_hd64(hp, ws, nh, cin, dtype):
    y, w, b = _qkv_inputs(1, hp, nh, cin, seed=3)
    jdt, tdt, tol = DTYPES[dtype]
    jy, jw = jnp.asarray(y, jdt), jnp.asarray(w, jdt)
    want = np.asarray(jwin._xla_ref_qkv(jy, jw, jnp.asarray(b), ws, nh, 64, False), np.float32)
    got = qkv_window_attention_plain(t(np.asarray(jy.astype(jnp.float32))).to(tdt),
                                     t(np.asarray(jw.astype(jnp.float32)).T).to(tdt), t(b), ws, nh, False)
    np.testing.assert_allclose(n(got), want, **tol)


@pytest.mark.parametrize("hp,ws,nh,cin", [QKV64[0], QKV64[1]])
def test_qkv_window_attention_plain_matches_pallas_interpret_hd64(hp, ws, nh, cin):
    y, w, b = _qkv_inputs(1, hp, nh, cin, seed=4)
    jy, jw = jnp.asarray(y, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jwin._run_qkv(jy, jw, jnp.asarray(b), ws=ws, nh=nh, hd=64, q_pool=False, interpret=True)
    got = qkv_window_attention_plain(t(np.asarray(jy.astype(jnp.float32))).to(torch.bfloat16),
                                     t(np.asarray(jw.astype(jnp.float32)).T).to(torch.bfloat16), t(b),
                                     ws, nh, False)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **BF16)


def test_wrappers_take_the_plain_version_on_the_cpu_at_hd64():
    """A CPU tensor takes the plain version without counting a launch; on
    another device the wrapper launches or raises (a meta tensor stands in)."""
    assert SUPPORTED_HD == (64, 96)
    qkv = t(np.random.default_rng(5).standard_normal((1, 28, 28, 3 * 2 * 64)).astype(np.float32))
    y, w, b = (t(a) for a in _qkv_inputs(1, 28, 2, 96, seed=6))
    before = (window_attention.launches, qkv_window_attention.launches)
    assert torch.equal(window_attention(qkv, 14, 2, False), window_attention_plain(qkv, 14, 2, False))
    assert torch.equal(qkv_window_attention(y, w.T, b, 14, 2, False),
                       qkv_window_attention_plain(y, w.T, b, 14, 2, False))
    assert (window_attention.launches, qkv_window_attention.launches) == before
    m = dict(device="meta")
    with pytest.raises(ValueError):
        window_attention(torch.empty(1, 28, 28, 384, **m), 14, 2, False)
    with pytest.raises(ValueError):
        qkv_window_attention(torch.empty(1, 28, 28, 96, **m), torch.empty(384, 96, **m),
                             torch.empty(384, **m), 14, 2, False)


# ------------------------------------------------------------------ ViTDet, neck
def _vit_cfg(ws):
    return JaxViTDetConfig(img_size=128, patch_size=16, embed_dim=128, depth=3, num_heads=2,
                           window_size=ws, window_block_indexes=(0, 1), pretrain_img_size=64)


@pytest.mark.parametrize("ws", [4, 3])  # 8x8 tokens: whole windows, and padded to 9x9
def test_vitdet_matches_jax(ws):
    jcfg = _vit_cfg(ws)
    x = np.random.default_rng(7).standard_normal((2, 128, 128, 3)).astype(np.float32)
    jm = jvitdet.ViTDet(jcfg)
    params = _random_like(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=8)
    want = jm.apply(params, jnp.asarray(x))
    port = ViTDet(port_config(dataclasses.replace(JAX_PRESETS["efficientmedsam_s_512"](), vitdet=jcfg)).vitdet)
    port.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = port(t(x))
    assert len(got) == len(want) == 1 and tuple(got[0].shape) == (2, 8, 8, 128)
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), **VS_JAX)


@pytest.mark.parametrize("neck_norm", [None, "LN"])
def test_vitdet_neck_matches_jax(neck_norm):
    jcfg = JaxNeckConfig(d_model=64, backbone_channel_list=(128,), fpn_top_down_levels=(), neck_norm=neck_norm)
    x = np.random.default_rng(9).standard_normal((2, 8, 8, 128)).astype(np.float32)
    jm = jneck.ViTDetNeck(jcfg)
    params = _random_like(jm.init(jax.random.PRNGKey(0), [jnp.asarray(x)]), seed=10)
    want_x, want_pos = jm.apply(params, [jnp.asarray(x)])
    port = ViTDetNeck(port_config(dataclasses.replace(JAX_PRESETS["efficientmedsam_s_512"](), neck=jcfg)).neck)
    sd = from_jax_params(params)
    assert any(k.endswith("bias") for k in sd if "_conv_" in k) == (neck_norm is None)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got_x, got_pos = port([t(x)])
    np.testing.assert_allclose(n(got_x[0]), np.asarray(want_x[0]), **VS_JAX)
    np.testing.assert_allclose(n(got_pos[0]), np.asarray(want_pos[0]), **VS_JAX)


# ------------------------------------------------------------ landmark attention
def _landmark_port(params, kv_in_dim):
    attn = RoPEAttention(64, 1, kv_in_dim=kv_in_dim, dropout=0.1)
    attn.load_state_dict(from_jax_params(params), strict=True)
    return attn.eval()


def _port_landmark(attn, q, k, n_rope, hw, variant, mask=None):
    cos, sin = compute_axial_rope(64, hw, hw, 10000.0)
    rope_k = rope_key_tables(cos, sin, n_rope, k.shape[1])
    key_mask = None if mask is None else t(mask)
    with torch.no_grad():
        return attn(t(q), t(k), t(k), (cos, sin), rope_k, key_mask, True, None, n_rope, 2, (hw, hw), variant)


@pytest.mark.parametrize("variant", [1, 2])
def test_landmark_attention_matches_reference_fixture(variant):
    from us_video_medsam2_tpu.core.import_torch import _lin

    fx = np.load(require_fixture(f"efficient_rope{variant}.npz"))
    perm = jpos.rope_halfsplit_perm(64, 1)
    params = {}
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        kern, bias = _lin(fx[f"sd.{p}.weight"]), fx[f"sd.{p}.bias"]
        if p in ("q_proj", "k_proj"):
            kern, bias = kern[:, perm], bias[perm]
        params[p] = {"kernel": kern, "bias": bias}
    lk = fx["k"].shape[1]
    got = _port_landmark(_landmark_port(params, 16), fx["q"], fx["k"], lk - int(fx["n_ptr"]), 16, variant)
    np.testing.assert_allclose(n(got), fx["out"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("variant", [1, 2])
def test_landmark_attention_matches_jax_with_a_key_mask(variant):
    rng = np.random.default_rng(11)
    hw, slots, n_ptr = 8, 3, 8
    n_rope = slots * hw * hw
    q = rng.standard_normal((2, hw * hw, 64)).astype(np.float32)
    k = rng.standard_normal((2, n_rope + n_ptr, 16)).astype(np.float32)
    mask = np.ones((2, n_rope + n_ptr), bool)
    mask[0, hw * hw: 2 * hw * hw] = False  # an invalid memory slot
    mask[1, -3:] = False  # invalid pointer tokens
    cos, sin = jpos.compute_axial_rope(64, hw, hw, 10000.0)
    jm = JaxRoPEAttention(embedding_dim=64, num_heads=1, kv_in_dim=16)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), cos, sin)
    kw = dict(rope_k_len=n_rope, rope_k_repeat=True, key_mask=jnp.asarray(mask), landmark_pool=2,
              spatial_hw=(hw, hw), landmark_variant=variant)
    params = _random_like(jm.init(jax.random.PRNGKey(0), *args, **kw), seed=12)
    want = jm.apply(params, *args, **kw)
    got = _port_landmark(_landmark_port(params, 16), q, k, n_rope, hw, variant, mask)
    np.testing.assert_allclose(n(got), np.asarray(want), **VS_JAX)


# --------------------------------------------------------------- MINI_EFF model
@pytest.fixture(scope="module")
def mini_eff():
    """(JAX params, port model) of MINI_EFF from the reference state dict."""
    from us_video_medsam2_tpu.core.import_torch import convert_reference_state_dict

    params = convert_reference_state_dict(dict(np.load(require_fixture("efftam_state_dict.npz"))), MINI_EFF)
    model = SAM2Model(port_config(MINI_EFF))
    model.load_state_dict(from_jax_params(params), strict=True)
    return params, model.eval()


def test_mini_eff_tracking_matches_reference_fixture(mini_eff):
    """Three tracked frames (test_efficienttam.py's parity test) against the
    reference EfficientTAMBase, and the encoder against the JAX model."""
    params, port = mini_eff
    fx = np.load(require_fixture("efftam_track.npz"))
    frames = np.ascontiguousarray(np.transpose(fx["frames"], (0, 2, 3, 1)))
    with torch.no_grad():
        top = port.forward_image(t(frames))["backbone_fpn"]
    jm = JaxSAM2Model(MINI_EFF)
    want = jax.jit(lambda p, x: jm.apply(p, x, method=jm.forward_image))(params, jnp.asarray(frames))
    assert len(top) == len(want["backbone_fpn"]) == 1
    np.testing.assert_allclose(n(top[0]), np.asarray(want["backbone_fpn"][0]), **VS_JAX)
    bank = tbank.init_memory_bank(1, 3, 16 * 16, MINI_EFF.mem_dim, MINI_EFF.hidden_dim)
    for i in range(3):
        kw = dict(is_init_cond_frame=True, is_cond_frame=True) if i == 0 else {}
        pc = t(np.array([[[120.0, 135.0]]], np.float32)) if i == 0 else None
        pl = t(np.array([[1]], np.int32)) if i == 0 else None
        with torch.no_grad():
            out, bank = port.track_step(i, {"top": top[0][i: i + 1]}, bank, 3, pc, pl, multimask_output=True, **kw)
        np.testing.assert_allclose(n(out["low_res_masks"]), fx[f"pred_masks_{i}"], rtol=2e-3, atol=2e-3,
                                   err_msg=f"frame {i}")
        np.testing.assert_allclose(n(out["obj_ptr"]), fx[f"obj_ptr_{i}"], rtol=2e-3, atol=2e-3)
    assert int(bank.valid.sum()) == 3


@pytest.mark.parametrize("pool", [0, 2])
def test_mini_eff_predictor_matches_jax_predictor(mini_eff, pool, monkeypatch):
    """The same weights, 3 frames and two clicked objects on frame 0 through
    both predictors, hole filling on; with ``efficient_pool_size`` 2 every
    tracked frame's cross-attention is landmark-pooled. Low-res logits per
    frame within 1e-3 of the frame's largest logit (both keep a bf16 bank)."""
    params, port = mini_eff
    jcfg = dataclasses.replace(MINI_EFF, memory_attention=dataclasses.replace(
        MINI_EFF.memory_attention, efficient_pool_size=pool))
    model = SAM2Model(port_config(jcfg))
    model.load_state_dict(port.state_dict(), strict=True)
    calls = []
    monkeypatch.setattr(transformer, "landmark_attention",
                        lambda *a: calls.append(1) or landmark_attention(*a))
    fx = np.load(require_fixture("efftam_track.npz"))
    images = np.ascontiguousarray(np.transpose(fx["frames"], (0, 2, 3, 1)))
    low = 4 * MINI_EFF.feat_size
    results = []
    for pred, imgs in ((JaxPredictor(JaxSAM2Model(jcfg), params, fill_hole_area=8), jnp.asarray(images)),
                       (SAM2VideoPredictor(model, fill_hole_area=8, device="cpu"), images)):
        state = pred.init_state(imgs, low, low, max_objects=2)
        pred.add_new_points_or_box(state, 0, 1, points=np.array([[30.0, 34.0]]), labels=np.array([1]))
        _, _, prompt = pred.add_new_points_or_box(state, 0, 2, points=np.array([[12.0, 50.0]]),
                                                  labels=np.array([1]))
        frames = {f: np.asarray(m) for f, _, m in pred.propagate_in_video(state)}
        results.append((np.asarray(prompt), frames))
    (jprompt, jframes), (tprompt, tframes) = results
    np.testing.assert_allclose(tprompt, jprompt, rtol=1e-4, atol=1e-4)
    assert sorted(tframes) == sorted(jframes) == [0, 1, 2]
    # the cross-attention of each memory-attention layer on each tracked frame
    assert len(calls) == (2 * MINI_EFF.memory_attention.num_layers if pool else 0)
    for f in range(3):
        assert tframes[f].shape == jframes[f].shape == (2, 1, low, low)
        scale = np.abs(jframes[f]).max()
        assert jframes[f].std() > 0.05 * scale, f
        for o in range(2):
            assert _iou(tframes[f][o], jframes[f][o]) > 0.99, (f, o)
        np.testing.assert_allclose(tframes[f], jframes[f], rtol=1e-3, atol=1e-3 * scale, err_msg=str(f))


# ------------------------------------------------------------- presets, weights
@pytest.mark.parametrize("name", EFF_PRESETS)
def test_efficienttam_presets_match_jax(name):
    jcfg = JAX_PRESETS[name]()
    assert PRESETS[name]() == port_config(jcfg)
    # the JAX fields the port does not carry hold the values the port implies
    assert jcfg.max_cond_frames_in_attn == -1 and not jcfg.memory_attention.force_flash
    assert jcfg.temporal_fusion.variant == "none" and jcfg.hiera is None


@pytest.mark.parametrize("name", ["efficientmedsam_s_512", "efficientmedsam_ti_512"])
def test_full_width_state_dict_loads_strictly_from_the_jax_tree(name):
    jcfg = JAX_PRESETS[name]()
    s = jcfg.image_size
    shapes = jax.eval_shape(lambda: JaxSAM2Model(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3))))
    params = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    sd = from_jax_params(params)
    model = SAM2Model(port_config(jcfg))
    ref = model.state_dict()
    assert sorted(sd) == sorted(ref), (sorted(set(ref) - set(sd))[:5], sorted(set(sd) - set(ref))[:5])
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), (k, sd[k].shape, v.shape)
    model.load_state_dict(sd, strict=True)
    c = jcfg.vitdet.embed_dim
    assert tuple(ref["image_encoder.trunk.patch_embed.weight"].shape) == (c, 3, 16, 16)
    assert tuple(ref["image_encoder.trunk.pos_embed"].shape) == (1, 14 * 14 + 1, c)
    assert "image_encoder.neck.convs_0_conv_1x1.bias" not in ref


def test_efficienttam_builder_defaults():
    """build_efficienttam_video_predictor builds EfficientMedSAM-S and, like
    every entry point, runs on the card unless asked for the CPU."""
    import inspect

    sig = inspect.signature(build_efficienttam_video_predictor)
    assert sig.parameters["config"].default == "efficientmedsam_s_512"
    assert sig.parameters["device"].default == "cuda"
    pred = build_efficienttam_video_predictor(dataclasses.replace(PRESETS["efficientmedsam_s_512"](),
                                                                  image_size=256), device="cpu",
                                              dtype=torch.float32)
    assert isinstance(pred.model.image_encoder.trunk, ViTDet) and pred.device.type == "cpu"


def test_smoke_script_efficienttam_path_on_cpu():
    """chip_smoke.py's propagation run through build_efficienttam_video_predictor
    at test_efficienttam.py's TINY_EFF (landmark-pooled memory attention) on
    the CPU: every frame yielded, finite logits, the first frames repeated."""
    import chip_smoke
    from tests.test_efficienttam import TINY_EFF

    pred = build_efficienttam_video_predictor(port_config(TINY_EFF), device="cpu", dtype=torch.float32)
    video, click, _ = chip_smoke.make_video(5, 64, seed=0)
    masks, t_prompt, t_prop = chip_smoke.run_main_path(pred, video, click)
    assert sorted(masks) == [0, 1, 2, 3, 4] and t_prompt > 0 and t_prop > 0
    assert all(m.shape == (1, 64, 64) and np.isfinite(m).all() for m in masks.values())
    first, _, _ = chip_smoke.run_main_path(pred, video, click, stop_after=2)
    np.testing.assert_array_equal(first[1], masks[1])
