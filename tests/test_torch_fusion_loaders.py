"""PyTorch port: the temporal fusion through the loaders and the configs,
against the JAX package's.

1. The importer: the MINI reference fixture plus ``temporal_fusion.{0,1,2}.*``
   keys at C 64 (TCE, GFTE, ATSF; BatchNorm running statistics and
   ``num_batches_tracked`` included) gives exactly ``from_jax_params`` of the
   JAX importer's ``{"params", "batch_stats"}``, buffers included; a GP
   checkpoint raises as in JAX; an unknown or a missing fusion key raises.
   The fusion keys are written from a seeded port model by
   ``chip_smoke.to_reference_state_dict``, whose fusion half is first held
   against the reference fixture ``temporal_fusion.npz``.
2. The native ``.npz`` of the JAX trainer with its ``batch_stats``, and a
   ``.pt``, through ``load_params`` / ``build_sam2(ckpt_path=)``.
3. YAML: ``resolve_config`` of both configs in ``configs/`` equals the JAX
   reader's, field by field; each ``${...}`` resolver against JAX's;
   ``build_sam2`` from a YAML path.
4. Serving: the MINI predictor with GFTE weights gives the JAX predictor's
   masks, and the same bits as the same weights without fusion.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.conftest import require_fixture
from tests.test_parity import MINI
from tests.test_torch_loaders import _assert_sd_equal, _fixture
from tests.torch_port_helpers import assert_masks_close, port_config
from us_video_medsam2_tpu.core import checkpoint as jckpt
from us_video_medsam2_tpu.core import config as jconfig
from us_video_medsam2_tpu.core.import_torch import convert_reference_state_dict as jax_convert
from us_video_medsam2_tpu_torch.core import config as tconfig
from us_video_medsam2_tpu_torch.core import import_torch as timport
from us_video_medsam2_tpu_torch.core.build import build_sam2, load_params
from us_video_medsam2_tpu_torch.core.weights import from_jax_params, init_random_
from us_video_medsam2_tpu_torch.models.sam2 import SAM2Model

C = 64  # MINI's d_model
FUSED = ["tce", "gfte", "atsf"]
YAMLS = ["configs/gfte_tpu.yaml", "configs/efficientmedsam_s_tpu.yaml"]


def _jcfg(variant):
    return dataclasses.replace(MINI, temporal_fusion=jconfig.TemporalFusionConfig(variant, C, 3))


def _fusion_keys(variant, seed=0) -> dict:
    """Reference-name fusion keys of a seeded port model at MINI, with
    running statistics that are not the init's."""
    model = SAM2Model(port_config(_jcfg(variant)))
    init_random_(model, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for name, b in model.named_buffers():
        b.copy_(torch.rand(b.shape, generator=g) + 0.5 if name.endswith(".var")
                else torch.randn(b.shape, generator=g) * 0.1)
    sd = {k: v for k, v in model.state_dict().items() if k.startswith("temporal_fusion_")}
    ref = chip_smoke.to_reference_state_dict(sd, model.cfg)
    return {k: v.numpy() for k, v in ref.items()}


def _checkpoint(variant):
    sd, _ = _fixture("mini")
    sd.update(_fusion_keys(variant))
    return sd


@pytest.mark.parametrize("variant", FUSED)
def test_inverse_fusion_map_gives_the_reference_fixture_back(variant):
    """Reference fixture module -> the JAX mapping -> the port's names ->
    chip_smoke's inverse: the fixture's keys and shapes, and its values but
    those the importer drops (num_batches_tracked, written back as 0, and
    TCE's unused temporal_conv, as zeros)."""
    fx = np.load(require_fixture("temporal_fusion.npz"))
    sd = {f"temporal_fusion.0.{k[len(variant) + 4:]}": fx[k] for k in fx.files if k.startswith(f"{variant}_sd.")}
    from us_video_medsam2_tpu.core.import_torch import convert_fusion_module

    params, stats = convert_fusion_module(sd, variant, prefix="temporal_fusion.0.")
    port = from_jax_params({"params": {"temporal_fusion_0": params}, "batch_stats": {"temporal_fusion_0": stats}})
    cfg = port_config(dataclasses.replace(MINI, temporal_fusion=jconfig.TemporalFusionConfig(variant, 32, 1)))
    back = chip_smoke.to_reference_state_dict(port, cfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert tuple(back[k].shape) == v.shape, k
        if not k.endswith("num_batches_tracked") and not k.endswith("temporal_conv.weight"):
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("variant", FUSED)
def test_fusion_checkpoint_imports_as_jax_buffers_included(variant):
    sd, jcfg = _checkpoint(variant), _jcfg(variant)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    got = timport.convert_reference_state_dict(sd, port_config(jcfg))
    want_vars = jax_convert(sd, jcfg)
    assert sorted(want_vars) == ["batch_stats", "params"]
    _assert_sd_equal(got, from_jax_params(want_vars, port_config(jcfg)))
    bufs = [k for k in got if k.endswith((".mean", ".var"))]
    n_bn = {"tce": 2, "gfte": 2, "atsf": 3}[variant]
    assert len(bufs) == 3 * 2 * n_bn
    model = SAM2Model(port_config(jcfg))
    model.load_state_dict(got, strict=True)
    assert {k for k, _ in model.named_buffers()} == set(bufs)


def test_gp_checkpoint_raises_as_jax():
    sd, jcfg = _checkpoint("gfte"), _jcfg("gp")
    with pytest.raises(ValueError, match="'gp'") as terr:
        timport.convert_reference_state_dict(sd, port_config(jcfg))
    with pytest.raises(ValueError) as jerr:
        jax_convert(sd, jcfg)
    assert str(terr.value) == str(jerr.value)


def test_unknown_or_missing_fusion_key_raises():
    sd, cfg = _checkpoint("gfte"), port_config(_jcfg("gfte"))
    extra = dict(sd, **{"temporal_fusion.1.extra_proj.weight": np.zeros((C, C), np.float32)})
    with pytest.raises(KeyError, match="extra_proj"):
        timport.convert_reference_state_dict(extra, cfg)
    missing = {k: v for k, v in sd.items() if k != "temporal_fusion.2.norm2.running_var"}
    with pytest.raises(KeyError, match="running_var"):
        timport.convert_reference_state_dict(missing, cfg)
    two_levels = {k: v for k, v in sd.items() if not k.startswith("temporal_fusion.2.")}
    with pytest.raises(RuntimeError, match="temporal_fusion_2"):
        timport.convert_reference_state_dict(two_levels, cfg)


def test_native_npz_with_batch_stats_and_pt_load(tmp_path):
    """A JAX trainer's checkpoint holds the variables, ``{"params",
    "batch_stats"}``, under "params"; both it and a reference-name .pt load."""
    sd, jcfg = _checkpoint("gfte"), _jcfg("gfte")
    cfg = port_config(jcfg)
    variables = jax_convert(sd, jcfg)
    jckpt.save_checkpoint(str(tmp_path / "native"), {"params": variables, "step": 3})
    want = from_jax_params(variables, cfg)
    _assert_sd_equal(load_params(cfg, str(tmp_path / "native.npz")), want)
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, tmp_path / "ref.pt")
    for name in ("native.npz", "ref.pt"):
        _assert_sd_equal(build_sam2(cfg, ckpt_path=str(tmp_path / name)).state_dict(), want)
    with pytest.raises(RuntimeError, match="temporal_fusion"):  # the same file, a config without fusion
        load_params(port_config(MINI), str(tmp_path / "native.npz"))


# --------------------------------------------------------------------- YAML
@pytest.mark.parametrize("path", YAMLS)
def test_yaml_config_equals_the_jax_reader(path):
    got = tconfig.resolve_config(path)
    want = port_config(jconfig.load_yaml_config(path))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got == want and got != tconfig.resolve_config("sam2.1_hiera_t512")


def test_gfte_yaml_is_the_t512_preset_with_gfte():
    got = tconfig.resolve_config("configs/gfte_tpu.yaml")
    assert got.temporal_fusion == tconfig.TemporalFusionConfig("gfte", 256, 3)
    assert dataclasses.replace(got, temporal_fusion=tconfig.TemporalFusionConfig()) == tconfig.resolve_config(
        "sam2.1_hiera_t512")


def test_resolve_refs_matches_jax():
    data = {"scratch": {"res": 512, "stride": 16, "n": 3, "frames": 8},
            "model": {"feat": "${divide:scratch.res,scratch.stride}", "tok": "${times:scratch.n,4,2}",
                      "left": "${minus:scratch.frames,1}", "sum": "${add:1,scratch.n,2.5}",
                      "ref": "${scratch.res}", "list": ["${scratch.n}", 7, "plain"], "plain": "text"}}
    got = tconfig._resolve_refs(data, data)
    assert got == jconfig._resolve_refs(data, data)
    assert got["model"] == {"feat": 32.0, "tok": 24, "left": 7, "sum": 6.5, "ref": 512,
                            "list": [3, 7, "plain"], "plain": "text"}
    bad = {"a": "${modulo:1,2}"}
    with pytest.raises(ValueError, match="modulo"):
        tconfig._resolve_refs(bad, bad)


def test_build_from_a_yaml_path_and_unknown_keys_raise(tmp_path):
    path = tmp_path / "tiny_gfte.yaml"
    path.write_text("scratch:\n  d: 32\nmodel:\n  image_size: 64\n  hiera:\n    embed_dim: 8\n"
                    "    stages: [1, 1, 1, 1]\n    global_att_blocks: []\n    window_spec: [4, 2, 2, 2]\n"
                    "    window_pos_embed_bkg_spatial_size: [2, 2]\n"
                    "  neck:\n    d_model: ${scratch.d}\n    backbone_channel_list: [64, 32, 16, 8]\n"
                    "  memory_attention:\n    d_model: 32\n    num_layers: 1\n    dim_feedforward: 64\n"
                    "    rope_feat_sizes: [4, 4]\n    kv_in_dim: 8\n"
                    "  memory_encoder:\n    out_dim: 8\n    in_dim: 32\n    mask_downsampler_embed_dim: 32\n"
                    "    pos_channels: 8\n"
                    "  temporal_fusion:\n    variant: gfte\n    channels: ${scratch.d}\n    num_levels: 3\n")
    model = build_sam2(str(path), seed=0)
    want = dataclasses.replace(tconfig.tiny64_test(), temporal_fusion=tconfig.TemporalFusionConfig("gfte", 32, 3),
                               dynamic_multimask_via_stability=True, binarize_mask_from_pts_for_mem_enc=True)
    assert model.cfg == want and model.n_fusion == 3
    assert model.temporal_fusion_0.alpha.item() == pytest.approx(0.1)
    bad = tmp_path / "bad.yaml"
    bad.write_text("model:\n  temporal_fusion:\n    variant: gfte\n    heads: 8\n")
    with pytest.raises(KeyError, match="heads"):
        tconfig.load_yaml_config(str(bad))
    with pytest.raises(KeyError, match="heads"):
        jconfig.load_yaml_config(str(bad))


# ------------------------------------------------------------------ serving
def test_predictor_with_gfte_weights_matches_jax_and_serves_as_without_fusion():
    """The predictor encodes a frame at a time and passes no num_frames, so
    a GFTE config serves exactly what the same weights serve without it."""
    from us_video_medsam2_tpu.inference.video_predictor import SAM2VideoPredictor as JaxPredictor
    from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
    from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor
    from tests.torch_port_helpers import nchw_to_nhwc

    sd, jcfg = _checkpoint("gfte"), _jcfg("gfte")
    variables = jax_convert(sd, jcfg)
    port_sd = timport.convert_reference_state_dict(sd, port_config(jcfg))
    plain_sd = {k: v for k, v in port_sd.items() if not k.startswith("temporal_fusion_")}
    images = nchw_to_nhwc(np.load(require_fixture("predictor_video.npz"))["images"])[:4]
    low = 4 * MINI.feat_size

    def run(pred, imgs):
        state = pred.init_state(imgs, low, low)
        pred.add_new_points_or_box(state, 0, 1, points=np.array([[30.0, 20.0]]), labels=np.array([1]))
        return {t: np.asarray(m) for t, _, m in pred.propagate_in_video(state)}

    results = {}
    for name, cfg, weights in (("gfte", jcfg, port_sd), ("none", MINI, plain_sd)):
        model = SAM2Model(port_config(cfg))
        model.load_state_dict(weights, strict=True)
        results[name] = run(SAM2VideoPredictor(model.eval(), fill_hole_area=8, device="cpu"), images)
    jmasks = run(JaxPredictor(JaxSAM2Model(jcfg), variables, fill_hole_area=8), jnp.asarray(images))
    assert sorted(results["gfte"]) == [0, 1, 2, 3]
    for t in results["gfte"]:
        np.testing.assert_array_equal(results["gfte"][t], results["none"][t])
    assert_masks_close(results["gfte"], jmasks, "gfte predictor")
