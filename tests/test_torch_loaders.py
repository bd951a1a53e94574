"""PyTorch port: the two weight loaders that need no JAX, against the JAX package's.

1. ``core/import_torch.py``: on ``mini_state_dict.npz`` (MINI, Hiera) and
   ``efftam_state_dict.npz`` (MINI_EFF, ViTDet) the port's state_dict equals
   ``from_jax_params`` of the JAX importer's tree, key for key and bit for
   bit; a ``.pt`` with and without a ``"model"`` key loads the same; a key no
   parameter takes, a missing parameter, a wrong shape and a
   ``temporal_fusion.0.*`` key under a config without fusion each raise.
2. ``core/checkpoint.py``: a native ``.npz`` written by the JAX package's
   ``save_checkpoint`` restores to the same tree and state_dict (empty
   subtrees and scalars included); an unmarked checkpoint raises with JAX's
   message; an interleaved one with ``rope_num_heads`` migrates to JAX's
   result, as does ``migrate_rope_layout``.
3. ``core/build.py::load_params`` / ``build_sam2(ckpt_path=...)`` for each
   file kind.
4. ``chip_smoke.py``'s inverse key map: fixture -> the port's importer ->
   the inverse gives the fixture's keys and values bit for bit; the seeded
   full-width t512 state_dict survives the round trip through the reference
   names.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from tests.conftest import require_fixture
from tests.test_efficienttam import MINI_EFF
from tests.test_parity import MINI
from tests.torch_port_helpers import port_config
from us_video_medsam2_tpu.core import checkpoint as jckpt
from us_video_medsam2_tpu.core.import_torch import convert_reference_state_dict as jax_convert
from us_video_medsam2_tpu_torch.core import checkpoint as tckpt
from us_video_medsam2_tpu_torch.core import import_torch as timport
from us_video_medsam2_tpu_torch.core.build import build_sam2, load_params
from us_video_medsam2_tpu_torch.core.weights import from_jax_params

FIXTURES = {"mini": ("mini_state_dict.npz", MINI), "efftam": ("efftam_state_dict.npz", MINI_EFF)}


def _fixture(name):
    path, cfg = FIXTURES[name]
    return dict(np.load(require_fixture(path))), cfg


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want), (sorted(set(got) ^ set(want)))[:5]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_importer_equals_jax_importer_then_from_jax_params(name):
    sd, cfg = _fixture(name)
    got = timport.convert_reference_state_dict(sd, port_config(cfg))
    _assert_sd_equal(got, from_jax_params(jax_convert(sd, cfg), port_config(cfg)))


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("wrapped", [False, True])
def test_pt_with_and_without_model_key(tmp_path, name, wrapped):
    sd, cfg = _fixture(name)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    path = tmp_path / "ckpt.pt"
    torch.save({"model": tsd, "epoch": 3} if wrapped else tsd, path)
    want = timport.convert_reference_state_dict(sd, port_config(cfg))
    _assert_sd_equal(timport.load_torch_checkpoint(str(path), port_config(cfg)), want)
    _assert_sd_equal(load_params(port_config(cfg), str(path)), want)


def test_extra_key_raises():
    sd, cfg = _fixture("mini")
    sd["sam_mask_decoder.unused_head.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused_head"):
        timport.convert_reference_state_dict(sd, port_config(cfg))


@pytest.mark.parametrize("key", ["sam_mask_decoder.iou_token.weight", "no_obj_ptr",
                                 "sam_mask_decoder.conv_s0.weight"])
def test_missing_key_raises(key):
    sd, cfg = _fixture("mini")
    del sd[key]
    with pytest.raises((KeyError, RuntimeError)):
        timport.convert_reference_state_dict(sd, port_config(cfg))


def test_wrong_shape_raises():
    sd, cfg = _fixture("mini")
    sd["no_obj_ptr"] = np.zeros((1, 65), np.float32)
    with pytest.raises(RuntimeError, match="no_obj_ptr"):
        timport.convert_reference_state_dict(sd, port_config(cfg))


def test_temporal_fusion_keys_raise_naming_a5():
    """Fusion keys under a config without temporal fusion raise, as in JAX
    (tests/test_torch_fusion_loaders.py loads them under a fusion config)."""
    sd, cfg = _fixture("mini")
    sd["temporal_fusion.0.alpha"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="fusion variant 'none'") as terr:
        timport.convert_reference_state_dict(sd, port_config(cfg))
    with pytest.raises(ValueError) as jerr:
        jax_convert(sd, cfg)
    assert str(terr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def mini_params():
    sd, cfg = _fixture("mini")
    return jax_convert(sd, cfg)


def test_native_npz_restores_to_the_same_state_dict(tmp_path, mini_params):
    state = {"params": mini_params, "opt_state": {"empty": {}, "count": np.int32(7)}, "step": 12}
    path = str(tmp_path / "checkpoint")
    jckpt.save_checkpoint(path, state)
    got = tckpt.restore_checkpoint(path)
    want = jckpt.restore_checkpoint(path)
    assert got["step"] == want["step"] == 12 and got["opt_state"]["empty"] == {}
    flat_g, flat_w = tckpt._flatten(got), jckpt._flatten(want)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[k]), np.asarray(flat_w[k]), err_msg=k)
    cfg = port_config(MINI)
    want_sd = from_jax_params(mini_params, cfg)
    _assert_sd_equal(from_jax_params(tckpt.restore_params(path), cfg), want_sd)
    _assert_sd_equal(load_params(cfg, path + ".npz"), want_sd)


def _unmarked(tmp_path, params):
    """A native checkpoint without its format marker (written before it)."""
    path = str(tmp_path / "old.npz")
    np.savez(path, **{f"params/{k}": np.asarray(v) for k, v in jckpt._flatten(params).items()})
    return path


def test_unmarked_checkpoint_raises_as_jax(tmp_path, mini_params):
    path = _unmarked(tmp_path, mini_params)
    with pytest.raises(RuntimeError) as jerr:
        jckpt.restore_params(path)
    with pytest.raises(RuntimeError) as terr:
        tckpt.restore_params(path)
    assert str(terr.value) == str(jerr.value) and "half-split" in str(terr.value)
    with pytest.raises(RuntimeError, match="half-split"):
        load_params(port_config(MINI), path)


def test_interleaved_checkpoint_migrates_as_jax(tmp_path, mini_params):
    path = _unmarked(tmp_path, mini_params)
    heads = MINI.memory_attention.num_heads
    got = tckpt.restore_params(path, assume_rope_layout="interleaved", rope_num_heads=heads)
    want = jckpt.restore_params(path, assume_rope_layout="interleaved", rope_num_heads=heads)
    cfg = port_config(MINI)
    _assert_sd_equal(from_jax_params(got, cfg), from_jax_params(want, cfg))
    moved = from_jax_params(got, cfg)
    same = from_jax_params(mini_params, cfg)
    q = "memory_attention.layers_0.self_attn.q_proj.weight"
    assert not torch.equal(moved[q], same[q])  # the q/k channels were permuted
    with pytest.raises(RuntimeError, match="rope_num_heads"):
        tckpt.restore_params(path, assume_rope_layout="interleaved")
    _assert_sd_equal(from_jax_params(tckpt.restore_params(path, assume_rope_layout="halfsplit"), cfg), same)


def test_migrate_rope_layout_matches_jax(mini_params):
    cfg = port_config(MINI)
    got = tckpt.migrate_rope_layout(mini_params, 2)
    want = jckpt.migrate_rope_layout(mini_params, 2)
    _assert_sd_equal(from_jax_params(got, cfg), from_jax_params(want, cfg))


def test_meta_json_marker_is_what_the_reader_checks(tmp_path, mini_params):
    path = str(tmp_path / "ck")
    jckpt.save_checkpoint(path, {"params": mini_params})
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["_ckpt_format/rope_layout"] == tckpt.CKPT_ROPE_LAYOUT
    assert meta["_ckpt_format/version"] == tckpt.CKPT_FORMAT_VERSION


def test_build_from_each_kind_of_file(tmp_path, mini_params):
    """.pt, a reference-name .npz and a native .npz build the same model; a
    checkpoint of another configuration raises."""
    sd, _ = _fixture("mini")
    cfg = port_config(MINI)
    np.savez(tmp_path / "ref.npz", **sd)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "ref.pt")
    jckpt.save_checkpoint(str(tmp_path / "native"), {"params": mini_params})
    want = from_jax_params(mini_params, cfg)
    for name in ("ref.npz", "ref.pt", "native.npz"):
        model = build_sam2(cfg, ckpt_path=str(tmp_path / name))
        _assert_sd_equal(model.state_dict(), want)
    with pytest.raises((RuntimeError, KeyError)):
        build_sam2("tiny64_test", ckpt_path=str(tmp_path / "ref.pt"))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_smoke_inverse_key_map_gives_the_fixture_back(name):
    """chip_smoke.py writes the card's reference-name checkpoint with its own
    inverse of the importer: fixture -> importer -> inverse is the fixture."""
    sd, cfg = _fixture(name)
    back = chip_smoke.to_reference_state_dict(timport.convert_reference_state_dict(sd, port_config(cfg)),
                                              port_config(cfg))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32 and tuple(back[k].shape) == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_smoke_checkpoint_of_t512_loads_back_bit_for_bit(tmp_path):
    """The seeded full-width t512 model through the reference names and a .pt
    under "model", as chip_smoke.py phase 8 (a) writes it, and back."""
    model = build_sam2("sam2.1_hiera_t512", seed=0)
    want = model.state_dict()
    path = tmp_path / "t512.pt"
    torch.save({"model": chip_smoke.to_reference_state_dict(want, model.cfg)}, path)
    _assert_sd_equal(build_sam2("sam2.1_hiera_t512", ckpt_path=str(path)).state_dict(), want)
