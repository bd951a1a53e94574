"""PyTorch port, training switches of the model against the JAX package at
the TINY config (tests/test_train_step.py) with the JAX initialiser's
weights: ``sam_heads``, ``encode_memory`` and ``select_memories`` with
``is_training`` on and off. The whole-step settings of
tests/test_torch_training.py do not reach every one of these branches
(mask prompts take no single-mask head call in training). f32 on the CPU;
1e-4 relative (the same math, reassociated), memory selection exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_training import SIZE, TINY, _jax_setup, _port_model
from tests.torch_port_helpers import port_config, t
from us_video_medsam2_tpu.models import memory_bank as jbank
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.models import memory_bank as tbank


def _pair_models(**overrides):
    """(JAX model, params, port model) at a variant of the TINY config, same weights."""
    base, _, params = _jax_setup()
    cfg = dataclasses.replace(base, **overrides)
    return JaxSAM2Model(cfg), params, _port_model(cfg, params)


@pytest.mark.parametrize("multimask", [True, False])
def test_sam_heads_training_branch_matches_jax(multimask):
    """is_training: no stability fallback on a single mask; every multimask
    channel upsampled to image resolution."""
    jmodel, params, model = _pair_models()
    rng = np.random.default_rng(11)
    b = 3
    feats = [rng.standard_normal(s).astype(np.float32) for s in ((b, 4, 4, 32), (b, 16, 16, 4), (b, 8, 8, 8))]
    coords = (rng.random((b, 4, 2)) * SIZE).astype(np.float32)
    labels = np.array([[1, 0, -1, -1], [2, 3, 1, -1], [1, -1, -1, -1]], np.int32)
    mask_in = rng.standard_normal((b, 16, 16, 1)).astype(np.float32)
    for mi in (None, mask_in):
        want = jmodel.apply(params, jnp.asarray(feats[0]), jnp.asarray(coords), jnp.asarray(labels),
                            None if mi is None else jnp.asarray(mi), [jnp.asarray(f) for f in feats[1:]],
                            multimask, True, method=jmodel.sam_heads)
        with torch.no_grad():
            got = model.sam_heads(t(feats[0]), t(coords), t(labels), None if mi is None else t(mi),
                                  [t(f) for f in feats[1:]], multimask_output=multimask, is_training=True)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("is_training", [True, False])
def test_encode_memory_training_switch_matches_jax(is_training):
    """Training skips the non-overlap constraint and the binarized click mask."""
    jmodel, params, model = _pair_models(binarize_mask_from_pts_for_mem_enc=True,
                                         non_overlap_masks_for_mem_enc=True)
    rng = np.random.default_rng(12)
    feat = rng.standard_normal((3, 4, 4, 32)).astype(np.float32)
    masks = (4 * rng.standard_normal((3, 1, SIZE, SIZE))).astype(np.float32)
    score = np.array([[3.0], [-2.0], [1.0]], np.float32)
    want = jmodel.apply(params, *(jnp.asarray(a) for a in (feat, masks, score)), True, is_training,
                        method=jmodel.encode_memory)
    with torch.no_grad():
        got = model.encode_memory(t(feat), t(masks), t(score), True, is_training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("is_training", [True, False])
def test_select_memories_training_switch_matches_jax(is_training):
    """Training: stride 1 for the non-conditioning slots, and conditioning
    pointers from the future too (here the eval stride is 3)."""
    cfg = dataclasses.replace(TINY, memory_temporal_stride_for_eval=3)
    rng = np.random.default_rng(13)
    s = 12
    valid = rng.random((2, s)) > 0.2
    is_cond = valid & (rng.random((2, s)) > 0.6)
    tb = tbank.init_memory_bank(2, s, 4, 8, 16)
    tb.valid[:], tb.is_cond[:] = t(valid), t(is_cond)
    jb = jbank.init_memory_bank(2, s, 4, 8, 16).replace(valid=jnp.asarray(valid), is_cond=jnp.asarray(is_cond))
    for frame in (0, 5, 11):
        got = tbank.select_memories(tb, frame, port_config(cfg), s, is_training=is_training)
        want = jbank.select_memories(jb, frame, cfg, s, is_training=is_training)
        mv, pv = got.mem_valid.numpy(), got.ptr_valid.numpy()
        assert np.array_equal(mv, np.asarray(want.mem_valid))
        assert np.array_equal(pv, np.asarray(want.ptr_valid))
        assert np.array_equal(got.mem_idx.numpy()[mv], np.asarray(want.mem_idx)[mv])
        assert np.array_equal(got.ptr_idx.numpy()[pv], np.asarray(want.ptr_idx)[pv])
        assert np.array_equal(got.ptr_pos.numpy()[pv], np.asarray(want.ptr_pos)[pv])
