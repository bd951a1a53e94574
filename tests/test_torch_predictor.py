"""PyTorch port: the video predictor slice (init_state, add_new_points_or_box,
add_new_mask, propagate_in_video) at the MINI config on the CPU.

1. Against the reference SAM2VideoPredictorNPZ fixture, as
   tests/test_video_predictor.py holds the JAX predictor: mask IoU > 0.99 per
   frame and object, logits within 0.15.
2. Against the JAX predictor on the same 4-frame video, a mask prompt and a
   click for two objects, hole filling on: low-res logits per frame within
   1e-3 of the frame's largest logit (both sides keep a bf16 memory bank, so
   roundings of the stored memories may differ by one ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import require_fixture
from tests.test_parity import MINI
from tests.torch_port_helpers import mini_port_model, mini_weights, nchw_to_nhwc
from us_video_medsam2_tpu.inference.video_predictor import SAM2VideoPredictor as JaxPredictor
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor


def _iou(a, b):
    a, b = a > 0, b > 0
    union = (a | b).sum()
    return 1.0 if union == 0 else (a & b).sum() / union


@pytest.fixture(scope="module")
def fx():
    return np.load(require_fixture("predictor_video.npz"))


def _run_port(fx, fill_hole_area=0):
    pred = SAM2VideoPredictor(mini_port_model(), fill_hole_area=fill_hole_area, device="cpu")
    state = pred.init_state(nchw_to_nhwc(fx["images"]), 200, 180, max_objects=2)
    pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
    out = pred.add_new_points_or_box(state, 1, 2, points=np.array([[30.0, 150.0]]),
                                     labels=np.array([1]))
    got = {("fwd", t): m for t, _, m in pred.propagate_in_video(state)}
    got.update({("rev", t): m for t, _, m in pred.propagate_in_video(state, reverse=True)})
    return out, got, state


def test_predictor_matches_reference_fixture(fx):
    (_, obj_ids, prompt_masks), got, _ = _run_port(fx)
    assert obj_ids == [1, 2]
    np.testing.assert_allclose(prompt_masks, fx["prompt_masks"], rtol=0.05, atol=0.05)
    ref_keys = sorted(k for k in fx.files if k.startswith(("fwd_", "rev_")))
    assert {(k.split("_")[0], int(k.split("_")[1])) for k in ref_keys} == set(got)
    for k in ref_keys:
        d, t = k.split("_")
        mine, ref = got[(d, int(t))], fx[k]
        assert mine.shape == ref.shape, (k, mine.shape, ref.shape)
        for o in range(ref.shape[0]):
            assert _iou(mine[o, 0], ref[o, 0]) > 0.99, (k, o)
        np.testing.assert_allclose(mine, ref, rtol=0.15, atol=0.15, err_msg=k)


def test_prompted_frames_are_conditioning_memories(fx):
    _, got, state = _run_port(fx)
    assert sorted(t for d, t in got if d == "fwd") == [1, 2, 3, 4]
    assert sorted(t for d, t in got if d == "rev") == [0, 1]
    assert state.bank.valid.all() and state.bank.is_cond[:, 1].all()
    assert not state.bank.is_cond[:, [0, 2, 3, 4]].any()
    assert not state.prompt_feats and not state.pending


def test_max_frame_num_to_track_bounds_tracking_and_bank(fx):
    pred = SAM2VideoPredictor(mini_port_model(), fill_hole_area=0, device="cpu")
    state = pred.init_state(nchw_to_nhwc(fx["images"]), 200, 180, max_objects=2)
    pred.add_new_mask(state, 1, 1, fx["mask_prompt"])
    yielded = [t for t, _, _ in pred.propagate_in_video(state, max_frame_num_to_track=2)]
    assert yielded == [1, 2, 3]
    valid = state.bank.valid[0].numpy()
    assert not valid[4] and not valid[0] and valid[1:4].all()


def test_predictor_matches_jax_predictor(fx):
    """Same weights, same 4-frame video, a mask prompt and a click on frame 0
    for two objects, hole filling on. The video resolution equals the low-res
    mask size, so the yielded logits are the low-res logits themselves."""
    predictor_matches_jax_predictor(fx)


def predictor_matches_jax_predictor(fx):
    images = nchw_to_nhwc(fx["images"])[:4]
    low = 4 * MINI.feat_size
    params, _ = mini_weights()
    jpred = JaxPredictor(JaxSAM2Model(MINI), params, fill_hole_area=8)
    tpred = SAM2VideoPredictor(mini_port_model(), fill_hole_area=8, device="cpu")
    results = []
    for pred, imgs, mask in ((jpred, jnp.asarray(images), jnp.asarray(fx["mask_prompt"])),
                             (tpred, images, fx["mask_prompt"])):
        state = pred.init_state(imgs, low, low, max_objects=2)
        pred.add_new_mask(state, 0, 1, mask)
        _, _, prompt = pred.add_new_points_or_box(state, 0, 2, points=np.array([[8.0, 40.0]]),
                                                  labels=np.array([1]))
        frames = {t: np.asarray(m) for t, _, m in pred.propagate_in_video(state)}
        results.append((np.asarray(prompt), frames))
    (jprompt, jframes), (tprompt, tframes) = results
    np.testing.assert_allclose(tprompt, jprompt, rtol=1e-4, atol=1e-4)
    assert 0.05 < (jprompt[0] > 0).mean() < 0.5  # the mask prompt gives a real mask
    assert sorted(tframes) == sorted(jframes) == [0, 1, 2, 3]
    for t in range(4):
        assert tframes[t].shape == jframes[t].shape == (2, 1, low, low)
        # untrained weights: tracked logits are small (hole filling writes 0.1),
        # so the tolerance follows the frame's scale; the logits must vary
        scale = np.abs(jframes[t]).max()
        assert jframes[t].std() > 0.05 * scale, t
        for o in range(2):
            assert _iou(tframes[t][o], jframes[t][o]) > 0.99, (t, o)
        np.testing.assert_allclose(tframes[t], jframes[t], rtol=1e-3, atol=1e-3 * scale, err_msg=str(t))


def test_smoke_script_main_path_on_cpu(monkeypatch):
    """chip_smoke.py's main-path run at tiny64 on the CPU, and its refusal
    to run without a card."""
    import torch

    import chip_smoke
    from us_video_medsam2_tpu_torch.core.build import build_sam2

    pred = SAM2VideoPredictor(build_sam2("tiny64_test", seed=0), fill_hole_area=8, device="cpu")
    video, click, _ = chip_smoke.make_video(5, 64, seed=0)
    assert video.shape == (5, 64, 64, 3) and video.dtype == np.uint8
    masks, t_prompt, t_prop = chip_smoke.run_main_path(pred, video, click)
    assert sorted(masks) == [0, 1, 2, 3, 4] and t_prompt > 0 and t_prop > 0
    assert all(m.shape == (1, 64, 64) and np.isfinite(m).all() for m in masks.values())
    first, _, _ = chip_smoke.run_main_path(pred, video, click, stop_after=2)
    assert sorted(first) == [0, 1]
    np.testing.assert_array_equal(first[1], masks[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) == 2
