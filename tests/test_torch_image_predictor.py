"""PyTorch port: the image path (inference/image_predictor.py,
transforms.postprocess_masks, core/build.py::build_sam2_image_predictor) on
the CPU against the JAX package at the MINI config (fixture weights).

Every ``predict`` mode (a point, a box, box + point, a mask input,
multimask on and off, logits), ``set_image_batch`` with one prompt tiled
over the images, ``predict_batch_points`` and ``postprocess_masks`` with
holes and sprinkles, with and without post-processing: the logits at the
JAX predictor tests' tolerances (rtol and atol 1e-3), masks at IoU > 0.999,
IoU predictions within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parity import MINI
from tests.torch_port_helpers import iou, mini_port_model, mini_weights
from us_video_medsam2_tpu.inference.image_predictor import SAM2ImagePredictor as JaxImagePredictor
from us_video_medsam2_tpu.inference.transforms import postprocess_masks as jax_postprocess
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.inference.image_predictor import SAM2ImagePredictor
from us_video_medsam2_tpu_torch.inference.transforms import postprocess_masks

AREAS = {"plain": 0, "postprocessed": 8}


def _image(seed, h=200, w=180):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 80).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[((yy - 100) ** 2 + (xx - 90) ** 2) < 45**2] += 150  # one bright disc
    return img


@pytest.fixture(scope="module")
def image_predictors():
    params, _ = mini_weights()
    jp = JaxImagePredictor(JaxSAM2Model(MINI), params)
    tp = SAM2ImagePredictor(mini_port_model(), device="cpu")
    img = _image(0)
    jp.set_image(img)
    tp.set_image(img)
    return jp, tp


@pytest.fixture(params=sorted(AREAS))
def predictors(image_predictors, request):
    """Both predictors on one image, their post-processing areas set (the
    areas act outside the JAX predictor's jitted heads)."""
    for p in image_predictors:
        p.max_hole_area = p.max_sprinkle_area = AREAS[request.param]
    return image_predictors


def _close(got, want, what):
    for a, b, name in zip(got, want, ("masks", "ious", "low")):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if a.dtype == bool:
            for m in range(b.shape[0]):
                assert iou(a[m], b[m]) > 0.999, (what, name, m)
        else:
            np.testing.assert_allclose(a, b.astype(a.dtype), rtol=1e-3, atol=1e-3, err_msg=f"{what} {name}")


MODES = {
    "point, multimask": dict(point_coords=np.array([[90.0, 100.0]]), point_labels=np.array([1])),
    "point, one mask": dict(point_coords=np.array([[90.0, 100.0]]), point_labels=np.array([1]),
                            multimask_output=False),
    "box": dict(box=np.array([30, 40, 150, 160]), multimask_output=False),
    "box + points": dict(box=np.array([30, 40, 150, 160]), point_coords=np.array([[90.0, 100.0], [20.0, 20.0]]),
                         point_labels=np.array([1, 0])),
    "point, logits": dict(point_coords=np.array([[60.0, 130.0]]), point_labels=np.array([1]), return_logits=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_predict_matches_jax(predictors, mode):
    jp, tp = predictors
    got, want = tp.predict(**MODES[mode]), jp.predict(**MODES[mode])
    _close(got, want, mode)
    assert got[0].shape[1:] == (200, 180) and got[2].shape[1:] == (4 * MINI.feat_size,) * 2


def test_predict_with_mask_input_matches_jax(predictors):
    jp, tp = predictors
    _, ious, low = jp.predict(point_coords=np.array([[90.0, 100.0]]), point_labels=np.array([1]))
    kw = dict(point_coords=np.array([[90.0, 100.0]]), point_labels=np.array([1]),
              mask_input=np.asarray(low)[np.argmax(ious)], multimask_output=False)
    _close(tp.predict(**kw), jp.predict(**kw), "mask input")


def test_predict_batch_points_matches_jax(predictors):
    jp, tp = predictors
    rng = np.random.default_rng(2)
    pts = rng.uniform(10, 170, (6, 1, 2)).astype(np.float32)
    lbl = np.ones((6, 1), np.int32)
    got, want = tp.predict_batch_points(pts, lbl), jp.predict_batch_points(pts, lbl)
    assert got[0].shape == (6, 3, 200, 180)
    _close(got, want, "batch points")


def test_set_image_batch_matches_jax():
    params, _ = mini_weights()
    jp = JaxImagePredictor(JaxSAM2Model(MINI), params)
    tp = SAM2ImagePredictor(mini_port_model(), device="cpu")
    imgs = [_image(s, 64, 72) for s in (1, 2)]
    jp.set_image_batch(imgs)
    tp.set_image_batch(imgs)
    assert tp._features["top"].shape[0] == 2
    kw = dict(point_coords=np.array([[32.0, 30.0]]), point_labels=np.array([1]))
    _close(tp.predict(**kw), jp.predict(**kw), "batch of images")
    with pytest.raises(ValueError):
        tp.set_image_batch([imgs[0], imgs[0][:10]])


def test_predict_needs_an_image_and_a_prompt():
    tp = SAM2ImagePredictor(mini_port_model(), device="cpu")
    with pytest.raises(RuntimeError):
        tp.predict(point_coords=np.array([[1.0, 1.0]]), point_labels=np.array([1]))
    tp.set_image(_image(3, 40, 40))
    with pytest.raises(ValueError):
        tp.predict()


@pytest.mark.parametrize("areas", [(0, 0), (8, 0), (0, 8), (8, 8)])
def test_postprocess_masks_matches_jax(areas):
    rng = np.random.default_rng(5)
    low = rng.uniform(1.0, 4.0, (2, 3, 64, 64)).astype(np.float32) * np.where(
        np.arange(64)[None, None, :, None] < 40, 1, -1)
    low[:, :, 10:12, 10:13] = -2.0  # a 6-px hole
    low[:, :, 50, 50] = 3.0  # a 1-px sprinkle in the background
    low[:, :, 55:58, 20:23] = 2.0  # a 9-px island, kept at 8
    got = postprocess_masks(torch.from_numpy(low), (200, 180), *areas).numpy()
    want = np.asarray(jax_postprocess(jnp.asarray(low), (200, 180), *areas))
    assert got.shape == (2, 3, 200, 180)
    # f32 resizes: JAX's separable matrix products against interpolate
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if areas == (8, 8):
        small = postprocess_masks(torch.from_numpy(low), (64, 64), *areas).numpy()
        assert (small[:, :, 10:12, 10:13] == np.float32(0.1)).all() and (small[:, :, 50, 50] == -10.0).all()
        assert (small[:, :, 55:58, 20:23] == 2.0).all()


def test_build_sam2_image_predictor_on_the_cpu():
    from us_video_medsam2_tpu_torch.core.build import build_sam2_image_predictor

    pred = build_sam2_image_predictor("tiny64_test", device="cpu", dtype=torch.float32)
    assert (pred.max_hole_area, pred.max_sprinkle_area) == (8, 8)
    assert pred.model.cfg.dynamic_multimask_via_stability
    bare = build_sam2_image_predictor("tiny64_test", device="cpu", dtype=torch.float32, apply_postprocessing=False)
    assert (bare.max_hole_area, bare.max_sprinkle_area) == (0, 0)
    pred.set_image(_image(6, 50, 70))
    masks, ious, low = pred.predict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1]))
    assert masks.shape == (3, 50, 70) and masks.dtype == bool and np.isfinite(ious).all()
