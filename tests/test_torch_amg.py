"""PyTorch port: the automatic mask generator (inference/amg.py and
inference/automatic_mask_generator.py) on the CPU against the JAX package.

The numpy helpers exactly (RLE round trip, grids, crops, NMS, stability
score, boxes); ``remove_small_regions``, which labels with scipy where JAX
calls cv2, in both modes against JAX's cv2 result; ``generate`` at
tests/test_amg.py's settings, again with ``crop_n_layers=1`` and
``min_mask_region_area > 0``, and at the default thresholds: the same mask
count, masks matched at IoU > 0.999, scores within 1e-3; ``refine_with_m2m``
at the image predictor tests' tolerances.
"""

import numpy as np
import pytest

from tests.test_parity import MINI
from tests.torch_port_helpers import iou, mini_port_model, mini_weights
from us_video_medsam2_tpu.inference import amg as jamg
from us_video_medsam2_tpu.inference.automatic_mask_generator import (
    SAM2AutomaticMaskGenerator as JaxAMG,
)
from us_video_medsam2_tpu.inference.image_predictor import SAM2ImagePredictor as JaxImagePredictor
from us_video_medsam2_tpu.models.sam2 import SAM2Model as JaxSAM2Model
from us_video_medsam2_tpu_torch.inference import amg
from us_video_medsam2_tpu_torch.inference.automatic_mask_generator import SAM2AutomaticMaskGenerator
from us_video_medsam2_tpu_torch.inference.image_predictor import SAM2ImagePredictor

pytest.importorskip("cv2")  # the JAX side's remove_small_regions


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_roundtrip_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m = rng.random((33, 47)) > 0.6
    m[0, 0] = seed == 1  # a run that starts with foreground, or not
    rle = amg.mask_to_rle(m)
    assert rle == jamg.mask_to_rle(m)
    np.testing.assert_array_equal(amg.rle_to_mask(rle), m)
    assert amg.area_from_rle(rle) == int(m.sum()) == jamg.area_from_rle(rle)
    assert amg.coco_encode_rle(rle)["size"] == [33, 47]


def test_grids_and_crops_match_jax():
    for n, layers, scale in ((4, 0, 1), (8, 2, 2), (32, 1, 1)):
        for a, b in zip(amg.build_all_layer_point_grids(n, layers, scale),
                        jamg.build_all_layer_point_grids(n, layers, scale)):
            np.testing.assert_array_equal(a, b)
    for size, layers, ratio in (((100, 150), 1, 0.2), ((600, 800), 2, 512 / 1500)):
        assert amg.generate_crop_boxes(size, layers, ratio) == jamg.generate_crop_boxes(size, layers, ratio)
    boxes, layers = amg.generate_crop_boxes((100, 150), n_layers=1, overlap_ratio=0.2)
    assert boxes[0] == [0, 0, 150, 100] and len(boxes) == 5 and max(layers) == 1


def test_nms_boxes_stability_match_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (40, 2))], 1).astype(np.float32)
    scores = rng.random(40).astype(np.float32)
    for thr in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(amg.box_nms(boxes, scores, thr), jamg.box_nms(boxes, scores, thr))
    keep = amg.box_nms(np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], np.float32),
                       np.array([0.9, 0.8, 0.7]), 0.5)
    assert sorted(keep.tolist()) == [0, 2]
    logits = rng.normal(0, 2, (5, 20, 24)).astype(np.float32)
    np.testing.assert_array_equal(amg.calculate_stability_score(logits, 0.0, 1.0),
                                  jamg.calculate_stability_score(logits, 0.0, 1.0))
    masks = logits > 0
    masks[2] = False
    np.testing.assert_array_equal(amg.batched_mask_to_box(masks), jamg.batched_mask_to_box(masks))
    crop, orig = [0, 0, 30, 30], [0, 0, 60, 60]
    np.testing.assert_array_equal(amg.is_box_near_crop_edge(boxes, crop, orig),
                                  jamg.is_box_near_crop_edge(boxes, crop, orig))


def _regions(seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((40, 48), bool)
    m[5:30, 5:35] = True
    m[10:12, 10:12] = False  # a 4-px hole
    m[20:21, 20:23] = False  # a 3-px hole
    m[35:37, 40:42] = True  # a 4-px island
    m[38, 2] = True  # a 1-px island
    m[2:4, 44:46] = True  # a second 4-px island, diagonal to nothing
    m |= rng.random(m.shape) > 0.97  # specks
    return m


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("area", [0, 3, 5, 50, 2000])
@pytest.mark.parametrize("seed", [0, 1])
def test_remove_small_regions_matches_jax_cv2(mode, area, seed):
    m = _regions(seed)
    got, changed = amg.remove_small_regions(m, area, mode)
    want, want_changed = jamg.remove_small_regions(m, area, mode)
    assert changed == want_changed
    np.testing.assert_array_equal(got, want)


def test_remove_small_regions_keeps_the_largest_island_as_cv2_does():
    m = np.zeros((20, 20), bool)
    m[1:3, 1:3] = True  # 4 px, first in raster order
    m[10:12, 14:16] = True  # 4 px: a tie
    m[15:18, 2:4] = True  # 6 px
    for area in (5, 7, 100):
        got, _ = amg.remove_small_regions(m, area, "islands")
        want, _ = jamg.remove_small_regions(m, area, "islands")
        np.testing.assert_array_equal(got, want)
    m[15:18, 2:4] = False
    got, _ = amg.remove_small_regions(m, 100, "islands")
    np.testing.assert_array_equal(got, jamg.remove_small_regions(m, 100, "islands")[0])
    with pytest.raises(ValueError):
        amg.remove_small_regions(m, 3, "specks")


@pytest.fixture(scope="module")
def image_predictors():
    params, _ = mini_weights()
    return (JaxImagePredictor(JaxSAM2Model(MINI), params, max_hole_area=8, max_sprinkle_area=8),
            SAM2ImagePredictor(mini_port_model(), max_hole_area=8, max_sprinkle_area=8, device="cpu"))


def _image():
    rng = np.random.default_rng(0)
    img = (rng.random((128, 120, 3)) * 60).astype(np.uint8)
    yy, xx = np.mgrid[0:128, 0:120]
    img[((yy - 50) ** 2 + (xx - 40) ** 2) < 25**2] += 180
    img[90:120, 70:110] += 120
    return img


GENERATE = {
    "test_amg settings": dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
                              stability_score_thresh=0.0),
    "one crop layer, small regions": dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
                                          stability_score_thresh=0.0, crop_n_layers=1,
                                          min_mask_region_area=30),
    "a padded batch": dict(points_per_side=5, points_per_batch=16, pred_iou_thresh=0.0,
                           stability_score_thresh=0.0, box_nms_thresh=0.5),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_matches_jax(image_predictors, case):
    jp, tp = image_predictors
    img = _image()
    want = JaxAMG(jp, **GENERATE[case]).generate(img)
    got = SAM2AutomaticMaskGenerator(tp, **GENERATE[case]).generate(img)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["segmentation"].shape == (128, 120)
        assert iou(a["segmentation"], b["segmentation"]) > 0.999
        for k in ("predicted_iou", "stability_score"):
            assert abs(a[k] - b[k]) <= 1e-3, (k, a[k], b[k])
        assert a["crop_box"] == b["crop_box"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1.0)
        np.testing.assert_allclose(a["point_coords"], b["point_coords"], rtol=1e-6)


def test_generate_with_every_mask_filtered_out(image_predictors):
    """The fixture weights' IoU predictions (about 0.5) all fall below the
    default threshold of 0.8: the port returns no mask (the JAX generator
    raises there, reshaping an empty batch in calculate_stability_score)."""
    _, tp = image_predictors
    assert SAM2AutomaticMaskGenerator(tp, points_per_side=3, points_per_batch=4).generate(_image()) == []
    assert amg.calculate_stability_score(np.zeros((0, 5, 6), np.float32), 0.0, 1.0).shape == (0,)


def test_refine_with_m2m_matches_jax(image_predictors):
    jp, tp = image_predictors
    img = _image()
    jp.set_image(img)
    tp.set_image(img)
    pts = np.array([[40.0, 50.0], [90.0, 105.0], [10.0, 10.0]], np.float32)
    _, _, low = tp.predict_batch_points(pts[:, None], np.ones((3, 1), np.int32), multimask_output=False)
    got = SAM2AutomaticMaskGenerator(tp, points_per_side=4).refine_with_m2m(pts, low[:, 0])
    want = JaxAMG(jp, points_per_side=4).refine_with_m2m(pts, low[:, 0])
    assert got[0].shape == (3, 1, 4 * MINI.feat_size, 4 * MINI.feat_size) and got[1].shape == (3, 1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=1e-3, atol=1e-3)


def test_generator_takes_one_grid_source():
    with pytest.raises(ValueError):
        SAM2AutomaticMaskGenerator(None, points_per_side=None)
    with pytest.raises(ValueError):
        SAM2AutomaticMaskGenerator(None, points_per_side=4, point_grids=[amg.build_point_grid(4)])
