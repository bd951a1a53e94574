"""PyTorch port: the evaluation CLIs (apps/) and utils/metrics.py on the CPU
against the JAX package.

- metrics: the two ``metrics.csv`` files byte for byte on seeded logits;
- ``evaluate_video`` with the port's and the JAX predictor (MINI, fixture
  weights) on the same NPZ videos: every CSV number within 1e-3;
- ``infer_case`` (box and point prompts), ``infer_3d_ct`` and
  ``infer_luna25`` (their ``main``s, each package's builder handing out its
  MINI predictor): the saved segmentations at voxel IoU > 0.999;
- ``resize_grayscale_to_rgb`` (F.interpolate) against JAX's cv2 version:
  max |d| <= 1e-5;
- the small helpers exactly: ``window_ct``, ``largest_component``,
  ``get_diameter_bbox``, ``sample_points_in_bbox_grid``, ``center_box``;
- every app's ``main`` with ``--device cpu`` at ``tiny64_test``, as
  tests/test_e2e_pipeline.py runs JAX's, and the card as every app's default.
"""

import csv
import os
import types

import numpy as np
import pytest

from tests.torch_port_helpers import iou, mini_jax_predictor, mini_port_predictor
from us_video_medsam2_tpu.apps import infer_3d_ct as j3d
from us_video_medsam2_tpu.apps import infer_ct_recist as jrecist
from us_video_medsam2_tpu.apps import infer_luna25 as jluna
from us_video_medsam2_tpu.apps import infer_mri as jmri
from us_video_medsam2_tpu.apps import infer_video as jvideo
from us_video_medsam2_tpu.utils import metrics as jmetrics
from us_video_medsam2_tpu_torch.apps import infer_3d_ct as t3d
from us_video_medsam2_tpu_torch.apps import infer_ct_recist as trecist
from us_video_medsam2_tpu_torch.apps import infer_luna25 as tluna
from us_video_medsam2_tpu_torch.apps import infer_mri as tmri
from us_video_medsam2_tpu_torch.apps import infer_video as tvideo
from us_video_medsam2_tpu_torch.utils import metrics as tmetrics

APPS = {"infer_video": tvideo, "infer_mri": tmri, "infer_ct_recist": trecist, "infer_3d_ct": t3d,
        "infer_luna25": tluna}


@pytest.fixture(scope="module")
def npz_videos(tmp_path_factory):
    """tests/test_e2e_pipeline.py's synthetic NPZ videos (classes 1 and 2)."""
    root = tmp_path_factory.mktemp("npz_videos")
    rng = np.random.default_rng(0)
    for vi in range(2):
        t, h, w = 6, 96, 80
        imgs = (rng.random((t, h, w)) * 255).astype(np.uint8)
        gts = np.zeros((t, h, w), np.uint8)
        for ti in range(t):
            y, x = 30 + ti, 25 + ti
            gts[ti, y: y + 25, x: x + 20] = 1
            gts[ti, 5:20, 50:70] = 2
            imgs[ti][gts[ti] == 1] = 220
        gts[0] = 0  # the first annotated frame is frame 1
        np.savez_compressed(root / f"video_{vi}.npz", imgs=imgs, gts=gts)
    return str(root)


def _volume(seed, d=6, h=96, w=96, hu=False):
    rng = np.random.default_rng(seed)
    vol = rng.random((d, h, w)) * 60
    zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]
    vol[((yy - 45) ** 2 + (xx - 40) ** 2) < (18 - 2 * abs(zz - d // 2)) ** 2] += 180
    return (vol * 6 - 1000).astype(np.int16) if hu else vol.astype(np.uint8)


@pytest.fixture(scope="module")
def predictors():
    return mini_jax_predictor(fill_hole_area=8), mini_port_predictor(fill_hole_area=8)


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_csv_byte_for_byte(tmp_path, seed):
    paths = []
    for mod in (jmetrics, tmetrics):
        m, agg = mod.FairSegMetrics(), mod.VideoMetricAggregator([1, 2])
        r = np.random.default_rng(seed)
        for v in range(3):
            for cls in (1, 2):
                for _ in range(4):
                    logits = r.normal(0, 3, (1, 24, 20)).astype(np.float32)
                    gt = (r.random((1, 24, 20)) > 0.6).astype(np.float32)
                    d, i, a = m(logits, gt)
                    agg.add_frame(f"video_{v}", cls, float(d[0]), float(i[0]), float(a[0]))
        paths.append(tmp_path / f"{mod.__name__.split('.')[0]}.csv")
        agg.to_csv(str(paths[-1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert b"ALL,1," in paths[1].read_bytes() and b"video_2,2," in paths[1].read_bytes()


def test_meters():
    avg = tmetrics.AverageMeter("loss")
    for v in (1.0, 3.0):
        avg.update(v)
    assert avg.avg == 2.0 and str(avg) == "loss 3.0000 (2.0000)"
    mem = tmetrics.MemMeter()
    mem.update()
    assert mem.peak_gib == 0.0  # no CUDA device: nothing allocated there
    prog = tmetrics.ProgressMeter(10, [avg], prefix="ep ")
    assert prog.display(3).startswith("ep [3/10]")


# ---------------------------------------------------------- infer_video
def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_evaluate_video_matches_jax(npz_videos, predictors, tmp_path):
    jp, tp = predictors
    rows = []
    for mod, pred, agg_mod in ((jvideo, jp, jmetrics), (tvideo, tp, tmetrics)):
        out = tmp_path / mod.__name__.split(".")[0]
        out.mkdir()
        args = types.SimpleNamespace(out_dir=str(out), save_vis=mod is tvideo)
        agg = agg_mod.VideoMetricAggregator(mod.ALL_CLASSES)
        for npz in sorted(os.listdir(npz_videos)):
            mod.evaluate_video(pred, os.path.join(npz_videos, npz), agg, args)
        agg.to_csv(str(out / "metrics.csv"))
        rows.append(_csv_rows(out / "metrics.csv"))
    want, got = rows
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[0] for r in got][-2:] == ["ALL", "ALL"] and len(got) == 1 + 2 * 2 + 2
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.float64(g[2:]), np.float64(w[2:]), atol=1e-3, err_msg=str(g[:2]))
    # the frame-1 prompt is the ground truth itself: its dice is 1 in every video
    assert float(got[1][2]) > 0.2
    vis = sorted(os.listdir(tmp_path / "us_video_medsam2_tpu_torch" / "video_0"))
    assert "0001_overlay_c1.png" in vis and "0005_pred_c2.png" in vis and not any(v.startswith("0000") for v in vis)


# ------------------------------------------------------------- the CT apps
@pytest.mark.parametrize("box", [True, False])
def test_infer_case_matches_jax(predictors, tmp_path, box):
    jp, tp = predictors
    img3d = _volume(1, h=96, w=80)
    recist = np.zeros(img3d.shape, np.uint8)
    recist[3, 45, 28:54] = 1  # a diameter line across the disc on slice 3
    case = tmp_path / "case.npz"
    np.savez_compressed(case, imgs=img3d, recist=recist, spacing=np.array([1.0, 1.0, 2.5]))
    segs = []
    for mod, pred in ((jrecist, jp), (trecist, tp)):
        out = tmp_path / mod.__name__.split(".")[0]
        out.mkdir()
        mod.infer_case(pred, str(case), types.SimpleNamespace(pred_save_dir=str(out), shift=0,
                                                              propagate_with_box=box))
        data = np.load(out / "case.npz")
        np.testing.assert_array_equal(data["spacing"], [1.0, 1.0, 2.5])
        segs.append(data["segs"])
    want, got = segs
    assert got.shape == img3d.shape and got.dtype == np.uint8
    assert got[3].any() and got.any(axis=(1, 2)).sum() > 1  # the prompted slice and a tracked one
    assert iou(got, want) > 0.999


@pytest.fixture()
def mini_builders(monkeypatch, predictors):
    """Each package's builder, as the apps import it, hands out its MINI predictor."""
    from us_video_medsam2_tpu.core import build as jbuild
    from us_video_medsam2_tpu_torch.core import build as tbuild

    jp, tp = predictors
    monkeypatch.setattr(jbuild, "build_sam2_video_predictor_npz", lambda *a, **k: jp)
    monkeypatch.setattr(tbuild, "build_sam2_video_predictor_npz", lambda *a, **k: tp)


@pytest.mark.parametrize("app", ["infer_3d_ct", "infer_luna25"])
def test_volume_apps_match_jax(mini_builders, tmp_path, app):
    vol = tmp_path / "vol.npz"
    np.savez_compressed(vol, imgs=_volume(2, h=96, w=80, hu=True))
    segs = []
    for mod in ((j3d, t3d) if app == "infer_3d_ct" else (jluna, tluna)):
        out = tmp_path / mod.__name__.split(".")[0]
        if app == "infer_3d_ct":
            mod.main(["--input", str(vol), "--out_dir", str(out), "--key_slice", "3", "--box", "22", "27", "58",
                      "63", "--window_level", "-400", "--window_width", "1200"])
            segs.append(np.load(out / "vol_seg.npz")["segs"])
        else:
            mod.main(["--input", str(vol), "--out_dir", str(out), "--coord_zyx", "3", "45", "40"])
            segs.append(np.load(out / "vol_nodule.npz")["segs"])
    want, got = segs
    assert got.shape == (6, 96, 80) and got.any()
    assert iou(got, want) > 0.999


@pytest.mark.parametrize("geometry", [((96, 96), 64), ((96, 80), 512), ((600, 700), 512), ((40, 30), 64),
                                      ((64, 64), 64)])
def test_resize_grayscale_to_rgb_matches_cv2(geometry):
    pytest.importorskip("cv2")
    (h, w), size = geometry
    imgs = (np.random.default_rng(h * w).random((3, h, w)) * 255).astype(np.uint8)
    got = trecist.resize_grayscale_to_rgb(imgs, size).numpy()
    want = jrecist.resize_grayscale_to_rgb(imgs, size)
    assert got.shape == want.shape == (3, size, size, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5


# ------------------------------------------------------------ small helpers
@pytest.mark.parametrize("level, width", [(40.0, 400.0), (-750.0, 1500.0), (0.0, 0.0)])
def test_window_ct_exact(level, width):
    vol = np.random.default_rng(3).integers(-1200, 1500, (3, 20, 24)).astype(np.int16)
    np.testing.assert_array_equal(t3d.window_ct(vol, level, width), j3d.window_ct(vol, level, width))


@pytest.mark.parametrize("seed", [0, 1])
def test_largest_component_exact(seed):
    m = np.random.default_rng(seed).random((5, 20, 20)) > 0.7
    got = t3d.largest_component(m)
    np.testing.assert_array_equal(got, j3d.largest_component(m))
    one = np.zeros((3, 8, 8), bool)
    one[1, 2:4, 2:4] = True
    assert t3d.largest_component(one) is one


@pytest.mark.parametrize("shift", [0, 5])
def test_recist_helpers_exact(shift):
    rl = np.zeros((64, 60), np.uint8)
    rl[30, 10:50] = 1
    rl[40:55, 3] = 1  # a second line, whose last pixel ends the diameter
    np.testing.assert_array_equal(trecist.get_diameter_bbox(rl, shift), jrecist.get_diameter_bbox(rl, shift))
    box = trecist.get_diameter_bbox(rl, shift)
    for n in (1, 4, 9):
        np.testing.assert_array_equal(trecist.sample_points_in_bbox_grid(box, n),
                                      jrecist.sample_points_in_bbox_grid(box, n))


@pytest.mark.parametrize("hw, scale", [((96, 80), 0.5), ((512, 512), 0.3), ((7, 9), 1.0)])
def test_center_box_exact(hw, scale):
    np.testing.assert_array_equal(tmri.center_box(*hw, scale), jmri.center_box(*hw, scale))


# ------------------------------------------------------------- the CLIs
def test_apps_default_to_the_card(npz_videos, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is runnable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvideo.main(["--data_dir", npz_videos, "--out_dir", str(tmp_path), "--cfg", "tiny64_test"])


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_main_on_the_cpu(app, npz_videos, tmp_path):
    """Each CLI end to end at tiny64_test with seeded weights (bf16, as the
    JAX apps build), as tests/test_e2e_pipeline.py runs JAX's."""
    base = ["--cfg", "tiny64_test", "--device", "cpu"]
    out = tmp_path / "out"
    if app == "infer_video":
        tvideo.main(["--data_dir", npz_videos, "--out_dir", str(out), *base])
        rows = _csv_rows(out / "metrics.csv")
        assert rows[0] == ["video", "class", "dice", "iou", "pixel_acc"]
        assert [r[:2] for r in rows[-2:]] == [["ALL", "1"], ["ALL", "2"]]
    elif app == "infer_mri":
        tmri.main(["--data_dir", npz_videos, "--out_dir", str(out), *base])
        assert sorted(os.listdir(out)) == ["video_0", "video_1"]
        assert len(os.listdir(out / "video_0")) == 2 * 6
    elif app == "infer_ct_recist":
        cases = tmp_path / "cases"
        cases.mkdir()
        for i, (h, w) in enumerate(((96, 96), (64, 64))):
            img = _volume(i, h=h, w=w)
            recist = np.zeros(img.shape, np.uint8)
            recist[3, h // 2, w // 4: w // 2] = 1
            np.savez_compressed(cases / f"case{i}.npz", imgs=img, recist=recist, spacing=np.ones(3))
        trecist.main(["--imgs_path", str(cases), "--pred_save_dir", str(out), *base])
        assert np.load(out / "case0.npz")["segs"].shape == (6, 96, 96)
        assert np.load(out / "case1.npz")["segs"].shape == (6, 64, 64)
        assert [r[0] for r in _csv_rows(out / "inference_time.csv")] == ["case", "case0.npz", "case1.npz"]
    elif app == "infer_3d_ct":
        vol = tmp_path / "ct.npz"
        np.savez_compressed(vol, imgs=_volume(3, hu=True))
        t3d.main(["--input", str(vol), "--out_dir", str(out), "--key_slice", "2", "--box", "20", "20", "60", "70",
                  "--window_level", "40", "--window_width", "400", "--save_nifti", *base])
        assert np.load(out / "ct_seg.npz")["segs"].shape == (6, 96, 96)
    else:
        vol = tmp_path / "lung.npz"
        np.savez_compressed(vol, imgs=_volume(4, hu=True))
        tluna.main(["--input", str(vol), "--out_dir", str(out), "--coord_zyx", "3", "45", "40", *base])
        assert np.load(out / "lung_nodule.npz")["segs"].shape == (6, 96, 96)


def test_load_volume_formats(tmp_path):
    vol = tmp_path / "v.npz"
    np.savez_compressed(vol, imgs=np.zeros((2, 3, 4), np.int16))
    assert tluna.load_volume(str(vol)).shape == (2, 3, 4)
    with pytest.raises(ValueError):
        tluna.load_volume(str(tmp_path / "v.dcm"))
