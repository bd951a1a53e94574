"""PyTorch port: chip_smoke.py's phase 9 (the entry points) on the CPU at
``tiny64_test`` and small sizes, as tests/test_torch_smoke_long_video.py
runs phase 8: the five apps' mains on the script's seeded NPZ data (outputs,
``infer_case`` in bf16 against f32 at the band gate), batched serving (eager
body against the "graphs", each video against the interactive predictor,
bf16 against f32) and the image path (every predict mode, batched points,
the post-processing, the AMG). The card's own gates (launch counts,
captures, the sync-free window) are the card's and are not run here."""

import numpy as np

import chip_smoke

SMALL = dict(APP_HW=(60, 80), APP_FRAMES=6, MRI_FRAMES=4, RECIST_SLICES=6, RECIST_SIDES=(64, 48),
             RECIST_HOST_SLICES=4, VOLUME_SLICES=6, SERVE_N=3, SERVE_T=4, SERVE_HOST=(2, 3), BATCH_POINTS=16,
             AMG_POINTS=8, AMG_HOST_POINTS=4, AMG_STABILITY_THRESH=0.0, REPEATS=1)


def test_phase_9_on_cpu(tmp_path, monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(chip_smoke, k, v)
    chip_smoke.run_entry_points("cpu", str(tmp_path), name="tiny64_test", device="cpu")
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".pt"]  # the checkpoint is removed after its use
    segs = np.load(tmp_path / "out" / "recist" / "case_48.npz")["segs"]
    assert segs.shape == (6, 48, 48) and segs[3].any()


def test_app_data(tmp_path, monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(chip_smoke, k, v)
    d = chip_smoke.write_app_data(str(tmp_path), 64)
    video = np.load(f"{d['videos']}/video_0.npz")
    assert video["imgs"].shape == (6, 60, 80) and video["imgs"].dtype == np.uint8
    assert set(np.unique(video["gts"][0])) == {0, 1, 2} and d["video_first"] == [0, 0]
    case = np.load(f"{d['recist']}/case_48.npz")
    assert case["recist"].shape == (6, 48, 48) and case["recist"][3].any() and not case["recist"][:3].any()
    vol = np.load(f"{d['volume']}/ct.npz")["imgs"]
    assert vol.dtype == np.int16 and vol.shape == (6, 64, 64) and vol.min() >= -1000
    assert d["key"] == 3 and len(d["box"]) == 4 and 0 <= d["box"][0] < d["box"][2] <= 63
