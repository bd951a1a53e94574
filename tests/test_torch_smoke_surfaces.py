"""PyTorch port: chip_smoke.py's phase 14 (the last user-facing surfaces) on
the CPU at ``tiny64_test`` and small sizes, as
tests/test_torch_smoke_annotation.py runs phase 13: (a) the checkpoint
verifier on phase 9's infer_video cases (its CSV byte for byte infer_video's,
its JSON summary that CSV's ALL rows, exit 1 under ``--expect_dice
0.999``); (b) a study at another size than the model's (so stored as
float16 on the host), three objects streamed forward and in reverse, against
the resident session of the same frames; (c) an mp4 through the HTTP
server against the predictor driven directly on the decoded frames; (d)
the quickstart; (e) the fast hole filler, device against host; each a
case of its own ((f), the training launcher, in
tests/test_torch_smoke_launcher.py, so that the two files run side by
side). The card's own gates (launch counts, peaks, captures) are the
card's and are not run here."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from us_video_medsam2_tpu_torch.core.build import build_sam2

cv2 = pytest.importorskip("cv2")

SMALL = dict(APP_HW=(60, 80), APP_FRAMES=6, MRI_FRAMES=4, RECIST_SLICES=6, RECIST_SIDES=(64, 48),
             RECIST_HOST_SLICES=4, VOLUME_SLICES=6, HTTP_FRAMES=4, HTTP_HW=(48, 64), OFFLOAD_FRAMES=10,
             OFFLOAD_HW=(48, 64), STREAM_CHUNK=4, QUICKSTART_FRAMES=3, FAST_FILL_SHAPE=(2, 64, 64),
             FAST_FILL_AREAS={"fast": (4, 8), "exact": (4,)}, FRAMES=4)


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(chip_smoke, k, v)
    monkeypatch.delenv("UVMS2_NATIVE_NPZ", raising=False)
    torch.set_num_threads(1)


def seeded_weights():
    model = build_sam2("tiny64_test", seed=chip_smoke.SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    return model, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("part", list("abcde"))
def test_phase_14_on_cpu(part, tmp_path, small):
    """One part of phase 14 a case ((f), the launcher, is
    tests/test_torch_smoke_launcher.py's); (a) after phase 9's apps, whose
    infer_video cases it verifies."""
    model, host_sd = seeded_weights()
    entry = {"host_sd": host_sd}
    if part == "a":
        apps = chip_smoke.check_apps("tiny64_test", host_sd, model.cfg, "cpu", str(tmp_path / "entry"), "cpu")
        assert set(apps) == {"launches", "videos", "first", "metrics_csv"} and apps["first"] == [0, 0]
        entry["apps"] = apps
    out = chip_smoke.run_surfaces("cpu", str(tmp_path / "surfaces"), entry, None, name="tiny64_test",
                                  device="cpu", parts=part)
    surfaces = tmp_path / "surfaces"
    if part == "a":
        assert (surfaces / "verifier" / "verify" / "evaluation_summary.csv").read_bytes() == open(
            apps["metrics_csv"], "rb").read()
    if part == "b":  # the float16 store of 10 frames at the model's 64²
        assert out["offload"]["host_store_bytes"] == 10 * 64 * 64 * 3 * 2
    if part == "c":
        assert set(out["mp4"]) == {"upload_ms", "click_ms", "track_ms_per_frame"}
        assert (surfaces / "upload.mp4").stat().st_size > 0
    assert not list(surfaces.rglob("*.pt"))  # each checkpoint removed after its use
    assert not torch.distributed.is_initialized()


def test_offload_study_holds_the_store_against_resident(small):
    """(b) alone: every frame of both directions yielded, the float16 store
    used, and a fault in the store (one frame's values moved) told apart by
    the gate."""
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    _, host_sd = seeded_weights()
    pred = build_sam2_video_predictor("tiny64_test", state_dict=host_sd, fill_hole_area=8, device="cpu")
    out = chip_smoke.run_offload_study("cpu", pred, 8, (40, 56), 3)
    assert out["host_store_bytes"] == 8 * 64 * 64 * 3 * 2 and 0 <= out["least_iou_vs_uint8"] <= 1
    video, _, blobs = chip_smoke.make_video(8, 40, 1, width=56)
    clicks = chip_smoke.blob_clicks(blobs, frames=(4,))[4]
    off, state, _ = chip_smoke.bidirectional(pred, video, (40, 56), clicks, 4, 3, offload_video_to_host=True)
    assert state.images_host.dtype == np.float16 and len(off) == 4 + 5
    bad = state.images_host.astype(np.float32)
    bad[2] += 0.5
    res, _, _ = chip_smoke.bidirectional(pred, torch.from_numpy(bad), (40, 56), clicks, 4)
    with pytest.raises(AssertionError, match="graph and eager disagree"):
        chip_smoke.hold_graph_against_eager(off, res, "a moved frame")


def test_write_mp4_decodes(tmp_path, small):
    from us_video_medsam2_tpu_torch.utils.video_io import load_video_frames

    click, box = chip_smoke.write_mp4(str(tmp_path / "v.mp4"), 0)
    frames, h, w = load_video_frames(str(tmp_path / "v.mp4"), 64)
    assert (h, w) == (48, 64) and len(frames) == 4
    assert 0 <= click[0] < 64 and 0 <= box[0] < box[2] < 64


def test_step_hook_chains_and_counts(tmp_path, monkeypatch):
    """The hook as a file: without its environment it only chains to the
    interpreter's own sitecustomize (found past its own directory)."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(chip_smoke.STEP_HOOK)
    other = tmp_path / "other"
    other.mkdir()
    (other / "sitecustomize.py").write_text("import os\nos.environ['CHAINED'] = '1'\n")
    import subprocess
    import sys

    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{hook}:{other}"}
    p = subprocess.run([sys.executable, "-c", "import os; print(os.environ.get('CHAINED'))"], env=env,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0 and p.stdout.strip() == "1", p.stderr
