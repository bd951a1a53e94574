"""PyTorch port: chip_smoke.py's phase 13 (a)-(c) on the CPU at
``tiny64_test`` and small sizes, as tests/test_torch_smoke_entry_points.py
runs phase 9: the annotation server through real HTTP round trips against
the predictor driven directly (bit for bit, masks.zip's PNGs included), two
sessions tracked at once from two threads against their runs alone, and
phase 9's served videos through a one-rank gloo mesh against phase 9's
unsharded bits. The card's own gates (launch counts, captures, the
sync-free window) are the card's and are not run here; (d), the twins, is
tests/test_torch_bench_twins.py."""

import torch

import chip_smoke
from us_video_medsam2_tpu_torch.core.build import build_sam2

SMALL = dict(HTTP_FRAMES=4, HTTP_HW=(48, 64), SERVE_N=2, SERVE_T=3, SERVE_HOST=(2, 3), REPEATS=1)


def test_phase_13_on_cpu(tmp_path, monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(chip_smoke, k, v)
    torch.set_num_threads(1)
    model = build_sam2("tiny64_test", seed=chip_smoke.SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    host_sd = {k: v.clone() for k, v in model.state_dict().items()}
    served = chip_smoke.check_serving("tiny64_test", host_sd, "cpu", "cpu")
    assert served["lows"].shape[:2] == (2, 3) and served["raw"].shape == (2, 3, 64, 64, 3)
    chip_smoke.run_annotation("cpu", str(tmp_path), {"host_sd": host_sd, "serving": served}, name="tiny64_test",
                              device="cpu")
    assert (tmp_path / "upload.avi").exists() and not torch.distributed.is_initialized()


def test_session_video_box_and_click(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "HTTP_HW", (48, 64))
    monkeypatch.setattr(chip_smoke, "HTTP_FRAMES", 3)
    click, box = chip_smoke.session_video(str(tmp_path / "v.avi"), 0)
    assert 0 <= click[0] < 64 and 0 <= click[1] < 48
    assert 0 <= box[0] < box[2] < 64 and 0 <= box[1] < box[3] < 48
