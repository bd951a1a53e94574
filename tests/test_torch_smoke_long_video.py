"""PyTorch port: chip_smoke.py's phase 8 (the predictor's long-video and
editing paths) on the CPU at ``tiny64_test``, as
test_smoke_script_main_path_on_cpu runs phase 4: a reference-name checkpoint
loaded through ``ckpt_path`` with the seeded predictor's bits, a 40-frame
uint8 study offloaded and streamed in chunks of 8 against the resident video
(and a 24-frame one in the same bucket), two lengths of one bucket against
their exact sessions, and the editing sequence (three objects) held between
two predictors. The card's gates (launch counts, captures, peak memory, the
sync-free window) are the card's own and are not run here."""

import functools

import numpy as np
import torch

import chip_smoke
from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor


def test_phase_8_on_cpu(tmp_path):
    builder = functools.partial(build_sam2_video_predictor, device="cpu", dtype=torch.float32)
    long_video = dict(frames=40, repeat=24, chunk=8, bucket=64, warm=10, profiled=16)
    chip_smoke.run_long_video_and_editing("tiny64_test", builder, chip_smoke.PER_ENCODED_FRAME, "cpu", None,
                                          str(tmp_path), on_card=False, long_video=long_video,
                                          bucket_lengths=(20, 27))
    assert not list(tmp_path.iterdir())  # the checkpoint is removed after its check


def test_editing_sequence_yields_and_runs():
    """The sequence's passes: 16 frames forward (frames 0 and 8 prompted, 14
    run), again after the edits, then 8 down to 0 in reverse (7 run); three
    live objects in the first pass, two after ``remove_object``."""
    pred = build_sam2_video_predictor("tiny64_test", device="cpu", dtype=torch.float32, non_overlap_masks=True,
                                      clear_non_cond_mem_around_input=True, clear_non_cond_mem_for_multi_obj=True)
    video, _, masks = chip_smoke.make_video(chip_smoke.FRAMES, 64, chip_smoke.SEED)
    out, ran = chip_smoke.editing_sequence(pred, video, chip_smoke.blob_clicks(masks))
    assert ran == {"forward": 14, "forward again": 14, "reverse": 7}
    assert [f for p, f in out if p == "forward"] == list(range(16))
    assert [f for p, f in out if p == "reverse"] == list(range(8, -1, -1))
    assert all(ids == ([1, 2, 3] if p == "forward" else [1, 3]) for (p, _), (ids, _) in out.items())
    assert all(np.isfinite(m).all() and m.shape == (3, 64, 64) for _, m in out.values())
    live = chip_smoke.per_object(out)
    assert len(live) == 16 * 3 + (16 + 9) * 2 and all(m.shape == (64, 64) for m in live.values())
