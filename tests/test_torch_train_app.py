"""PyTorch port, the training launcher ``apps/train.py`` end to end on the
CPU at ``tiny64_test``: it trains one epoch (every file of the out-dir, the
config snapshots), resumes to a second, and its ``checkpoint.npz`` is served
by the port's ``infer_video`` and by the JAX package's
``build_sam2_video_predictor_npz``: the port's predictor built from the same
file against JAX's within the predictor tests' tolerances (logits rtol 1e-3,
atol 1e-3 of the frame's scale, f32 on both)."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_trainer import corpus  # noqa: F401  (the fixture)


def test_cli_trains_resumes_and_serves(corpus, tmp_path):  # noqa: F811
    from us_video_medsam2_tpu.core.build import build_sam2_video_predictor_npz
    from us_video_medsam2_tpu_torch.apps import infer_video, train
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    out = tmp_path / "run"
    common = ["--data_dir", corpus, "--out_dir", str(out), "--cfg", "tiny64_test", "--resolution", "64",
              "--num_frames", "3", "--max_num_objects", "2", "--curriculum", "none", "--temporal_loss", "graph",
              "--device", "cpu"]
    tr = train.main(common + ["--epochs", "1"])
    assert tr.epoch == 1 and tr.state.step == 3
    files = sorted(os.listdir(out))
    for f in ("train_stats.json", "best_stats.json", "checkpoint.npz", "checkpoint.meta.json",
              "best_checkpoint.npz", "best_checkpoint.meta.json", "config_resolved.json",
              "train_config_resolved.json"):
        assert f in files
    with open(out / "train_config_resolved.json") as f:
        snap = json.load(f)
    assert snap["loss"]["temporal_variant"] == "graph" and snap["optim"]["total_steps"] == 3
    tr2 = train.main(common + ["--epochs", "2"])
    assert tr2.epoch == 2 and tr2.state.step == 6
    with open(out / "train_stats.json") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    ckpt = str(out / "checkpoint.npz")

    infer_video.main(["--data_dir", corpus, "--out_dir", str(tmp_path / "eval"), "--cfg", "tiny64_test",
                      "--checkpoint", ckpt, "--device", "cpu"])
    assert (tmp_path / "eval" / "metrics.csv").exists()

    video = np.load(os.path.join(corpus, "v0.npz"))["imgs"]
    rgb = np.repeat(video[..., None], 3, -1).astype(np.float32) / 255.0
    mean, std = np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32)
    import torch.nn.functional as F

    frames = F.interpolate(torch.from_numpy(rgb).permute(0, 3, 1, 2), size=(64, 64), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    frames = ((frames - mean) / std)[:4]
    jpred = build_sam2_video_predictor_npz("tiny64_test", ckpt, dtype=jnp.float32)
    tpred = build_sam2_video_predictor("tiny64_test", ckpt_path=ckpt, device="cpu", dtype=torch.float32)
    results = []
    for pred, imgs in ((jpred, jnp.asarray(frames)), (tpred, frames)):
        state = pred.init_state(imgs, 72, 80, max_objects=1)
        pred.add_new_points_or_box(state, 0, 1, points=np.array([[30.0, 25.0]]), labels=np.array([1]))
        results.append({t: np.asarray(m) for t, _, m in pred.propagate_in_video(state)})
    want, got = results
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for t in want:
        scale = np.abs(want[t]).max()
        np.testing.assert_allclose(got[t], want[t], rtol=1e-3, atol=1e-3 * scale, err_msg=str(t))
