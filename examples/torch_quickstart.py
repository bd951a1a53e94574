"""Quickstart on the PyTorch port: end-to-end promptable video segmentation
on synthetic data.

Runs entirely self-contained (no checkpoints/data needed): builds the flagship
model (random weights unless --checkpoint given), creates a synthetic ultrasound-
like video with a moving bright lesion, prompts frame 0 with a click, propagates,
and reports how well the propagated masks track the moving blob. Runs on the
card (the port's CUDA kernels) unless --device cpu is given.

  python examples/torch_quickstart.py [--checkpoint MedSAM2_latest.pt] [--frames 32] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def make_synthetic_video(t=32, size=512, seed=0):
    rng = np.random.default_rng(seed)
    video = (rng.random((t, size, size)) * 40).astype(np.float32)
    gt = np.zeros((t, size, size), bool)
    for i in range(t):
        cy, cx = 200 + 3 * i, 180 + 2 * i
        yy, xx = np.mgrid[0:size, 0:size]
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < 60**2
        video[i][blob] += 180
        gt[i] = blob
    rgb = np.repeat(video[..., None], 3, axis=-1).astype(np.uint8)
    return rgb, gt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor
    from us_video_medsam2_tpu_torch.utils.metrics import FairSegMetrics

    predictor = build_sam2_video_predictor(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    video, gt = make_synthetic_video(args.frames, predictor.cfg.image_size)

    state = predictor.init_state(video, *video.shape[1:3], max_objects=1)
    predictor.add_new_points_or_box(
        state, 0, 1, points=np.array([[380.0, 400.0]]), labels=np.array([1])
    )
    metrics = FairSegMetrics()
    dices = []
    for fi, _, logits in predictor.propagate_in_video(state):
        dice, iou, acc = metrics(np.asarray(logits[0]), gt[fi][None].astype(np.float32))
        dices.append(float(dice[0]))
    print(f"propagated {len(dices)} frames; mean Dice vs synthetic GT: {np.mean(dices):.3f}")
    if args.checkpoint is None:
        print("(random weights — Dice is meaningless without a checkpoint; "
              "this demo validates the pipeline mechanics)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
