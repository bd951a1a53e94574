"""Ultrasound/MRI video segmentation eval with Dice/IoU/PixelAcc CSVs.

Counterpart of the JAX package's ``apps/infer_video.py`` (reference
medsam2_infer_video.py:239-469, the fork's deterministic evaluation entry):
per NPZ video (imgs [T,H,W] uint8, gts [T,H,W] int labels), prompt with the
GT masks of the first annotated frame (objects sorted by id), propagate
through the video, score each frame per class with FairSegMetrics,
optionally dump pred/gt/overlay PNGs, and write a per-video CSV plus a
video-balanced "ALL" row. The video is normalized and resized on the
predictor's device.

Usage:
  python -m us_video_medsam2_tpu_torch.apps.infer_video \\
      --data_dir data/videos --out_dir results [--checkpoint ckpt.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import random
from glob import glob
from os.path import basename, join

import numpy as np

SEED = 42
ALL_CLASSES = [1, 2]


def save_mask(mask, path):
    from PIL import Image

    Image.fromarray(((mask > 0) * 255).astype(np.uint8)).save(path)


def save_overlay(img, mask, path, color=(255, 0, 0), alpha=0.5):
    from PIL import Image

    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    overlay = img.astype(np.float32).copy()
    m = mask.astype(bool)
    overlay[m] = alpha * np.array(color) + (1 - alpha) * overlay[m]
    Image.fromarray(overlay.astype(np.uint8)).save(path)


def gray_video(imgs: np.ndarray, predictor):
    """[T, H, W] uint8 -> normalized f32 [T, S, S, 3] on the predictor's device."""
    import torch

    from us_video_medsam2_tpu_torch.inference.transforms import preprocess_images

    rgb = torch.from_numpy(np.ascontiguousarray(imgs)).to(predictor.device)[..., None].expand(-1, -1, -1, 3)
    return preprocess_images(rgb, predictor.cfg.image_size)


def evaluate_video(predictor, npz_file, agg, args):
    from us_video_medsam2_tpu_torch.utils.metrics import FairSegMetrics

    name = os.path.splitext(basename(npz_file))[0]
    data = np.load(npz_file)
    imgs = data["imgs"]  # [T, H, W] uint8
    gts = data["gts"]  # [T, H, W] int
    t, vh, vw = imgs.shape
    video = gray_video(imgs, predictor)

    # first annotated frame (reference medsam2_infer_video.py:397-411)
    annotated = np.where((gts > 0).any(axis=(1, 2)))[0]
    if len(annotated) == 0:
        print(f"{name}: no annotations, skipped")
        return
    f0 = int(annotated[0])
    obj_ids = sorted(int(i) for i in np.unique(gts[f0]) if i != 0)

    state = predictor.init_state(video, vh, vw, max_objects=max(len(obj_ids), 1))
    for oid in obj_ids:
        predictor.add_new_mask(state, f0, oid, gts[f0] == oid)

    metrics = FairSegMetrics()
    vis_dir = join(args.out_dir, name)
    if args.save_vis:
        os.makedirs(vis_dir, exist_ok=True)
    for fi, out_ids, logits in predictor.propagate_in_video(state, start_frame_idx=f0):
        for oi, oid in enumerate(out_ids):
            if oid not in ALL_CLASSES:
                continue
            gt = (gts[fi] == oid)[None].astype(np.float32)
            dice, iou, acc = metrics(logits[oi], gt)
            agg.add_frame(name, oid, float(dice[0]), float(iou[0]), float(acc[0]))
            if args.save_vis:
                save_mask(logits[oi, 0], join(vis_dir, f"{fi:04d}_pred_c{oid}.png"))
                save_mask(gt[0], join(vis_dir, f"{fi:04d}_gt_c{oid}.png"))
                save_overlay(
                    imgs[fi], logits[oi, 0] > 0, join(vis_dir, f"{fi:04d}_overlay_c{oid}.png")
                )
    vm = agg.video_means(name)
    print(f"{name}: " + " | ".join(f"c{c} dice={m['dice']:.4f}" for c, m in vm.items()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--save_vis", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    # global determinism (reference medsam2_infer_video.py:240-249)
    random.seed(SEED)
    np.random.seed(SEED)
    import torch

    torch.manual_seed(SEED)

    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor_npz
    from us_video_medsam2_tpu_torch.utils.metrics import VideoMetricAggregator

    predictor = build_sam2_video_predictor_npz(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    agg = VideoMetricAggregator(ALL_CLASSES)
    for npz in sorted(glob(join(args.data_dir, "*.npz"))):
        evaluate_video(predictor, npz, agg, args)
    agg.to_csv(join(args.out_dir, "metrics.csv"))
    print("global:", agg.global_means())


if __name__ == "__main__":
    main()
