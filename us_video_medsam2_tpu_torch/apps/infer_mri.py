"""MRI video inference (no ground truth): center-box prompt + propagation + PNGs.

Counterpart of the JAX package's ``apps/infer_mri.py`` (reference
medsam2_infer_MRI.py:225-491): for each NPZ video, synthesize a center-box
prompt on frame 0 (add_center_box_prompt, MRI.py:353-374), propagate, save
per-frame mask/overlay PNGs (PIL).

Usage:
  python -m us_video_medsam2_tpu_torch.apps.infer_mri \\
      --data_dir data/mri --out_dir out [--checkpoint ckpt.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from os.path import basename, join

import numpy as np


def center_box(h: int, w: int, scale: float = 0.5) -> np.ndarray:
    """Centered box covering `scale` of each side (reference MRI.py:353-374)."""
    bw, bh = w * scale, h * scale
    cx, cy = w / 2, h / 2
    return np.array([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--box_scale", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    from us_video_medsam2_tpu_torch.apps.infer_video import gray_video, save_mask, save_overlay
    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor_npz

    predictor = build_sam2_video_predictor_npz(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    for npz in sorted(glob(join(args.data_dir, "*.npz"))):
        name = os.path.splitext(basename(npz))[0]
        imgs = np.load(npz)["imgs"]  # [T, H, W]
        t, vh, vw = imgs.shape
        state = predictor.init_state(gray_video(imgs, predictor), vh, vw, max_objects=1)
        predictor.add_new_points_or_box(
            state, 0, 1, box=center_box(vh, vw, args.box_scale)
        )
        vdir = join(args.out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for fi, _, logits in predictor.propagate_in_video(state):
            m = logits[0, 0] > 0
            save_mask(m, join(vdir, f"{fi:04d}_mask.png"))
            save_overlay(imgs[fi], m, join(vdir, f"{fi:04d}_overlay.png"))
        print(f"{name}: {t} frames done")


if __name__ == "__main__":
    main()
