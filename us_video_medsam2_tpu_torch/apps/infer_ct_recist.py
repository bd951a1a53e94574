"""FLARE25 RECIST 3D-CT lesion segmentation.

Counterpart of the JAX package's ``apps/infer_ct_recist.py`` (reference
medsam2_infer_CT_lesion_npz_recist.py:100-462): per-case NPZ with `imgs`
(D,H,W uint8-ranged), `recist` (D,H,W line markers), `spacing`; a RECIST
diameter line on one slice becomes a box (or sampled points) prompt on that
slice; the resulting mask is handed to add_new_mask and propagated forward
then (after reset) backward through the volume. Saves segs NPZ + timing CSV.
Slices are resized with ``F.interpolate`` (bilinear, half-pixel, on f32)
where JAX calls ``cv2.resize(..., INTER_LINEAR)``: the same values on f32
input, with no cv2 needed.

Usage:
  python -m us_video_medsam2_tpu_torch.apps.infer_ct_recist \\
      --imgs_path data/RECIST_npz --pred_save_dir out [--checkpoint ckpt.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from glob import glob
from os.path import basename, join

import numpy as np


def get_diameter_bbox(recist_slice: np.ndarray, shift: int = 0) -> np.ndarray:
    """RECIST line -> enclosing square box (reference recist.py:124-151)."""
    h, w = recist_slice.shape
    ys, xs = np.where(recist_slice > 0)
    coords = np.stack([xs, ys], axis=1)
    p1, p2 = coords[0], coords[-1]
    center = ((p1 + p2) / 2).astype(int)
    half = int(np.linalg.norm(p1 - p2) / 2)
    x_min = max(0, center[0] - half - shift)
    y_min = max(0, center[1] - half - shift)
    x_max = min(w - 1, center[0] + half + shift)
    y_max = min(h - 1, center[1] + half + shift)
    return np.array([x_min, y_min, x_max, y_max])


def sample_points_in_bbox_grid(bbox: np.ndarray, n: int = 9) -> np.ndarray:
    """(reference recist.py:153-186)"""
    x_min, y_min, x_max, y_max = bbox
    side = int(np.ceil(np.sqrt(n)))
    xs = np.linspace(x_min, x_max, side + 2)[1:-1]
    ys = np.linspace(y_min, y_max, side + 2)[1:-1]
    pts = np.array([(x, y) for y in ys for x in xs])[:n]
    return pts


def resize_grayscale_to_rgb(imgs, size: int, device="cpu"):
    """(D, H, W) -> (D, size, size, 3) f32 in [0, 1] on ``device``: each
    slice resized bilinearly on f32 (half-pixel centres, no antialias: cv2's
    INTER_LINEAR), then divided by 255. A tensor on ``device`` is returned."""
    import torch
    import torch.nn.functional as F

    x = torch.as_tensor(np.asarray(imgs)).to(device).float()[:, None]
    if tuple(x.shape[-2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)
    return x[:, 0, ..., None].expand(-1, -1, -1, 3) / 255.0


def normalize(img):
    """[..., 3] in [0, 1] -> ImageNet-normalized, on its device."""
    import torch

    from us_video_medsam2_tpu_torch.inference.transforms import IMG_MEAN, IMG_STD

    mean, std = (torch.as_tensor(v, device=img.device) for v in (IMG_MEAN, IMG_STD))
    return (img - mean) / std


def infer_case(predictor, npz_file: str, args):
    t_start = time.time()
    data = np.load(npz_file, "r", allow_pickle=True)
    spacing = data["spacing"]
    recist = data["recist"]
    img3d = data["imgs"]
    if img3d.max() >= 256:
        raise ValueError(f"{npz_file}: imgs should be in [0, 255]")
    segs = np.zeros(img3d.shape, np.uint8)
    vh, vw = img3d.shape[1:3]

    img = normalize(resize_grayscale_to_rgb(img3d, predictor.cfg.image_size, predictor.device))

    for ulab in np.unique(recist)[np.unique(recist) != 0]:
        rl = (recist == ulab) * ulab
        z_indices = np.where((rl > 0).any(axis=(1, 2)))[0]
        if len(z_indices) == 0:
            continue
        z_mid = int(z_indices[0])
        box2d = get_diameter_bbox(rl[z_mid], shift=args.shift)

        state = predictor.init_state(img, vh, vw, max_objects=1)
        if args.propagate_with_box:
            _, _, logits = predictor.add_new_points_or_box(
                state, frame_idx=z_mid, obj_id=1, box=box2d
            )
        else:
            pts = sample_points_in_bbox_grid(box2d, n=9)
            _, _, logits = predictor.add_new_points_or_box(
                state, frame_idx=z_mid, obj_id=1, points=pts, labels=np.ones(len(pts)),
            )
        mask_prompt = (logits[0, 0] > 0.0).astype(np.uint8)

        # mask handoff + forward propagation (reference recist.py:380-383)
        predictor.reset_state(state)
        _, _, masks = predictor.add_new_mask(state, z_mid, 1, mask_prompt)
        segs[z_mid][masks[0, 0] > 0.0] = ulab
        for fi, _, logits in predictor.propagate_in_video(state, start_frame_idx=z_mid):
            segs[fi][logits[0, 0] > 0.0] = ulab
        # reverse pass with a fresh state (reference recist.py:384-389)
        predictor.reset_state(state)
        predictor.add_new_mask(state, z_mid, 1, mask_prompt)
        for fi, _, logits in predictor.propagate_in_video(
            state, start_frame_idx=z_mid, reverse=True
        ):
            segs[fi][logits[0, 0] > 0.0] = ulab

    np.savez_compressed(join(args.pred_save_dir, basename(npz_file)), segs=segs, spacing=spacing)
    return time.time() - t_start


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--imgs_path", required=True)
    ap.add_argument("--pred_save_dir", required=True)
    ap.add_argument("--propagate_with_box", action="store_true", default=True)
    ap.add_argument("--no-box", dest="propagate_with_box", action="store_false")
    ap.add_argument("--shift", type=int, default=0)
    ap.add_argument("--sample_points", default="from_box")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor_npz

    predictor = build_sam2_video_predictor_npz(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    os.makedirs(args.pred_save_dir, exist_ok=True)
    cases = sorted(glob(join(args.imgs_path, "*.npz")))
    rows = []
    for case in cases:
        dur = infer_case(predictor, case, args)
        print(f"finished {basename(case)} in {dur:.2f}s")
        rows.append((basename(case), dur))
    with open(join(args.pred_save_dir, "inference_time.csv"), "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["case", "seconds"])
        wr.writerows(rows)


if __name__ == "__main__":
    main()
