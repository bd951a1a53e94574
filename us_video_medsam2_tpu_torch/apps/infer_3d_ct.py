"""DeepLesion-style 3D CT lesion segmentation with per-lesion windowing.

Counterpart of the JAX package's ``apps/infer_3d_ct.py`` (reference
medsam2_infer_3D_CT.py:1-304): a DICOM window from the CLI, resize->512 RGB +
ImageNet norm, box prompt on the key slice, bidirectional propagation,
largest-connected-component postprocess (scipy.ndimage), NPZ (or, with
nibabel, NIfTI) output.

Usage:
  python -m us_video_medsam2_tpu_torch.apps.infer_3d_ct --input case.npz \\
      --box 120 140 260 300 --key_slice 42 --out_dir out [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from os.path import basename, join

import numpy as np


def window_ct(img: np.ndarray, level: float, width: float) -> np.ndarray:
    """HU -> [0, 255] uint8 window (reference medsam2_infer_3D_CT.py:221-224)."""
    lo, hi = level - width / 2, level + width / 2
    x = np.clip(img.astype(np.float32), lo, hi)
    return ((x - lo) / max(hi - lo, 1e-6) * 255.0).astype(np.uint8)


def largest_component(mask3d: np.ndarray) -> np.ndarray:
    """Keep the largest 3D connected component (reference 3D_CT.py:76-79)."""
    try:
        from scipy import ndimage
    except ImportError:
        return mask3d
    labels, n = ndimage.label(mask3d)
    if n <= 1:
        return mask3d
    sizes = ndimage.sum(mask3d, labels, range(1, n + 1))
    return labels == (1 + int(np.argmax(sizes)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--input", required=True, help="npz with 'imgs' (D,H,W) HU or uint8")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--key_slice", type=int, required=True)
    ap.add_argument("--box", type=float, nargs=4, required=True, help="x1 y1 x2 y2")
    ap.add_argument("--window_level", type=float, default=None)
    ap.add_argument("--window_width", type=float, default=None)
    ap.add_argument("--save_nifti", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    from us_video_medsam2_tpu_torch.apps.infer_ct_recist import normalize, resize_grayscale_to_rgb
    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor_npz

    predictor = build_sam2_video_predictor_npz(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    data = np.load(args.input, allow_pickle=True)
    img3d = data["imgs"]
    if args.window_level is not None:
        img3d = window_ct(img3d, args.window_level, args.window_width or 1500.0)
    d, vh, vw = img3d.shape
    img = normalize(resize_grayscale_to_rgb(img3d, predictor.cfg.image_size, predictor.device))

    segs = np.zeros(img3d.shape, bool)
    state = predictor.init_state(img, vh, vw, max_objects=1)
    predictor.add_new_points_or_box(state, args.key_slice, 1, box=np.asarray(args.box))
    for fi, _, logits in predictor.propagate_in_video(state, start_frame_idx=args.key_slice):
        segs[fi] |= logits[0, 0] > 0
    predictor.reset_state(state)
    predictor.add_new_points_or_box(state, args.key_slice, 1, box=np.asarray(args.box))
    for fi, _, logits in predictor.propagate_in_video(
        state, start_frame_idx=args.key_slice, reverse=True
    ):
        segs[fi] |= logits[0, 0] > 0
    segs = largest_component(segs)

    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(basename(args.input))[0]
    np.savez_compressed(join(args.out_dir, f"{stem}_seg.npz"), segs=segs.astype(np.uint8))
    if args.save_nifti:
        try:
            import nibabel as nib

            nib.save(
                nib.Nifti1Image(segs.astype(np.uint8), np.eye(4)),
                join(args.out_dir, f"{stem}_seg.nii.gz"),
            )
        except ImportError:
            print("nibabel unavailable; NIfTI export skipped")
    print(f"saved {stem}: {int(segs.sum())} voxels")


if __name__ == "__main__":
    main()
