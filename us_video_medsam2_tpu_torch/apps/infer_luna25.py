"""LUNA25 lung-nodule segmentation from CT volumes.

Counterpart of the JAX package's ``apps/infer_luna25.py`` (reference
examples/infer_CT_LUNA25.py): load a .mha/.nii/.npz volume, apply the lung
window (level -750, width 1500, reference infer_CT_LUNA25.py:80), put a point
prompt at a voxel nodule coordinate on its key slice, and propagate
bidirectionally. SimpleITK/nibabel are optional; NPZ input always works.

Usage:
  python -m us_video_medsam2_tpu_torch.apps.infer_luna25 --input case.npz \\
      --coord_zyx 42 230 180 --out_dir out [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from os.path import basename, join

import numpy as np

from us_video_medsam2_tpu_torch.apps.infer_3d_ct import largest_component, window_ct


def load_volume(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path, allow_pickle=True)["imgs"]
    if path.endswith((".mha", ".mhd")):
        try:
            import SimpleITK as sitk  # type: ignore
        except ImportError as e:
            raise ImportError(".mha input needs SimpleITK; convert to npz") from e
        return sitk.GetArrayFromImage(sitk.ReadImage(path))
    if path.endswith((".nii", ".nii.gz")):
        import nibabel as nib

        return np.moveaxis(np.asanyarray(nib.load(path).dataobj), -1, 0)
    raise ValueError(f"unsupported volume format: {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--input", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--coord_zyx", type=float, nargs=3, required=True,
                    help="nodule center voxel coordinate (z, y, x)")
    ap.add_argument("--window_level", type=float, default=-750.0)
    ap.add_argument("--window_width", type=float, default=1500.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    from us_video_medsam2_tpu_torch.apps.infer_ct_recist import normalize, resize_grayscale_to_rgb
    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor_npz

    predictor = build_sam2_video_predictor_npz(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    vol = load_volume(args.input)
    vol8 = window_ct(vol, args.window_level, args.window_width)
    d, vh, vw = vol8.shape
    img = normalize(resize_grayscale_to_rgb(vol8, predictor.cfg.image_size, predictor.device))

    z, y, x = (int(round(c)) for c in args.coord_zyx)
    segs = np.zeros(vol8.shape, bool)
    for reverse in (False, True):
        state = predictor.init_state(img, vh, vw, max_objects=1)
        predictor.add_new_points_or_box(
            state, z, 1, points=np.array([[float(x), float(y)]]), labels=np.array([1])
        )
        for fi, _, logits in predictor.propagate_in_video(
            state, start_frame_idx=z, reverse=reverse
        ):
            segs[fi] |= logits[0, 0] > 0
        predictor.reset_state(state)
    segs = largest_component(segs)

    os.makedirs(args.out_dir, exist_ok=True)
    stem = basename(args.input).split(".")[0]
    np.savez_compressed(join(args.out_dir, f"{stem}_nodule.npz"), segs=segs.astype(np.uint8))
    print(f"{stem}: {int(segs.sum())} voxels across {int((segs.any(axis=(1, 2))).sum())} slices")


if __name__ == "__main__":
    main()
