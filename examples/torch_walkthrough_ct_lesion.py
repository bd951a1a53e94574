# %% [markdown]
# # CT Lesion Annotation Walkthrough (PyTorch port)
#
# Notebook-style walkthrough mirroring the reference
# `notebooks/MedSAM2_inference_CT_Lesion.ipynb`, on the PyTorch port: load a
# CT lesion NPZ case (`imgs` [T, 512, 512] uint8 + `gts` labels), derive a
# RECIST-style box prompt at the key slice, run bidirectional video
# propagation through the volume, and write a segmentation summary CSV +
# overlay figure of the 25%/key/75% slices.
#
# Runs self-contained: without `--npz` a synthetic lesion volume is generated.
# Runs on the card unless `--device cpu` is given.
#
#   python examples/torch_walkthrough_ct_lesion.py \
#       [--npz CT_Lesion_case.npz] [--checkpoint MedSAM2_latest.pt] [--out out_ct/] [--device cpu]

# %% Load libraries
import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def synthetic_case(t=12, size=512):
    """A lesion that grows to the key slice and shrinks: (imgs [T, S, S] uint8, gts)."""
    rng = np.random.default_rng(1)
    imgs = (rng.random((t, size, size)) * 60).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    gts = np.zeros((t, size, size), np.uint8)
    for i in range(t):
        r = 45 - 3 * abs(i - t // 2)
        if r > 8:
            blob = ((yy - 260) ** 2 + (xx - 240) ** 2) < r * r
            imgs[i][blob] += 150
            gts[i] = blob
    return imgs.astype(np.uint8), gts


def dice(a, b):
    s = a.sum() + b.sum()
    return 2.0 * float((a & b).sum()) / s if s else 1.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", default=None, help="CT lesion NPZ (imgs/gts)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--out", default="walkthrough_ct_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    # %% Build the predictor
    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor

    predictor = build_sam2_video_predictor(args.cfg, ckpt_path=args.checkpoint, device=args.device)

    # %% Load (or synthesize) the case
    if args.npz:
        case = np.load(args.npz)
        imgs = case["imgs"]  # [T, 512, 512] uint8
        gts = (case["gts"] > 0).astype(np.uint8)
    else:
        imgs, gts = synthetic_case()
    print("volume:", imgs.shape, "lesion voxels:", int(gts.sum()))

    # %% Key slice + RECIST-style box prompt
    areas = gts.reshape(gts.shape[0], -1).sum(axis=1)
    key_slice = int(np.argmax(areas))
    ys, xs = np.nonzero(gts[key_slice])
    box = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)
    print(f"key slice {key_slice}, box {box.tolist()}")

    # %% Bidirectional propagation from the key slice
    frames = np.repeat(imgs[..., None], 3, axis=-1)
    state = predictor.init_state(frames, imgs.shape[1], imgs.shape[2], max_objects=1)
    predictor.add_new_points_or_box(state, key_slice, 1, box=box)

    seg = np.zeros_like(gts)
    for fi, obj_ids, logits in predictor.propagate_in_video(state, start_frame_idx=key_slice):
        seg[fi] = np.asarray(logits[0, 0]) > 0
    for fi, obj_ids, logits in predictor.propagate_in_video(
        state, start_frame_idx=key_slice, reverse=True
    ):
        seg[fi] = np.asarray(logits[0, 0]) > 0
    print("segmented slices:", int((seg.reshape(seg.shape[0], -1).sum(1) > 0).sum()))

    # %% Segmentation summary CSV (mirrors the notebook's seg_info table)
    os.makedirs(args.out, exist_ok=True)
    csv_path = os.path.join(args.out, "seg_info.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case", "key_slice", "box", "pred_voxels", "gt_voxels", "dice"])
        w.writerow([
            os.path.basename(args.npz) if args.npz else "synthetic",
            key_slice,
            box.astype(int).tolist(),
            int(seg.sum()),
            int(gts.sum()),
            f"{dice(seg > 0, gts > 0):.4f}",
        ])
    print("summary:", csv_path)

    # %% Overlay figure: 25th percentile / key / 75th percentile slices
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        idx = np.arange(imgs.shape[0])
        picks = [int(np.percentile(idx, 25)), key_slice, int(np.percentile(idx, 75))]
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, fi in zip(axes, picks):
            ax.imshow(imgs[fi], cmap="gray")
            ax.imshow(np.ma.masked_where(seg[fi] == 0, seg[fi]), alpha=0.5, cmap="autumn")
            ax.set_title(f"slice {fi}")
            ax.axis("off")
        fig.savefig(os.path.join(args.out, "overlay.png"), dpi=120)
        plt.close(fig)
        print("overlay figure:", os.path.join(args.out, "overlay.png"))
    except ImportError:
        print("matplotlib unavailable; skipping visualization")
    return 0


if __name__ == "__main__":
    sys.exit(main())
