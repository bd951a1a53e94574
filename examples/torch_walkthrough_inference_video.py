# %% [markdown]
# # Video Segmentation with US-Video-MedSAM2 (PyTorch port)
#
# Notebook-style walkthrough mirroring the reference
# `notebooks/MedSAM2_Inference_Video.ipynb`, on the PyTorch port: load a
# frame-folder video, add an initial mask prompt on frame 0, propagate
# through the video, save per-frame PNG masks, and visualize three key
# frames (25% / 50% / 75%).
#
# Cells are `# %%` blocks inside `main`. Everything runs self-contained: when
# `--video_dir` is not given, a synthetic cine sequence with a moving bright
# structure is generated so the walkthrough needs no data or checkpoint.
# Runs on the card unless `--device cpu` is given.
#
#   python examples/torch_walkthrough_inference_video.py \
#       [--video_dir frames/ --mask_prompt mask0.png] \
#       [--checkpoint MedSAM2_latest.pt] [--out out_video/] [--device cpu]

# %% Load packages
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def synthetic_cine(t, size=512):
    """A moving bright structure: (frames [T, S, S, 3] uint8, gt [T, S, S] bool)."""
    rng = np.random.default_rng(0)
    frames = (rng.random((t, size, size, 1)) * 40).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    gt = np.zeros((t, size, size), bool)
    for i in range(t):
        blob = ((yy - (190 + 4 * i)) ** 2 + (xx - (170 + 3 * i)) ** 2) < 55**2
        frames[i, blob] += 180
        gt[i] = blob
    return np.repeat(frames.astype(np.uint8), 3, axis=-1), gt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video_dir", default=None, help="folder of frame images (sorted)")
    ap.add_argument("--mask_prompt", default=None, help="initial mask PNG for frame 0")
    ap.add_argument("--checkpoint", default=None, help=".pt or .npz weights")
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--out", default="walkthrough_video_out")
    ap.add_argument("--frames", type=int, default=24, help="synthetic length")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    # %% Build the video predictor
    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor

    predictor = build_sam2_video_predictor(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    print("predictor ready:", args.cfg, "ckpt:", args.checkpoint or "(random init)", "device:", args.device)

    # %% Load the video frames (or synthesize a cine sequence)
    if args.video_dir:
        from PIL import Image

        names = sorted(
            p for p in os.listdir(args.video_dir)
            if p.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        frames = np.stack(
            [np.asarray(Image.open(os.path.join(args.video_dir, n)).convert("RGB"))
             for n in names]
        )
    else:
        frames, gt = synthetic_cine(args.frames)
        names = [f"{i:05d}" for i in range(args.frames)]
    print("video:", frames.shape)

    # %% Prepare inference state and add the initial mask prompt on frame 0
    state = predictor.init_state(frames, frames.shape[1], frames.shape[2], max_objects=1)

    if args.mask_prompt:
        from PIL import Image

        mask0 = np.asarray(Image.open(args.mask_prompt).convert("L")) > 0
    else:
        mask0 = gt[0]
    predictor.add_new_mask(state, 0, 1, mask0)
    print("prompted frame 0 with a mask of", int(mask0.sum()), "px")

    # %% Run propagation throughout the video
    video_segments = {}  # frame_idx -> {obj_id: bool mask}
    for frame_idx, obj_ids, logits in predictor.propagate_in_video(state):
        video_segments[frame_idx] = {
            oid: np.asarray(logits[i, 0]) > 0 for i, oid in enumerate(obj_ids)
        }
    print("propagated", len(video_segments), "frames")

    # %% Save per-frame PNG masks
    os.makedirs(args.out, exist_ok=True)
    try:
        from PIL import Image

        for fi, segs in sorted(video_segments.items()):
            canvas = np.zeros(frames.shape[1:3], np.uint8)
            for oid, m in segs.items():
                canvas[m] = oid
            Image.fromarray(canvas).save(os.path.join(args.out, f"{names[fi]}.png"))
        print("masks written to", args.out)
    except ImportError:
        print("PIL unavailable; skipping PNG export")

    # %% Visualize three key frames (25% / 50% / 75% positions)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        keys = sorted(video_segments)
        picks = [keys[int(len(keys) * q)] for q in (0.25, 0.5, 0.75)]
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, fi in zip(axes, picks):
            ax.imshow(frames[fi])
            m = next(iter(video_segments[fi].values()))
            ax.imshow(np.ma.masked_where(~m, m), alpha=0.5, cmap="autumn")
            ax.set_title(f"frame {fi}")
            ax.axis("off")
        fig.savefig(os.path.join(args.out, "key_frames.png"), dpi=120)
        plt.close(fig)
        print("key-frame figure:", os.path.join(args.out, "key_frames.png"))
    except ImportError:
        print("matplotlib unavailable; skipping visualization")

    # %% Quality check on synthetic data
    if not args.video_dir:
        ious = []
        for fi, segs in video_segments.items():
            m = next(iter(segs.values()))
            inter = (m & gt[fi]).sum()
            union = (m | gt[fi]).sum()
            ious.append(inter / union if union else 1.0)
        print(f"mean IoU vs synthetic GT over {len(ious)} frames: {np.mean(ious):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
