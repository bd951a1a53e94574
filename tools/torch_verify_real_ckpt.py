"""One-command Dice verification of a real checkpoint, on the PyTorch port.

Counterpart of ``tools/verify_real_ckpt.py``: given a checkpoint, it builds
the port's video predictor from it, propagates every NPZ case with the
fork's deterministic video-eval protocol (reference
medsam2_infer_video.py:390-469, the port's ``apps/infer_video.py``: GT-mask
prompt on the first annotated frame, objects sorted by id, per-frame
FairSegMetrics, a per-video CSV and a video-balanced ALL row), prints one
JSON summary line, and with ``--expect_dice`` a PASS or FAIL line against
the mean Dice of class 1 (exit 0 on PASS, 1 on FAIL).

Accepted checkpoints: a reference torch ``.pt`` / ``.pth`` (a MedSAM2
release, or a fork training checkpoint whose weights sit under "model"),
routed through ``core/import_torch.py`` as ``apps/infer_video.py`` routes
them; a native ``.npz`` of either package's trainer; a reference-name
``.npz``. An Orbax directory is refused (``core/build.py::load_params``):
the port does not read Orbax.
The predictor runs on the card unless ``--device cpu`` is given.

Usage:
  python tools/torch_verify_real_ckpt.py checkpoints/MedSAM2_latest.pt
  # options:
  #   --data_dir DIR     NPZ cases (default: data/RECIST_train_npz in the repo)
  #   --cfg NAME         config preset (default sam2.1_hiera_t512)
  #   --out_dir DIR      CSV/vis output (default verify_real_ckpt in the temp dir)
  #   --expect_dice X    fail (exit 1) if mean Dice of class 1 < X
  #   --cases N          only the first N cases (smoke runs)
  #   --save_vis         dump pred/gt/overlay PNGs per frame
  #   --device D         cuda (default) or cpu
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DEFAULT_DATA = str(REPO / "data" / "RECIST_train_npz")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help=".pt/.pth (torch) or .npz")
    ap.add_argument("--data_dir", default=DEFAULT_DATA)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "verify_real_ckpt"))
    ap.add_argument("--expect_dice", type=float, default=None)
    ap.add_argument("--cases", type=int, default=0, help="0 = all")
    ap.add_argument("--save_vis", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for the plain versions")
    args = ap.parse_args(argv)

    if not os.path.exists(args.checkpoint):
        ap.error(f"checkpoint not found: {args.checkpoint}")
    if not os.path.isdir(args.data_dir):
        ap.error(
            f"data dir not found: {args.data_dir} (pass --data_dir with NPZ "
            "cases holding 'imgs' [T,H,W] uint8 + 'gts' [T,H,W] int labels)"
        )

    import random
    from glob import glob

    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.apps import infer_video
    from us_video_medsam2_tpu_torch.core.build import build_sam2_video_predictor_npz
    from us_video_medsam2_tpu_torch.utils.metrics import VideoMetricAggregator

    # global determinism (reference medsam2_infer_video.py:240-249)
    random.seed(infer_video.SEED)
    np.random.seed(infer_video.SEED)
    torch.manual_seed(infer_video.SEED)

    cases = sorted(glob(os.path.join(args.data_dir, "*.npz")))
    if args.cases:
        cases = cases[: args.cases]
    if not cases:
        ap.error(f"no .npz cases in {args.data_dir}")
    predictor = build_sam2_video_predictor_npz(args.cfg, ckpt_path=args.checkpoint, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    agg = VideoMetricAggregator(infer_video.ALL_CLASSES)
    for npz in cases:
        infer_video.evaluate_video(predictor, npz, agg, args)
    csv_path = os.path.join(args.out_dir, "evaluation_summary.csv")
    agg.to_csv(csv_path)
    gm = agg.global_means()
    summary = {
        "checkpoint": args.checkpoint,
        "cfg": args.cfg,
        "cases": len(cases),
        "csv": csv_path,
        "global_means": {str(c): m for c, m in gm.items()},
    }
    print(json.dumps(summary))

    if args.expect_dice is not None:
        got = gm.get(1, {}).get("dice", 0.0)
        if got < args.expect_dice:
            print(f"FAIL: class-1 Dice {got:.4f} < expected {args.expect_dice}")
            return 1
        print(f"PASS: class-1 Dice {got:.4f} >= {args.expect_dice}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
