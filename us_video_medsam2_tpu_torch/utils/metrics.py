"""Segmentation metrics + training meters.

Counterpart of the JAX package's ``utils/metrics.py``:

- FairSegMetrics: Dice/IoU/PixelAcc on sigmoid logits, per class — the fork's
  deterministic video-eval metric (reference medsam2_infer_video.py:259-282),
  with the per-video mean and video-balanced global aggregation of
  medsam2_infer_video.py:410-462.
- meters: Average/Duration/Progress (reference training/utils/train_utils.py:158-278);
  MemMeter reads the peak of ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class FairSegMetrics:
    def __init__(self, thr: float = 0.5, eps: float = 1e-6):
        self.thr = thr
        self.eps = eps

    def __call__(self, logits: np.ndarray, target: np.ndarray):
        """logits/target: [N, H, W] (or broadcastable); returns (dice, iou, acc) [N]."""
        prob = 1.0 / (1.0 + np.exp(-np.clip(logits.astype(np.float64), -60, 60)))
        pred = (prob > self.thr).astype(np.float64)
        gt = (target > 0.5).astype(np.float64)
        p = pred.reshape(pred.shape[0], -1)
        t = gt.reshape(gt.shape[0], -1)
        inter = (p * t).sum(-1)
        union = np.clip(p + t, None, 1).sum(-1)
        dice = (2 * inter + self.eps) / (p.sum(-1) + t.sum(-1) + self.eps)
        iou = (inter + self.eps) / (union + self.eps)
        acc = (p == t).mean(-1)
        return dice, iou, acc


class VideoMetricAggregator:
    """Per-video per-class accumulation + video-balanced global mean
    (reference medsam2_infer_video.py:410-462)."""

    def __init__(self, classes=(1, 2)):
        self.classes = list(classes)
        self.per_video: Dict[str, Dict[int, List]] = {}

    def add_frame(self, video: str, cls: int, dice: float, iou: float, acc: float):
        self.per_video.setdefault(video, defaultdict(list))[cls].append(
            (dice, iou, acc)
        )

    def video_means(self, video: str) -> Dict[int, Dict[str, float]]:
        out = {}
        for cls, rows in self.per_video[video].items():
            arr = np.asarray(rows)
            out[cls] = {
                "dice": float(arr[:, 0].mean()),
                "iou": float(arr[:, 1].mean()),
                "acc": float(arr[:, 2].mean()),
            }
        return out

    def global_means(self) -> Dict[int, Dict[str, float]]:
        """Mean over videos of per-video means (video-balanced)."""
        acc: Dict[int, List] = defaultdict(list)
        for video in self.per_video:
            for cls, m in self.video_means(video).items():
                acc[cls].append((m["dice"], m["iou"], m["acc"]))
        out = {}
        for cls, rows in acc.items():
            arr = np.asarray(rows)
            out[cls] = {
                "dice": float(arr[:, 0].mean()),
                "iou": float(arr[:, 1].mean()),
                "acc": float(arr[:, 2].mean()),
            }
        return out

    def to_csv(self, path: str):
        import csv

        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["video", "class", "dice", "iou", "pixel_acc"])
            for video in sorted(self.per_video):
                for cls, m in sorted(self.video_means(video).items()):
                    wr.writerow([video, cls, m["dice"], m["iou"], m["acc"]])
            for cls, m in sorted(self.global_means().items()):
                wr.writerow(["ALL", cls, m["dice"], m["iou"], m["acc"]])


class AverageMeter:
    """(reference train_utils.py:158-184)"""

    def __init__(self, name: str, fmt: str = ":.4f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0
        self.avg = 0.0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"


class DurationMeter:
    def __init__(self, name: str = "time"):
        self.name = name
        self.start = time.monotonic()
        self.elapsed = 0.0

    def update(self):
        self.elapsed = time.monotonic() - self.start


class MemMeter:
    """Peak device memory in GiB (reference train_utils.py:185-229):
    ``torch.cuda.max_memory_allocated``; stays 0 where no CUDA device is
    present (a CPU run allocates no device memory)."""

    def __init__(self, name: str = "mem"):
        self.name = name
        self.peak_gib = 0.0

    def update(self):
        import torch

        if torch.cuda.is_available():
            self.peak_gib = max(self.peak_gib, torch.cuda.max_memory_allocated() / 2**30)


class ProgressMeter:
    def __init__(self, num_batches: int, meters: List, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [f"{self.prefix}[{batch}/{self.num_batches}]"]
        entries += [str(m) for m in self.meters]
        return "  ".join(entries)
