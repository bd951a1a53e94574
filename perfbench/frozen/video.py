"""Seeded moving-blob videos: the frames every cell tracks.

Frozen copy of ``chip_smoke.py::make_video`` at commit 40a6c6c (three smooth
Gaussian blobs of random colour, radius and velocity moving over a gradient;
the click is blob 0's centre on frame 0), written with torch so that a batch
of videos is made on the card in a few large calls. The blobs' parameters are
drawn on the host from ``numpy.random.default_rng(seed)`` in the original's
order; the pixels are the original's formula in float32, so a video is the
same on any device up to the last bit of ``exp``.
"""

from __future__ import annotations

import numpy as np
import torch

N_BLOBS = 3


def blob_params(seed: int, size: int):
    rng = np.random.default_rng(seed)
    c0 = rng.uniform(0.25, 0.75, (N_BLOBS, 2)) * size
    vel = rng.uniform(-3.0, 3.0, (N_BLOBS, 2))
    rad = rng.uniform(0.06, 0.12, N_BLOBS) * size
    col = rng.uniform(80, 255, (N_BLOBS, 3))
    return c0, vel, rad, col


def make_videos(seeds, frames: int, size: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """uint8 [len(seeds), frames, size, size, 3] on ``device``, and the
    clicks [len(seeds), 2] (x, y): blob 0's centre on frame 0."""
    params = [blob_params(int(s), size) for s in seeds]
    f32 = dict(dtype=torch.float32, device=device)
    c0 = torch.tensor(np.stack([p[0] for p in params]), **f32)  # [V, B, 2]
    vel = torch.tensor(np.stack([p[1] for p in params]), **f32)
    rad = torch.tensor(np.stack([p[2] for p in params]), **f32)  # [V, B]
    col = torch.tensor(np.stack([p[3] for p in params]), **f32)  # [V, B, 3]
    yy, xx = torch.meshgrid(torch.arange(size, **f32), torch.arange(size, **f32), indexing="ij")
    base = (20 + 40 * xx / size + 30 * yy / size)[..., None].expand(size, size, 3)
    t = torch.arange(frames, **f32)
    out = torch.empty(len(seeds), frames, size, size, 3, dtype=torch.uint8, device=device)
    for v in range(len(seeds)):
        img = base.expand(frames, size, size, 3).clone()
        centres = c0[v][None] + vel[v][None] * t[:, None, None]  # [T, B, 2]
        for i in range(N_BLOBS):
            d2 = (xx[None] - centres[:, i, 0, None, None]) ** 2 + (yy[None] - centres[:, i, 1, None, None]) ** 2
            a = torch.exp(-d2 / (2 * rad[v, i] ** 2))[..., None]
            img = img * (1 - a) + col[v, i] * a
        out[v] = img.clamp(0, 255).to(torch.uint8)
    clicks = np.array([[p[0][0, 0], p[0][0, 1]] for p in params], np.float32)
    return out, clicks
