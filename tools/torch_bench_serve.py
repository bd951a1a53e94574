#!/usr/bin/env python3
"""Batched-serving throughput of the PyTorch port on the card (inference/serve.py).

Twin of tools/bench_serve.py: aggregate tracked frames/s for N independent
single-prompt videos propagated at once through ``batched_propagate`` (one
CUDA graph replay a frame over the N rows). The predictor is the preset's
with weights made from seed 0, bf16, hole filling on; the video is seeded
noise with one click at the centre of frame 0 (bench.py's synthetic
fallback; the RECIST cases it prefers are not in the repo), repeated for
every row. Videos are resident on the card before timing. One call first
(it captures the graph), then ``--runs`` calls, each timed on the host
clock up to a copy of a few logits to the host; the median is kept.

With ``--trace DIR`` one more call runs under ``utils/profiling.trace``
and ``utils/traceparse`` prints its device time by category and by module
(a graph replay's kernels count to the replay). With ``--json`` one
machine-readable line is printed last, with the keys of the JAX tool's line,
the device's name and ``launches``: each kernel wrapper's launches over the
``--runs`` timed calls (a graph replay counts the launches it captured; the
plain versions on the CPU count none).

Usage: python tools/torch_bench_serve.py [--cfg sam2.1_hiera_t512] [--videos 4]
       [--frames 16] [--runs 3] [--trace DIR] [--json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_predictor(cfg_name: str, device: str):
    """The preset's video predictor, weights from seed 0, bf16, hole filling on."""
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    return build_sam2_video_predictor(cfg_name, device=device, fill_hole_area=8)


def synthetic_video(frames: int, size: int):
    """bench.py's fallback: seeded standard-normal frames (already
    normalized) and one click at the centre."""
    import numpy as np

    video = np.random.default_rng(0).standard_normal((frames, size, size, 3)).astype(np.float32)
    return video, np.array([[size / 2, size / 2]], np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    ap.add_argument("--videos", type=int, default=4)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--trace", default=None, help="trace one more call into this directory")
    ap.add_argument("--json", action="store_true", help="print one machine-readable JSON line")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate
    from us_video_medsam2_tpu_torch.kernels import _lib

    predictor = make_predictor(args.cfg, args.device)
    dev = predictor.device
    size = predictor.cfg.image_size
    video, click = synthetic_video(args.frames, size)
    n = args.videos
    videos = torch.from_numpy(video).to(dev).expand(n, *video.shape).contiguous()
    coords = torch.from_numpy(click)[None].expand(n, 1, 2).numpy()
    labels = torch.ones((n, 1), dtype=torch.int32).numpy()

    def call():
        out = batched_propagate(predictor, videos, coords, labels)
        out[-1, -1, :2, :2].cpu()  # a host copy: the call's work is done
        return out

    t0 = time.perf_counter()
    call()  # captures the frame body's graph on the card
    first_s = time.perf_counter() - t0
    times = []
    _lib.zero_launches()
    for _ in range(args.runs):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    launches = _lib.launch_counts()
    dt = statistics.median(times)
    agg_fps = n * args.frames / dt
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"serve {args.cfg}: {n} videos x {args.frames} frames @{size}² in {dt * 1e3:.1f} ms/call = "
          f"{agg_fps:.1f} aggregate frames/s on {name} (first call {first_s:.2f} s)")
    device_ms_per_frame = None
    if args.trace:
        from us_video_medsam2_tpu_torch.utils.profiling import trace
        from us_video_medsam2_tpu_torch.utils.traceparse import parse_trace

        with trace(args.trace, modules=predictor.model):
            call()
        self_op, self_mod, self_cat, _ = parse_trace(args.trace)
        total = sum(self_op.values())  # us
        nt = n * args.frames
        device_ms_per_frame = total / 1e3 / nt
        print(f"device self time: {total / 1e3:.2f} ms/call ({total / nt:.1f} us/frame, "
              f"{nt / (total / 1e6):.1f} device-bound agg FPS)")
        print("-- by device category --")
        for c, d in self_cat.most_common(12):
            print(f"{d / 1e3:9.2f} ms {100 * d / total:5.1f}%  {c}")
        print("-- by module --")
        for m, d in self_mod.most_common(15):
            print(f"{d / 1e3:9.2f} ms {100 * d / total:5.1f}%  {m[:110]}")
    rec = {
        "metric": f"serve_aggregate_fps_{args.cfg}",
        "value": round(agg_fps, 1),
        "unit": "frames/s/chip",
        "videos": n,
        "frames_per_video": args.frames,
        "wall_ms_per_call": round(dt * 1e3, 1),
        "device": name,
        "launches": launches,
    }
    if device_ms_per_frame is not None:
        rec["device_ms_per_frame"] = round(device_ms_per_frame, 4)
        rec["device_bound_agg_fps"] = round(1e3 / device_ms_per_frame, 1)
    if args.json:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
