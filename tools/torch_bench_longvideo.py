#!/usr/bin/env python3
"""Long-video propagation of the PyTorch port on the card: host-offloaded
frames streamed in chunks, the bank's slots rounded up to a bucket.

Twin of tools/bench_longvideo.py. Each video (uint8, seeded noise at model
resolution, one click at the centre of frame 0) is kept in host memory
(``init_state(..., offload_video_to_host=True)``: its raw bytes, normalized
on the card a frame at a time) and propagated ``--chunk`` frames at a time
(``propagate_in_video(chunk_size=...)``; each chunk reaches the card
through two page-locked buffers, PR 15's ``ChunkStager``). The bank's slot
axis is the length's bucket (``round_bucket``: 37 and 64 frames land in
64, 1,000 in 1,024), and the frame body's CUDA graph is captured once a
bucket, so lengths of one bucket share one capture. The predictor is
``sam2.1_hiera_t512`` with weights from seed 0, bf16, hole filling on.

Prints one JSON line a video (frames, bucket, host store MB, init_state s,
propagation s, tracked frames/s, captures made, peak device memory MB of
``max_memory_allocated`` over the video, each kernel wrapper's launches
from init_state to the last frame, which the plain versions on the CPU
leave at 0) and a summary line last: the
captures by bucket and the peak device memory over all videos. Run on the
card: ``python tools/torch_bench_longvideo.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_predictor(device: str):
    """The flagship ``sam2.1_hiera_t512``, weights from seed 0, bf16, hole filling on."""
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    return build_sam2_video_predictor("sam2.1_hiera_t512", device=device, fill_hole_area=8)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lengths", default="37,64,1000")
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--io-chunk", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.kernels import _lib

    predictor = make_predictor(args.device)
    dev = predictor.device
    on_card = dev.type == "cuda"
    size = predictor.cfg.image_size
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    captures_by_bucket: dict = {}
    peak = 0
    results = []
    for nf in [int(x) for x in args.lengths.split(",")]:
        video = rng.integers(0, 255, (nf, size, size, 3), np.uint8)
        if on_card:
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
        captures = predictor.graphs.captures
        _lib.zero_launches()
        t0 = time.perf_counter()
        state = predictor.init_state(video, size, size, 1, offload_video_to_host=True, io_chunk=args.io_chunk)
        init_s = time.perf_counter() - t0
        del video
        predictor.add_new_points_or_box(state, 0, 1, points=np.array([[size / 2, size / 2]]), labels=np.array([1]))
        sync()
        t0 = time.perf_counter()
        yielded = sum(1 for _ in predictor.propagate_in_video(state, chunk_size=args.chunk))
        sync()
        wall = time.perf_counter() - t0
        if yielded != nf:
            raise AssertionError(f"{nf} frames: {yielded} yielded")
        made = predictor.graphs.captures - captures
        captures_by_bucket[str(state.bucket)] = captures_by_bucket.get(str(state.bucket), 0) + made
        peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6 if on_card else None
        peak = max(peak, peak_mb or 0)
        rec = {
            "frames": nf,
            "bank_bucket": state.bucket,
            "host_store_mb": round(state.images_host.nbytes / 1e6, 1),
            "init_s": round(init_s, 3),
            "propagate_s": round(wall, 3),
            "fps": round((nf - 1) / wall, 1),
            "captures": made,
            "peak_device_mb": None if peak_mb is None else round(peak_mb, 1),
            "device": name,
            "launches": _lib.launch_counts(),
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)
        del state

    summary = {
        "metric": "longvideo_captures",
        "value": predictor.graphs.captures,
        "unit": "captured propagation graphs across " + "/".join(str(r["frames"]) for r in results) + " frames",
        "captures_by_bucket": captures_by_bucket,
        "peak_device_mb": round(peak, 1) if on_card else None,
        "chunk": args.chunk,
        "device": name,
    }
    print(json.dumps(summary), flush=True)
    if on_card and any(v > 1 for v in captures_by_bucket.values()):
        raise AssertionError(f"a bucket captured more than once: {summary}")
    return summary


if __name__ == "__main__":
    main()
