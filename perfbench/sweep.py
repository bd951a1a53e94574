"""A sweep of the serving batch: frames/s and a batch's latency at each N.

    python3 perfbench/sweep.py --config t512 --videos 2,4,8,16,32,64 --frames 32 --seconds 10 --seed <n>

One process on the card: the program and its weights made once from the
seed, then for each N the ``batched`` traffic's batches (N seeded moving-blob
videos x T frames from page-locked host memory, one click each, the logits
back to page-locked memory), two warm-up batches, and batches back to back
for ``--seconds``. Prints one JSON line an N: frames/s over the window, the
batches' wall times (a video's result waits for its whole batch) and the
window's peak device memory. It sets the batch of the serving cells
(``PERF.md``); the benchmark's runs do not run it.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import common, harness  # noqa: E402
from perfbench.drivers import batched  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--videos", required=True, help="the batch sizes N, comma-separated")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.benchmark()
    harness.cuda_devices(1)
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate

    cfg = harness.load_json(harness.ROOT / harness.config_entry(bench, args.config)["file"])
    common.build_kernels("cuda")
    sd = common.state_dict(cfg, args.seed, "cuda")
    pred = common.program(cfg, sd, "cuda")
    size = cfg["model"]["image_size"]
    low = 4 * (size // cfg["model"]["backbone_stride"])
    for n in (int(x) for x in args.videos.split(",")):
        traffic = {"videos": n, "frames": args.frames, "distinct_batches": 2}
        ctx = harness.Context(f"sweep.n{n}", cfg, traffic, {}, args.seed, args.seconds, False, "cuda", 0.0)
        videos, clicks = batched._inputs(ctx, size)
        labels = np.ones((n, 1), np.int32)
        host = torch.empty((n, args.frames, low, low), pin_memory=True)

        def batch(i):
            k = i % len(videos)
            host.copy_(batched_propagate(pred, videos[k], clicks[k], labels), non_blocking=True)
            torch.cuda.synchronize()

        for i in range(2):
            batch(i)
        torch.cuda.reset_peak_memory_stats()
        walls, t0, i = [], time.perf_counter(), 0
        while time.perf_counter() - t0 < args.seconds:
            b0 = time.perf_counter()
            batch(i)
            walls.append(time.perf_counter() - b0)
            i += 1
        window = time.perf_counter() - t0
        print(json.dumps({"config": args.config, "videos": n, "frames": args.frames, "batches": i,
                          "frames_per_s": i * n * args.frames / window, "window_s": window,
                          "batch_s_median": statistics.median(walls), "batch_s_max": max(walls),
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
        del videos, clicks, host
        common.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
