#!/usr/bin/env python3
"""The dropout-flash forward of several checkouts of the PyTorch port, in turns (one GPU).

    python3 tools/torch_flash_dropout_ab.py TREE [TREE ...] [--steps 5] [--no-train]

Each TREE is the root of a checkout (for an A/B in turns: the parent, the
change, the change, the parent). For each, in the order given, a fresh
process whose imports come from that tree builds its kernels and times that
tree's ``flash_dropout_fwd`` alone at the training path's two memory
attention shapes (``sam2.1_hiera_t512``, T 4, 3 objects, bf16: self q1024
k1024, and cross q1024 k10268 under the last tracked frame's key mask,
3,084 valid keys, chip_smoke.train_key_mask), at rates 0.1 and 0: device ms
per call from torch.profiler's kernel events (chip_smoke.device_ms, every
kernel of a call summed). Then, unless ``--no-train``, a second fresh
process of the same tree runs that tree's chip_smoke.py training step
(seeded weights and batch, bf16 with f32 master weights): one warm-up step,
``--steps`` timed steps (host clock around the step ending in
``synchronize``, for information: the host sets it), then one step under
torch.profiler, whose device busy time and the device time of the dropout
kernels (names holding "fwd::" and "bwd::") it reports with the step's
forward launches. Prints one JSON line per tree, then the card's name and
power limit. Needs a CUDA device; about 60 s a tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels import flash_dropout as fd

steps, what = int(sys.argv[1]), sys.argv[2]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_lib.build()
_lib.load()
if what == "kernel":
    g = torch.Generator(device="cuda").manual_seed(c.SEED)
    mask = c.train_key_mask("cuda")
    result = {}
    for name, lk, m in (("self", 1024, None), ("cross", mask.shape[1], mask)):
        q, k, v = (torch.randn(c.TRAIN_OBJECTS, 1, n, 256, generator=g, device="cuda").to(torch.bfloat16)
                   for n in (1024, lk, lk))
        for rate in (c.DROPOUT, 0.0):
            result[f"{name} rate {rate} device_ms_per_call"] = c.device_ms(
                lambda: fd.flash_dropout_fwd(q, k, v, m, 1234, rate))
else:
    from us_video_medsam2_tpu_torch.training.losses import LossConfig
    from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
    from us_video_medsam2_tpu_torch.training.train_step import TrainConfig, create_train_state, make_train_step

    torch.manual_seed(c.SEED)
    cfg = TrainConfig(sim=TrainSimConfig(), loss=LossConfig(weight_temporal=0.5, temporal_variant="consistency"),
                      optim=OptimConfig(total_steps=1000))
    model = c.build_train_model()
    state = create_train_state(model, cfg)
    batch = c.make_train_batch(c.TRAIN_T, model.cfg.image_size, "cuda")
    step = make_train_step(cfg)
    step(state, batch, c.SEED)
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(state, batch, c.SEED)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    fd.flash_dropout_fwd.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, c.SEED)
        torch.cuda.synchronize()
    busy = fwd = bwd = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        busy += us
        fwd += us if "fwd::" in e.key else 0.0
        bwd += us if "bwd::" in e.key else 0.0
    result = {"train_ms_per_step": walls, "train_median_ms": statistics.median(walls),
              "train_device_busy_ms": busy / 1e3, "train_dropout_fwd_device_ms": fwd / 1e3,
              "train_dropout_bwd_device_ms": bwd / 1e3,
              "train_dropout_fwd_launches": fd.flash_dropout_fwd.launches}
print(json.dumps(result))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--no-train", action="store_true", help="time the kernel alone")
    args = ap.parse_args(argv)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if card.returncode != 0:
        print("torch_flash_dropout_ab: nvidia-smi failed (no CUDA device?)", file=sys.stderr)
        return 2
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        result = {"tree": tree}
        for what in ["kernel"] + ([] if args.no_train else ["train"]):  # one process each: one profile a process
            out = subprocess.run([sys.executable, "-c", CHILD, str(args.steps), what], cwd=root, env=env,
                                 capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree}: {what} failed")
            result.update(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(result), flush=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
