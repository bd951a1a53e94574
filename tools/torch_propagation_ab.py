#!/usr/bin/env python3
"""Propagation time per tracked frame of several checkouts of the PyTorch port, in turns (one GPU).

    python3 tools/torch_propagation_ab.py TREE [TREE ...] [--repeats 5] [--models NAME ...]
        [--configs default fused] [--no-window]

Each TREE is the root of a checkout (for an A/B in turns: the parent, the
change, the change, the parent). For each, in the order given, a fresh
process whose imports come from that tree builds its kernels and times
that tree's ``window_attention`` wrapper alone at every geometry the two
models give it (B 1, hd 96 and 64, with the last-strip cut where the tree's
wrapper takes ``real_h``, as its models call it): device ms per call from
torch.profiler's kernel events (chip_smoke.device_ms). Then, for each
model (default ``sam2.1_hiera_t512`` and ``efficientmedsam_s_512``) and
configuration (``default``; ``fused``: the JAX package's two opt-in kernel
switches set), a fresh process of the same tree runs that tree's
chip_smoke.py main path (bf16, seeded weights and video, ``init_state`` ->
``add_new_points_or_box`` -> ``propagate_in_video`` over 16 frames): one
warm-up run (where a tree with the graph path captures its frame body),
``--repeats`` timed runs (host clock around propagation ending in
``synchronize``), then one run under torch.profiler, then two runs of a
video one frame longer (a length not seen before: the first of them is
where a tree with the graph path captures a graph for it). Prints one JSON line
per tree: for each model and configuration the ms per tracked frame of each
run and their median, the median wall of a whole run (init_state, prompt
and propagation), the ms per tracked frame of the two runs of the new
length and the seconds of the capture made in them, the device busy time of the profiled run and its idle
share against that wall, the seconds and pool bytes of the warm-up's
captures (where the tree has them), and the
device time of the kernels whose name holds "flash", of those whose name
holds "ln_mlp_residual" (also by D, the kernels' first template argument,
with the launches of the MLP's main kernel at that D) and of the window
attention kernel (by head dim, its first template argument, with its
launches), and the 40 kernels of most device time (ms, launches, name);
then the per-geometry window-attention times; and the card's
name and power limit. ``--no-window`` leaves the window-attention times
out. Needs a CUDA device; about 100 s a tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import inspect, json, os, re, statistics, sys
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from us_video_medsam2_tpu_torch.core.build import build_sam2
from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels import window_attention as wa

repeats, what, config = int(sys.argv[1]), sys.argv[2], sys.argv[3]
if config == "fused":
    os.environ.update({k: "1" for k in c.FUSED_SWITCHES})
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_lib.build()
_lib.load()
if what == "window":
    # (hd, Hp, ws, nh, q_pool, real map side): every window-attention call of the two models
    GEOMETRIES = [(96, 128, 8, 1, False, 128), (96, 128, 8, 2, True, 128), (96, 64, 4, 2, False, 64),
                  (96, 64, 4, 4, True, 64), (96, 42, 14, 4, False, 32), (96, 42, 14, 8, True, 32),
                  (96, 21, 7, 8, False, 16), (64, 42, 14, 6, False, 32)]
    cuts = "real_h" in inspect.signature(wa.window_attention).parameters
    g = torch.Generator(device="cuda").manual_seed(c.SEED)
    per_call = {}
    for hd, hp, ws, nh, pool, real in GEOMETRIES:
        qkv = torch.randn(1, hp, hp, 3 * nh * hd, generator=g, device="cuda").to(torch.bfloat16)
        args = (qkv, ws, nh, pool) + ((real,) if cuts and real < hp else ())
        per_call[f"hd{hd} {hp}^2 ws{ws} nh{nh} pool={pool}"] = c.device_ms(lambda: wa.window_attention(*args))
    result = {"window_device_ms_per_call": per_call, "window_real_h": cuts}
else:
    model = build_sam2(what, seed=c.SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    model = model.to("cuda").set_compute_dtype(torch.bfloat16)
    predictor = SAM2VideoPredictor(model, fill_hole_area=8)
    video, click, _ = c.make_video(c.FRAMES, model.cfg.image_size, c.SEED)
    c.run_main_path(predictor, video, click)  # warm-up
    graphs = getattr(predictor, "graphs", None)  # none in a tree without the graph path
    captured = list(graphs.entries.values()) if graphs else []
    per_frame, walls = [], []
    for _ in range(repeats):
        _, t_prompt, t_prop = c.run_main_path(predictor, video, click)
        per_frame.append(1e3 * t_prop / (c.FRAMES - 1))
        walls.append(1e3 * (t_prompt + t_prop))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c.run_main_path(predictor, video, click)
    # a video of a length not seen before (one frame longer), twice: the first
    # window captures a graph of its own (in a tree with the graph path)
    video2, click2, _ = c.make_video(c.FRAMES + 1, model.cfg.image_size, c.SEED)
    known = set(graphs.entries) if graphs else set()
    new_length = [1e3 * c.run_main_path(predictor, video2, click2)[2] / c.FRAMES for _ in range(2)]
    new_captures = [g.capture_s for k, g in graphs.entries.items() if k not in known] if graphs else []
    busy = flash = mlp = 0.0
    mlp_by_d, win_by_hd, by_kernel = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        busy += us
        by_kernel.append((us / 1e3, e.count, e.key[:90]))
        if "flash" in e.key:
            flash += us
        if "ln_mlp_residual" in e.key:
            mlp += us
            d = re.search(r"ln_mlp_residual_(?:combine_)?kernel<(\d+)", e.key)
            by = mlp_by_d.setdefault(int(d.group(1)) if d else 0, {"device_ms": 0.0, "calls": 0})
            by["device_ms"] += us / 1e3
            if "combine" not in e.key:
                by["calls"] += e.count
        hd = re.search(r"(?<![\w])window_attention_kernel<(\d+)", e.key)
        if hd:
            by = win_by_hd.setdefault(int(hd.group(1)), {"device_ms": 0.0, "calls": 0})
            by["device_ms"] += us / 1e3
            by["calls"] += e.count
    wall = statistics.median(walls)
    result = {f"{what} {config}": {
                     "ms_per_tracked_frame": per_frame, "median_ms": statistics.median(per_frame),
                     "median_wall_ms": wall, "idle_share": 1 - busy / 1e3 / wall,
                     "capture_s": [g.capture_s for g in captured],
                     "new_length_ms_per_tracked_frame": new_length,
                     "new_length_capture_s": new_captures,
                     "graph_pool_mib": [g.pool_bytes / 2**20 for g in captured],
                     "device_busy_ms": busy / 1e3, "flash_device_ms": flash / 1e3, "mlp_device_ms": mlp / 1e3,
                     "mlp_device_ms_per_call_by_d": {d: v["device_ms"] / max(v["calls"], 1)
                                                      for d, v in sorted(mlp_by_d.items())},
                     "mlp_calls_by_d": {d: v["calls"] for d, v in sorted(mlp_by_d.items())},
                     "window_device_ms_by_hd": {h: v["device_ms"] for h, v in sorted(win_by_hd.items())},
                     "window_calls_by_hd": {h: v["calls"] for h, v in sorted(win_by_hd.items())},
                     "top_kernels": sorted(by_kernel, reverse=True)[:40]}}
print(json.dumps(result))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--models", nargs="+", default=["sam2.1_hiera_t512", "efficientmedsam_s_512"])
    ap.add_argument("--configs", nargs="+", default=["default", "fused"], choices=["default", "fused"])
    ap.add_argument("--no-window", action="store_true", help="leave the window-attention times out")
    args = ap.parse_args(argv)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if card.returncode != 0:
        print("torch_propagation_ab: nvidia-smi failed (no CUDA device?)", file=sys.stderr)
        return 2
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        result = {"tree": tree}
        runs = [] if args.no_window else [("window", "default")]
        runs += [(m, cfg) for m in args.models for cfg in args.configs]
        for what, cfg in runs:  # one process each: a second profile in a process loses kernels
            out = subprocess.run([sys.executable, "-c", CHILD, str(args.repeats), what, cfg], cwd=root, env=env,
                                 capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree}: {what} {cfg} failed")
            result.update(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(result), flush=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
