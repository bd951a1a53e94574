#!/usr/bin/env python3
"""The qkv window-attention kernel of several checkouts of the PyTorch port, in turns (one GPU).

    python3 tools/torch_qkv_window_ab.py TREE [TREE ...] [--no-run] [--plan] [--probe]

Each TREE is the root of a checkout (for an A/B in turns: the parent, the
change, the change, the parent). For each, in the order given, a fresh
process whose imports come from that tree builds its kernels and times that
tree's ``qkv_window_attention`` alone at every geometry of its
chip_smoke.py's ``QKV_SHAPES`` (the nine windowed ``sam2.1_hiera_t512``
blocks) and ``QKV64_SHAPES`` (EfficientMedSAM-S's and -Ti's ws-14 blocks), B
1, seeded inputs (chip_smoke.qkv_args): device ms per call from
torch.profiler's kernel events (chip_smoke.device_ms), and their sum per
encoded frame (t512: the nine calls; S: its eight). Then, unless
``--no-run``, for each of ``sam2.1_hiera_t512`` and ``efficientmedsam_s_512``
a fresh process of the same tree runs that tree's chip_smoke.py main path
(bf16, seeded weights and video, 16 frames) with both of the fused
configuration's switches set: one warm-up run, then one run under
torch.profiler, whose device busy time, the qkv kernel's device time and
share of it, and its launches it reports. With ``--plan``, where the tree's
kernel takes a plan, every candidate plan (G windows a group, C blocks a
cluster) is timed at each geometry at B 1 and B 4 (the training
path's batch), with the pick, the pick at C 1 and the pick at G 1 named.
With ``--probe``, where the tree's kernel takes a plan, the ws-14 calls of
t512 (block 4) and S are timed at B 1 with their picked plan and at C 1
while Cin runs over 32-768: the least-squares line through the device
times gives what a call costs beyond its projection products (the
intercept at Cin 0: launch, cluster, tables, passes' fixed cost and the
attention) and what each 32-wide Cin chunk adds. Prints one JSON line per
tree, then the card's name and power limit. Needs a CUDA device; about 60 s
a tree (and 60 s more with ``--plan``, 20 s with ``--probe``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import inspect, json, os, sys
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels import qkv_window_attention as qwa

what = sys.argv[1]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_lib.build()
_lib.load()
GEOMETRIES = [(c.HD, s, n) for s, n in c.QKV_SHAPES] + [(c.HD_VIT, s, n) for s, n in c.QKV64_SHAPES]
g = torch.Generator(device="cuda").manual_seed(c.SEED)


def rn(*shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)


if what == "kernel":
    per_call, t512, s = {}, 0.0, 0.0
    for hd, (hp, ws, nh, pool, cin, real), n in GEOMETRIES:
        a = c.qkv_args(rn, 1, hp, nh, cin, real, hd)
        ms = c.device_ms(lambda: qwa.qkv_window_attention(*a, ws, nh, pool))
        per_call[f"hd{hd} {hp}^2 ws{ws} nh{nh} pool={pool} Cin{cin}"] = ms
        t512 += n * ms if hd == c.HD else 0.0
        s += n * ms if hd == c.HD_VIT else 0.0
    result = {"qkv_device_ms_per_call": per_call, "t512_device_ms_per_frame": t512, "s_device_ms_per_frame": s}
elif what == "plan":
    if "plan" not in inspect.signature(qwa._kernel).parameters:
        result = {"plan_sweep": None}
    else:
        sweep = {}
        for b in (1, c.TRAIN_T):
            for hd, (hp, ws, nh, pool, cin, real), _ in GEOMETRIES:
                a = c.qkv_args(rn, b, hp, nh, cin, real, hd)
                pick = qwa.plan_for(b, hp, hp, ws, nh, hd, pool, cin)
                named = {"pick": pick, "pick at C 1": pick._replace(c=1), "pick at G 1": pick._replace(g=1)}
                times = {}
                for p in sorted(set(qwa.candidates(ws, pool)) | set(named.values())):
                    if qwa.smem_bytes(hd, ws, pool, p) > _lib.SMEM_PER_BLOCK:
                        continue
                    times[str(tuple(p))] = c.device_ms(lambda: qwa._kernel(*a, ws, nh, pool, plan=p))
                sweep[f"B{b} hd{hd} {hp}^2 ws{ws} nh{nh} pool={pool} Cin{cin}"] = {
                    "device_ms_by_plan": times, **{k: str(tuple(p)) for k, p in named.items()}}
        result = {"plan_sweep": sweep}
elif what == "probe":
    if "plan" not in inspect.signature(qwa._kernel).parameters:
        result = {"probe": None}
    else:
        import numpy as np

        probe = {}
        for hd, (hp, ws, nh, pool, cin, real), _ in GEOMETRIES:
            if ws != 14 or pool or cin != 384:
                continue
            pick = qwa.plan_for(1, hp, hp, ws, nh, hd, pool, cin)
            for p in (pick, pick._replace(c=1)):
                cins = (32, 96, 192, 384, 768)
                ms = []
                for k in cins:
                    a = c.qkv_args(rn, 1, hp, nh, k, real, hd)
                    ms.append(c.device_ms(lambda: qwa._kernel(*a, ws, nh, pool, plan=p)))
                slope, intercept = np.polyfit(np.asarray(cins, float), np.asarray(ms), 1)
                probe[f"hd{hd} {hp}^2 ws{ws} nh{nh} plan {tuple(p)}"] = {
                    "device_ms_by_cin": dict(zip(map(str, cins), ms)), "intercept_ms": float(intercept),
                    "ms_per_32_cin": float(32 * slope)}
        result = {"probe": probe}
else:
    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor

    model = build_sam2(what, seed=c.SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    model = model.to("cuda").set_compute_dtype(torch.bfloat16)
    predictor = SAM2VideoPredictor(model, fill_hole_area=8)
    video, click, _ = c.make_video(c.FRAMES, model.cfg.image_size, c.SEED)
    os.environ.update({k: "1" for k in c.FUSED_SWITCHES})
    c.run_main_path(predictor, video, click)  # warm-up
    qwa.qkv_window_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c.run_main_path(predictor, video, click)
    busy = qkv = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        busy += us
        qkv += us if "qkv_window_attention_kernel" in e.key else 0.0
    result = {what: {"fused_device_busy_ms": busy / 1e3, "qkv_device_ms": qkv / 1e3, "qkv_share": qkv / busy,
                     "qkv_launches": qwa.qkv_window_attention.launches}}
print(json.dumps(result))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--no-run", action="store_true", help="time the kernel alone, no profiled fused runs")
    ap.add_argument("--plan", action="store_true", help="also time every candidate plan at each geometry")
    ap.add_argument("--probe", action="store_true", help="also time the ws-14 calls against Cin")
    args = ap.parse_args(argv)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if card.returncode != 0:
        print("torch_qkv_window_ab: nvidia-smi failed (no CUDA device?)", file=sys.stderr)
        return 2
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        for k in ("US_MEDSAM2_ENABLE_FUSED_CXBLOCK", "US_MEDSAM2_FUSE_QKV_WINDOW_ATTN"):
            env.pop(k, None)
        result = {"tree": tree}
        runs = ["kernel"] + ([] if args.no_run else ["sam2.1_hiera_t512", "efficientmedsam_s_512"])
        for what in runs + (["plan"] if args.plan else []) + (["probe"] if args.probe else []):  # one process each: one profile a process
            out = subprocess.run([sys.executable, "-c", CHILD, what], cwd=root, env=env, capture_output=True,
                                 text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree}: {what} failed")
            result.update(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(result), flush=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
