#!/usr/bin/env python3
"""The CXBlock kernel of several checkouts of the PyTorch port, in turns (one GPU).

    python3 tools/torch_cxblock_ab.py TREE [TREE ...] [--no-run] [--plan]

Each TREE is the root of a checkout (for an A/B in turns: the parent, the
change, the change, the parent). For each, in the order given, a fresh
process whose imports come from that tree builds its kernels and times that
tree's ``cxblock`` alone at the shapes phase 3 of its chip_smoke.py holds it
at ([3, 32, 32, 256] of the training path, [1, 32, 32, 256] of a memory
encoding at 512², and the edge shapes [2, 16, 16, 256] and [1, 12, 20, 256]),
seeded inputs (chip_smoke.cxblock_args): device ms per call from
torch.profiler's kernel events (chip_smoke.device_ms), and beside it, for
information, the default composition of the ``CXBlock`` module (the switch
unset: depthwise Conv2d, LayerNorm, two cuBLAS Linears, GELU, scale and
residual) at B 1 and B 3 in bf16. Then, unless ``--no-run``, for each of
``sam2.1_hiera_t512`` and ``efficientmedsam_s_512`` a fresh process of the
same tree runs that tree's chip_smoke.py main path (bf16, seeded weights and
video, 16 frames) with both of the fused configuration's switches set: one
warm-up run, then one run under torch.profiler, whose device busy time, the
CXBlock kernel's device time and share of it, and its launches it reports.
With ``--plan``, where the tree's kernel takes a number of splits, every one
(1-8 blocks a cluster) is timed at B 1 and B 3, with the pick named. Prints
one JSON line per tree, then the card's name and power limit. Needs a CUDA
device; about 60 s a tree (and 20 s more with ``--plan``).
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
from us_video_medsam2_tpu_torch.kernels import cxblock as cx

what = sys.argv[1]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_lib.build()
_lib.load()
SHAPES = [(c.TRAIN_OBJECTS, 32, 32), (1, 32, 32), (2, 16, 16), (1, 12, 20)]
g = torch.Generator(device="cuda").manual_seed(c.SEED)


def rn(*shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)


def module_ms(args):
    from us_video_medsam2_tpu_torch.models.memory import CXBlock

    blk = CXBlock(args[0].shape[-1]).to("cuda")
    names = ("dwconv.conv.weight", "dwconv.conv.bias", "norm.weight", "norm.bias", "pwconv1.weight",
             "pwconv1.bias", "pwconv2.weight", "pwconv2.bias", "gamma")
    with torch.no_grad():
        for name, v in zip(names, args[1:]):
            blk.get_parameter(name).copy_(v)
        blk = blk.to(torch.bfloat16)
        return c.device_ms(lambda: blk(args[0]))


if what == "kernel":
    per_call, module = {}, {}
    for b, h, w in SHAPES:
        a = c.cxblock_args(rn, b, h, w)
        per_call[f"[{b}, {h}, {w}, 256]"] = c.device_ms(lambda: cx.cxblock(*a))
        if (h, w) == (32, 32):
            module[f"[{b}, {h}, {w}, 256]"] = module_ms(a)
    result = {"cxblock_device_ms_per_call": per_call, "module_default_device_ms_per_call": module}
elif what == "plan":
    if "splits" not in inspect.signature(cx._kernel).parameters:
        result = {"plan_sweep": None}
    else:
        sweep = {}
        for b in (1, c.TRAIN_OBJECTS):
            a = c.cxblock_args(rn, b, 32, 32)
            times = {s: c.device_ms(lambda: cx._kernel(*a, 1e-6, splits=s)) for s in range(1, 9)}
            sweep[f"[{b}, 32, 32, 256]"] = {"device_ms_by_splits": times, "pick": cx.plan_for(b, 32, 32)}
        result = {"plan_sweep": sweep}
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
    cx.cxblock.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c.run_main_path(predictor, video, click)
    busy = kernel = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        busy += us
        kernel += us if "cxblock_kernel" in e.key else 0.0
    result = {what: {"fused_device_busy_ms": busy / 1e3, "cxblock_device_ms": kernel / 1e3,
                     "cxblock_share": kernel / busy, "cxblock_launches": cx.cxblock.launches}}
print(json.dumps(result))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--no-run", action="store_true", help="time the kernel alone, no profiled fused runs")
    ap.add_argument("--plan", action="store_true", help="also time every number of splits at B 1 and B 3")
    args = ap.parse_args(argv)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    if card.returncode != 0:
        print("torch_cxblock_ab: nvidia-smi failed (no CUDA device?)", file=sys.stderr)
        return 2
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        for k in ("US_MEDSAM2_ENABLE_FUSED_CXBLOCK", "US_MEDSAM2_FUSE_QKV_WINDOW_ATTN"):
            env.pop(k, None)
        result = {"tree": tree}
        runs = ["kernel"] + ([] if args.no_run else ["sam2.1_hiera_t512", "efficientmedsam_s_512"])
        for what in runs + (["plan"] if args.plan else []):  # one process each: one profile a process
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
