#!/usr/bin/env python3
"""The window_attention_v1 kernels of several checkouts of the PyTorch port, in turns (one GPU).

    python3 tools/torch_window_attention_v1_ab.py TREE [TREE ...] [--plan]

Each TREE is the root of a checkout (for an A/B in turns: the parent, the
change, the change, the parent). For each, in the order given, a fresh
process whose imports come from that tree builds its kernels and times that
tree's ``window_attention_v1`` alone at every geometry of its chip_smoke.py's
``V1_SHAPES`` (the nine windowed ``sam2.1_hiera_t512`` blocks, B 1, ln_inside
as the block would take it), seeded inputs (chip_smoke.v1_args): device ms
per call from torch.profiler's kernel events, split by kernel (the attention
kernel and the output projection), and the sum over the nine blocks. Once,
in the first tree whose chip_smoke.py has ``v1_compositions``, it also times
the port's own compositions of the same blocks: the main path's calls
(layer_norm, qkv Linear, window_attention, proj Linear) and the fused
configuration's (layer_norm, qkv_window_attention, proj Linear). With
``--plan``, where the tree's kernel takes a plan, every attention plan
``plan_for`` weighs (G windows a group, C blocks a cluster) is timed at each
geometry with the picked output-projection tile, and every projection tile
with the picked attention plan; the picks are named. No path launches v1,
so nothing is propagated. Prints one JSON line per tree, then the card's name
and power limit. Needs a CUDA device; about 40 s a tree (and 60 s more with
``--plan``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import inspect, json, sys
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.kernels.rejected import window_attention_v1 as v1

what = sys.argv[1]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_lib.build()
_lib.load()
g = torch.Generator(device="cuda").manual_seed(c.SEED)
EPS = 1e-6


def rn(*shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)


def by_kernel(fn, calls=10):
    # device ms a call of each kernel fn launches (torch.profiler kernel events, after a warm-up call)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            name = "projection" if "out_proj" in e.key else "attention" if "window_attention_v1" in e.key else e.key
            ms[name] = ms.get(name, 0.0) + t / 1e3 / calls
    return ms


def geometries():
    for (hp, cc, nh, co, ws, pool, real), n in c.V1_SHAPES:
        yield f"{hp}^2 C{cc} nh{nh} Co{co} ws{ws} pool={pool}", c.v1_args(rn, 1, hp, cc, nh, co, real), ws, pool, n


if what == "kernel":
    per_call, total = {}, 0.0
    for name, a, ws, pool, n in geometries():
        split = by_kernel(lambda: v1.window_attention_v1(*a, ws, pool, not pool, EPS))
        per_call[name] = {"device_ms": c.device_ms(lambda: v1.window_attention_v1(*a, ws, pool, not pool, EPS)),
                          "by_kernel": split}
        total += n * per_call[name]["device_ms"]
    result = {"v1_device_ms_per_call": per_call, "nine_block_device_ms": total}
elif what == "composition":
    if not hasattr(c, "v1_compositions"):
        result = {"composition": None}
    else:
        comp, total = {}, [0.0, 0.0]
        for name, a, ws, pool, n in geometries():
            ms = [c.device_ms(f) for f in c.v1_compositions(a, ws, a[3].shape[0], pool, not pool, EPS)]
            comp[name] = {"main_path": ms[0], "fused": ms[1]}
            total = [t + n * m for t, m in zip(total, ms)]
        result = {"composition": {"device_ms_per_call": comp, "nine_block_main_path": total[0],
                                  "nine_block_fused": total[1]}}
else:  # plan
    if "plan" not in inspect.signature(v1._kernel).parameters:
        result = {"plan_sweep": None}
    else:
        sweep = {}
        for name, a, ws, pool, n in geometries():
            x, co = a[0], a[9].shape[2]
            b, hp, wp, cc = x.shape
            nh, ln = a[3].shape[0], not pool
            pick = v1.plan_for(b, hp, wp, ws, nh, pool, cc, co, ln)
            plans = {v1.Plan(gg, cl, pick.rows, pick.nt) for gg, cl in v1.candidates(ws, pool)}
            plans |= {pick._replace(rows=r, nt=t) for r, t in v1.PROJ_TILES if co % (16 * t) == 0}
            times = {}
            for p in sorted(plans):
                if v1.smem_bytes(ws, pool, cc, ln, p) > _lib.SMEM_PER_BLOCK:
                    continue
                times[str(tuple(p))] = c.device_ms(lambda: v1._kernel(*a, ws, pool, ln, EPS, plan=p))
            sweep[name] = {"device_ms_by_plan": times, "pick": str(tuple(pick))}
        result = {"plan_sweep": sweep}
print(json.dumps(result))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, run in this order")
    ap.add_argument("--plan", action="store_true", help="also time every candidate plan at each geometry")
    args = ap.parse_args(argv)

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        card = None
    if card is None or card.returncode != 0:
        print("torch_window_attention_v1_ab: nvidia-smi failed (no CUDA device?)", file=sys.stderr)
        return 2
    composition_done = False
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        result = {"tree": tree}
        runs = ["kernel"] + ([] if composition_done else ["composition"]) + (["plan"] if args.plan else [])
        for what in runs:  # one process each: one profiler session a process
            out = subprocess.run([sys.executable, "-c", CHILD, what], cwd=root, env=env, capture_output=True,
                                 text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree}: {what} failed")
            result.update(json.loads(out.stdout.strip().splitlines()[-1]))
        composition_done = composition_done or result.get("composition") is not None
        print(json.dumps(result), flush=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
