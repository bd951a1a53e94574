#!/usr/bin/env python3
"""Train-step timing of the PyTorch port on the card: host ms per step,
device ms per step, FLOPs and MFU.

Twin of tools/bench_train_step.py (reference hot loop: training/trainer.py
836-880, batch 1 video x 4 frames x <= 5 objects, 512², bf16), with weights
made from seed 0 and f32 master weights. The port's step is an eager loop,
so there is no scan to time: ``--steps`` steps run one after another after a
warm-up step, each timed on the host clock up to ``synchronize`` (median
kept), then the same number of steps (the same plans, replayed from the
generator's states) runs under ``utils/profiling.trace``, whose device busy
time ``utils/traceparse`` gives (a trace in which a launch has no device
event is refused: it would under-count that time). The FLOPs of those steps come from
``utils/flops`` on a host copy in f32 (the kernels' plain versions), each
step's plan replayed there; a step's FLOPs depend on its plan only (its
prompt mode, conditioning and corrected frames), so each distinct plan is
counted once. MFU = FLOPs / device seconds / the card's dense bf16 peak.

Usage: python tools/torch_bench_train_step.py [--steps 10] [--frames 4] [--objects 3]
           [--cfg sam2.1_hiera_t512 | efficientmedsam_s_512 | a YAML] [--fusion gfte]
           [--profile DIR] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--objects", type=int, default=3)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512",
                    help="config preset or YAML (e.g. efficientmedsam_s_512 for the reference's FLARE finetune "
                         "recipe)")
    ap.add_argument("--fusion", default="gfte", choices=["none", "tce", "gfte", "atsf", "gp"])
    ap.add_argument("--profile", default=None, help="keep the trace of the timed steps in this directory")
    ap.add_argument("--json", default=None, help="write the JSON record here")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.core.build import build_sam2
    from us_video_medsam2_tpu_torch.core.config import TemporalFusionConfig, resolve_config
    from us_video_medsam2_tpu_torch.training.losses import LossConfig
    from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig, sample_plan
    from us_video_medsam2_tpu_torch.training.train_step import (
        TrainBatch,
        TrainConfig,
        create_train_state,
        make_train_step,
    )
    from us_video_medsam2_tpu_torch.utils.flops import fn_flops
    from us_video_medsam2_tpu_torch.utils.profiling import card_line, trace
    from us_video_medsam2_tpu_torch.utils.traceparse import device_self_time_ms, peak_bf16_flops

    if not torch.cuda.is_available():
        raise RuntimeError("torch_bench_train_step: no CUDA device; the step is timed on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resolve_config(args.cfg)
    if args.fusion != "none":
        cfg = dataclasses.replace(cfg, temporal_fusion=TemporalFusionConfig(variant=args.fusion,
                                                                             channels=cfg.hidden_dim))
    model = build_sam2(cfg, seed=0, binarize_mask_from_pts_for_mem_enc=False)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = TrainConfig(sim=TrainSimConfig(), loss=LossConfig(weight_temporal=0.5, temporal_variant="consistency"),
                       optim=OptimConfig(total_steps=1000))
    size = cfg.image_size
    t, b, o = args.frames, 1, args.objects
    rng = np.random.default_rng(0)
    masks = np.zeros((t, b, o, size, size), bool)
    masks[:, :, :, 140 * size // 512:360 * size // 512, 120 * size // 512:330 * size // 512] = True
    images = rng.standard_normal((t, b, size, size, 3)).astype(np.float32)

    def batch_on(device):
        return TrainBatch(torch.from_numpy(images).to(device), torch.from_numpy(masks).to(device),
                          torch.ones(b, o, dtype=torch.bool, device=device))

    state = create_train_state(model, tcfg)  # the card, bf16 compute, f32 master weights
    batch, step, gen = batch_on("cuda"), make_train_step(tcfg), torch.Generator().manual_seed(0)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    timed()  # warm-up: first calls, the kernels' library loaded
    m, single = timed()
    walls, plans = [], []
    for _ in range(args.steps):
        plans.append(gen.get_state())
        m, w = timed()
        walls.append(w)
    loss = float(m["core_loss"])
    # the same plans again under the profiler
    tdir = args.profile or tempfile.mkdtemp(prefix="train_bench_trace_")
    with trace(tdir, modules=state.model):
        for p in plans:
            gen.set_state(p)
            step(state, batch, gen)
        torch.cuda.synchronize()
    device_ms = device_self_time_ms(tdir) / args.steps
    if not args.profile:
        import shutil

        shutil.rmtree(tdir, ignore_errors=True)
    del state
    torch.cuda.empty_cache()

    # FLOPs of each distinct plan, on a host copy in f32
    host_model = build_sam2(cfg, state_dict=weights, binarize_mask_from_pts_for_mem_enc=False)
    host = create_train_state(host_model, tcfg, device="cpu", dtype=torch.float32)
    host_batch, counted = batch_on("cpu"), {}
    total_flops = 0
    for p in plans:
        g = torch.Generator().manual_seed(0)
        g.set_state(p)
        plan = sample_plan(g, tcfg.sim, t, True)
        key = (plan.mode, plan.n_init, tuple(plan.is_init), tuple(plan.should_correct))
        if key not in counted:
            g.set_state(p)
            counted[key] = fn_flops(step, host, host_batch, g)
        total_flops += counted[key]
    flops = total_flops / args.steps
    kind = torch.cuda.get_device_name(0)
    peak = peak_bf16_flops(kind)
    mfu_pct = None if peak is None else round(100.0 * flops / (device_ms / 1e3) / peak, 3)
    median = 1e3 * statistics.median(walls)
    print(f"train_step {args.cfg}/{args.fusion} {t}f x {o}obj @{size}²: single step {1e3 * single:.1f} ms wall, "
          f"median {median:.1f} ms/step over {args.steps}, device {device_ms:.2f} ms/step, "
          f"{flops / 1e9:.1f} GFLOP/step, MFU {mfu_pct}% ({kind}; {card_line()}) (core_loss {loss:.4f})")
    record = {
        "metric": f"train_step_ms_{os.path.basename(args.cfg)}_{args.fusion}",
        "value": round(median, 2),
        "unit": "ms/step (host clock, median)",
        "single_step_ms": round(1e3 * single, 1),
        "device_ms_per_step": round(device_ms, 2),
        "mfu_pct": mfu_pct,
        "flops_per_step_gflop": round(flops / 1e9, 1),
        "plans_counted": len(counted),
        "frames": t,
        "objects": o,
        "image_size": size,
        "core_loss": round(loss, 4),
        "card": card_line(),
    }
    print(json.dumps(record))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
