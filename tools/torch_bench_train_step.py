#!/usr/bin/env python3
"""Train-step timing of the PyTorch port on the card: the captured step
beside the same body run eagerly, host ms per step, device ms per step, idle
share, FLOPs and MFU.

Twin of tools/bench_train_step.py (reference hot loop: training/trainer.py
836-880, batch 1 video x 4 frames x <= 5 objects, 512², bf16), with weights
made from seed 0 and f32 master weights. The step (``make_train_step``) is
one CUDA graph replayed each step; its first call runs the body eagerly and
captures it (the capture's seconds, taken apart, and its memory pool are
recorded). Then
``--steps`` replays, each timed on the host clock up to ``synchronize``
(median kept), and the same number of eager runs of the body
(``TrainStep.eager``, the body a capture records), with the same step
seeds. Each set runs once more under ``utils/profiling.trace``, whose device
busy time ``utils/traceparse`` gives (a trace in which a launch has no
device event is refused: it would under-count that time); the idle share is
1 - device ms / host ms. The step's FLOPs come from ``utils/flops`` on a host
copy in f32 (the kernels' plain versions): every plan runs the same
operations, so one step is counted. MFU = FLOPs / device seconds / the
card's dense bf16 peak, of the captured step.

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
    from us_video_medsam2_tpu_torch.training.train_model import TrainSimConfig
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
    batch, step = batch_on("cuda"), make_train_step(tcfg)
    seeds = list(range(1, args.steps + 1))

    def timed(fn, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fn(state, batch, seed)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    _, capture_wall = timed(step, 0)  # the first call: the eager body, then the capture
    graph = step.captured.last
    runs = {}
    for name, fn in (("captured", step), ("eager", step.eager)):
        timed(fn, 0)  # a first eager call of its own: the kernels' library loaded
        walls = []
        for s_ in seeds:
            m, w = timed(fn, s_)
            walls.append(w)
        tdir = args.profile and os.path.join(args.profile, name) or tempfile.mkdtemp(prefix="train_bench_trace_")
        with trace(tdir, modules=state.model):
            for s_ in seeds:
                fn(state, batch, s_)
            torch.cuda.synchronize()
        device_ms = device_self_time_ms(tdir) / args.steps
        if not args.profile:
            import shutil

            shutil.rmtree(tdir, ignore_errors=True)
        median = 1e3 * statistics.median(walls)
        runs[name] = {"ms_per_step": round(median, 3), "device_ms_per_step": round(device_ms, 3),
                      "idle_share": round(1.0 - device_ms / median, 4), "core_loss": round(float(m["core_loss"]), 4)}
    if step.captures != 1:
        raise AssertionError(f"{step.captures} captures, expected 1")
    runs["captured"].update(captures=step.captures, capture_s=round(graph.capture_s, 3),
                            warm_up_s=round(graph.warm_up_s, 3),
                            capture_parts_s={k: round(v, 3) for k, v in graph.parts_s.items()},
                            first_call_ms=round(1e3 * capture_wall, 1),
                            graph_pool_mib=round(graph.pool_bytes / 2**20, 1))
    del state, graph, step
    torch.cuda.empty_cache()

    # FLOPs of one step (every plan runs the same operations), on a host copy in f32
    host_model = build_sam2(cfg, state_dict=weights, binarize_mask_from_pts_for_mem_enc=False)
    host = create_train_state(host_model, tcfg, device="cpu", dtype=torch.float32)
    flops = fn_flops(make_train_step(tcfg), host, batch_on("cpu"), seeds[0])
    kind = torch.cuda.get_device_name(0)
    peak = peak_bf16_flops(kind)
    cap, eager = runs["captured"], runs["eager"]
    mfu_pct = None if peak is None else round(100.0 * flops / (cap["device_ms_per_step"] / 1e3) / peak, 3)
    print(f"train_step {args.cfg}/{args.fusion} {t}f x {o}obj @{size}²: captured {cap['ms_per_step']:.2f} ms/step "
          f"(device {cap['device_ms_per_step']:.2f} ms, idle {cap['idle_share']:.3f}; capture "
          f"{cap['capture_s']:.2f} s, pool {cap['graph_pool_mib']:.1f} MiB), eager {eager['ms_per_step']:.2f} ms/step "
          f"(device {eager['device_ms_per_step']:.2f} ms, idle {eager['idle_share']:.3f}), median over {args.steps}; "
          f"{flops / 1e9:.1f} GFLOP/step, MFU {mfu_pct}% ({kind}; {card_line()})")
    record = {
        "metric": f"train_step_ms_{os.path.basename(args.cfg)}_{args.fusion}",
        "value": cap["ms_per_step"],
        "unit": "ms/step (host clock, median, captured step)",
        "captured": cap,
        "eager": eager,
        "mfu_pct": mfu_pct,
        "flops_per_step_gflop": round(flops / 1e9, 1),
        "frames": t,
        "objects": o,
        "image_size": size,
        "card": card_line(),
    }
    print(json.dumps(record))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
