#!/usr/bin/env python3
"""Capture a torch.profiler trace of the PyTorch port's video propagation on
the card and print device self-time breakdowns (by device category, by
module, by kernel).

Twin of tools/profile_propagation.py: the port's ``utils/profiling.trace``
(with a range for every forward call of the model's modules) and
``utils/traceparse.parse_trace`` in place of xprof. The predictor is the
preset's with weights made from seed 0, bf16, hole filling on; the video is
seeded noise with one click at the centre of frame 0. Two runs first (the
first captures the frame body's CUDA graph), then one traced run of the
propagation (init_state and the click outside the trace). Each tracked frame
is one graph replay, so its kernels are attributed to "graph replay"; the
prompted frame's encode and memory write run eagerly, module by module. The
program's spans (``utils/profiling.span_totals``) of the same traced run,
timed on the card inside every replay, go to ``spans.jsonl`` beside the
trace (a line a span; not ``*.json``, which the parser would take for a
trace) and are printed beside the tallies: device ms by stage, with counts,
rows and parents.
The trace goes to ``--out``, by default ``build/prop_trace`` in this
checkout (ignored by git), so two checkouts never read each other's trace.
A trace in which a launch has no device event is refused
(``traceparse.IncompleteTrace``): its sums would under-count the card's time.

Usage:
    python tools/torch_profile_propagation.py [--frames 64] [--out DIR] [--cfg sam2.1_hiera_t512]
    python tools/torch_profile_propagation.py --analyze-only [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def capture(out_dir: str, num_frames: int, cfg_name: str = "sam2.1_hiera_t512") -> None:
    import numpy as np
    import torch

    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor
    from us_video_medsam2_tpu_torch.utils import profiling

    predictor = build_sam2_video_predictor(cfg_name, fill_hole_area=8)  # the card; raises without one
    size = predictor.model.cfg.image_size
    video = np.random.default_rng(0).standard_normal((num_frames, size, size, 3)).astype(np.float32)

    def prompted():
        state = predictor.init_state(video, size, size, 1)
        predictor.add_new_points_or_box(state, 0, 1, points=np.array([[size / 2, size / 2]]), labels=np.array([1]))
        return state

    def propagate(state):
        for _ in predictor.propagate_in_video(state):
            pass
        torch.cuda.synchronize()

    propagate(prompted())  # captures the frame body's graph
    propagate(prompted())
    state = prompted()
    profiling.reset_spans()
    with profiling.trace(out_dir, modules=predictor.model):
        propagate(state)
    with open(os.path.join(out_dir, "spans.jsonl"), "w") as f:
        for name, t in profiling.span_totals().items():
            f.write(json.dumps({"name": name, **t, "parents": {str(p): n for p, n in t["parents"].items()}}) + "\n")
    print(f"trace and spans written to {out_dir}", file=sys.stderr)


def analyze(out_dir: str, top: int = 30, frames: int = 64) -> dict:
    """Parse the newest trace under ``out_dir``: device self time by
    category, module and kernel; writes ``summary.json`` there and returns it."""
    from us_video_medsam2_tpu_torch.utils.traceparse import parse_trace

    self_op, self_mod, self_cat, args_of = parse_trace(out_dir)
    total = sum(self_op.values())
    tracked = max(frames - 1, 1)
    print(f"total device self time: {total / 1e3:.2f} ms  ({total / tracked / 1e3:.3f} ms/tracked frame)")
    print("\n-- by device category --")
    for c, d in self_cat.most_common(15):
        print(f"{d / 1e3:9.2f} ms {100 * d / total:5.1f}%  {c}")
    print("\n-- by module --")
    for m, d in self_mod.most_common(20):
        print(f"{d / 1e3:9.2f} ms {100 * d / total:5.1f}%  {m[:110]}")
    print(f"\n-- top {top} kernels (self) --")
    for n, d in self_op.most_common(top):
        a = args_of.get(n, {})
        print(f"{d / 1e3:9.2f} ms {100 * d / total:5.1f}%  {n[:90]:90s} grid {a.get('grid', '')}")
    spans_path = os.path.join(out_dir, "spans.jsonl")
    spans = {}
    if os.path.exists(spans_path):
        with open(spans_path) as f:
            spans = {t.pop("name"): t for t in map(json.loads, f)}
        print("\n-- by program span (device ms inside graph replays too; utils/profiling.span_totals) --")
        for name, t in sorted(spans.items(), key=lambda kv: -kv[1]["device_ms"]):
            print(f"{t['device_ms']:9.2f} ms {100 * t['device_ms'] * 1e3 / total:5.1f}%  {name:24s} "
                  f"count {t['count']} rows {t['rows']} host {t['host_ms']:.2f} ms parents {t['parents']}")
    summary = {
        "total_ms": total / 1e3,
        "ms_per_tracked_frame": total / tracked / 1e3,
        "by_category": {c: d / 1e3 for c, d in self_cat.most_common()},
        "by_module": {m: d / 1e3 for m, d in self_mod.most_common(25)},
        "top_ops": [{"name": n, "ms": d / 1e3, "grid": args_of.get(n, {}).get("grid", "")}
                    for n, d in self_op.most_common(top)],
        "spans": spans,
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "prop_trace"))
    ap.add_argument("--analyze-only", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--cfg", default="sam2.1_hiera_t512")
    args = ap.parse_args(argv)
    if not args.analyze_only:
        capture(args.out, args.frames, args.cfg)
    return analyze(args.out, args.top, args.frames)


if __name__ == "__main__":
    main()
