"""The benchmark's harness: one run of one cell, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds everything by those names and by the metrics' names:

- ``perfbench/configs/<config>.json``: the model configuration as it is run
  (``model``: the port's ``SAM2Config`` as a dict), its dtype and source;
- ``perfbench/traffic/<traffic>.json``: the mix's parameters and its ``kind``,
  the driver ``perfbench/drivers/<kind>.py`` that runs it;
- ``perfbench/metrics/<metric>.py``: a reader ``read(run)`` for each metric,
  end to end or per layer, which returns a number or None (nothing to read);
- ``perfbench/limits/<cell>.json``: the limit of each number that the cell's
  correctness comparison prints.

A driver builds the program and its inputs from the seed, warms up the cell's
shapes, measures for ``--seconds`` (``--trace 0``) or traces a fixed amount of
work (``--trace 1``), and then compares what the timed path produced with the
plain reference of ``perfbench/reference``. It fills a ``Run``; the readers
turn that into the result line. The harness prints the line last on standard
output and the compared numbers last on standard error.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# top-level modules that must not be loaded in the process that prints a result
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "us_video_medsam2_tpu")
TRACE_DIR = ROOT / "build" / "perfbench" / "trace"
TRACE_ATTEMPTS = 3
IDLE_GAPS_NAMED = 2000  # the longest idle gaps, each attributed to what the host was doing
PEAK_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


class Refused(Exception):
    """A run that must print no result (exit code 1)."""


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    cell: str
    config: dict  # perfbench/configs/<config>.json
    traffic: dict  # perfbench/traffic/<traffic>.json
    limits: dict  # perfbench/limits/<cell>.json ({} when there is none)
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # perf_counter at the process's start: set-up runs from here


@dataclasses.dataclass
class Run:
    """What a driver measured; the metrics' readers read it."""

    setup_s: float = 0.0
    window_s: float = 0.0  # the measured window, host clock
    attempted: int = 0  # requests (a batch of videos, or one video) begun in the window
    failed: int = 0
    frames: int = 0  # frames whose masks reached the host in the window
    request_ms: list = dataclasses.field(default_factory=list)
    prompt_ms: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds of each step of set-up, by name
    compare_s: float = 0.0  # the comparison's seconds, after the window
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    gaps: list = dataclasses.field(default_factory=list)  # the compared frames' gaps, a tensor a request
    # --trace 1
    trace: dict | None = None  # traced window: tallies, device events, spans, busy and window seconds
    traced_frames: int = 0
    traced_requests: int = 0
    flops_per_request: float | None = None  # model FLOPs of one traced request (the reference's count)
    work_per_request: list = dataclasses.field(default_factory=list)  # kernel sites' calls of one request
    peak_flops: float | None = None
    peak_bytes_per_s: float = PEAK_HBM_BYTES_PER_S
    device_kind: str = ""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise Refused(f"no workload {cell!r} in BENCHMARK.json: {[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise Refused(f"no configuration {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    reported = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def context(cell: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
            bench: dict | None = None, overrides: dict | None = None) -> Context:
    """The cell's files, read; ``overrides`` ({"config": {...}, "traffic":
    {...}}) update them (the CPU tests run a cell at a tiny size)."""
    bench = benchmark() if bench is None else bench
    w = cell_entry(bench, cell)
    cfg = load_json(ROOT / config_entry(bench, w["config"])["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{cell}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    return Context(cell, cfg, traffic, limits, seed, seconds, trace, device, t_start)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def metrics_of(bench: dict, cell: str, trace: bool, run: Run) -> dict:
    out = {}
    for m in cell_metrics(bench, cell, "per_layer" if trace else "end_to_end"):
        value = reader(m["name"])(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise Refused(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(run: Run) -> bool:
    """Every compared number finite and within its limit, and no request failed."""
    ok = run.failed == 0 and bool(run.checks)
    for _, value, limit in run.checks:
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return ok


def result_line(bench: dict, ctx: Context, run: Run, device_count: int) -> dict:
    device = {"platform": "gpu", "kind": run.device_kind, "count": device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": judge(run), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics_of(bench, ctx.cell, ctx.trace, run), "device": device}
    if ctx.trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in run.checks}
    return line


def cuda_devices(chips: int):
    """(device name, count) of the cards, or Refused when there are fewer than ``chips``."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: the benchmark runs on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
    return torch.cuda.get_device_name(0), chips


def program_in_checkout() -> None:
    """The port imported from this checkout, not from an installation elsewhere."""
    try:
        import us_video_medsam2_tpu_torch as port
    except ImportError as e:
        raise Refused(f"the program is not in this checkout: {e}") from None
    where = Path(port.__file__).resolve()
    if not where.is_relative_to(ROOT):
        raise Refused(f"the program was imported from {where}, outside the checkout {ROOT}")


def set_cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)


def main(argv_args, t_start: float) -> int:
    """Run one cell once; the exit code."""
    set_cache_dirs()
    try:
        bench = benchmark()
        w = cell_entry(bench, argv_args.workload)
        kind, count = cuda_devices(int(w["chips"]))
        program_in_checkout()
        ctx = context(argv_args.workload, argv_args.seed, argv_args.seconds, bool(argv_args.trace), "cuda",
                      t_start, bench)
        run = driver(ctx.traffic["kind"]).run(ctx)
        run.device_kind = kind
        found = forbidden_modules()
        if found:
            raise Refused(f"modules loaded in the benchmark's process: {found}")
        line = result_line(bench, ctx, run, count)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 1
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items()), file=sys.stderr)
    print(f"comparison: {run.compare_s:.3f} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


# ---------------------------------------------------------------- tracing


def traced(fn, sync):
    """``fn()`` under torch.profiler (CPU and CUDA activity), inside a
    ``perfbench.window`` range after the warm-up launches that the frozen
    ``traceparse`` leaves out; the Chrome trace parsed. A trace in which
    launches lost their device records is taken again (``fn`` called again),
    up to ``TRACE_ATTEMPTS`` times. Returns (the first call's ``fn()``, the
    trace summary)."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from perfbench.frozen import traceparse

    first = None
    for attempt in range(TRACE_ATTEMPTS):
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(traceparse.WARMUP_RANGE):
                for _ in range(128):
                    torch.cuda._sleep(0)
            sync()
            t0 = time.perf_counter()
            with record_function("perfbench.window"):
                out = fn()
                sync()
            t1 = time.perf_counter()
        first = out if attempt == 0 else first
        prof.export_chrome_trace(str(TRACE_DIR / "trace.json"))
        events = traceparse.load_events(str(TRACE_DIR))
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
        try:
            self_op, self_mod, self_cat, _ = traceparse.tallies(events)
        except traceparse.IncompleteTrace as e:
            print(f"perfbench: trace attempt {attempt + 1}: {e}", file=sys.stderr)
            continue
        return first, summarize(events, self_op, self_cat, t1 - t0)
    raise Refused(f"{TRACE_ATTEMPTS} traces in a row lost device records")


def summarize(events: list, self_op, self_cat, window_wall_s: float) -> dict:
    """Busy time, the window, the top device operations and the longest idle
    gaps (by the benchmark's innermost span and the host operator running
    then) of a parsed trace."""
    from perfbench.frozen import traceparse

    win = next(e for e in events if e.get("ph") == "X" and e.get("name") == "perfbench.window")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in traceparse.device_events(events))
    gaps, cursor = [], w0
    for a, b in dev:
        if a > cursor:
            gaps.append((cursor, min(a, w1)))
        cursor = max(cursor, b)
    if cursor < w1:
        gaps.append((cursor, w1))
    spans = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] != "perfbench.window"]
    ops = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    starts = [o[0] for o in ops]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])
    idle: dict = {}
    for i, (a, b) in enumerate(gaps):
        if i >= IDLE_GAPS_NAMED:
            name = f"shorter gaps than the {IDLE_GAPS_NAMED} longest"
        else:
            mid = (a + b) / 2
            span = min((h for h in spans if h[0] <= mid < h[1]), key=lambda h: h[1] - h[0], default=None)
            # the outermost host operator running at the gap's middle, among those begun in the last 100 ms
            j = bisect.bisect_right(starts, mid)
            op = None
            while j > 0 and ops[j - 1][0] >= mid - 1e5:
                j -= 1
                if ops[j][1] > mid and (op is None or ops[j][0] <= op[0]):
                    op = ops[j]
            name = " / ".join(x[2] for x in (span, op) if x is not None) or "outside any span or operator"
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    busy_s = sum(self_op.values()) / 1e6
    return {
        "busy_s": busy_s,
        "window_s": win["dur"] / 1e6,
        "window_wall_s": window_wall_s,
        "self_op": dict(self_op),
        "self_cat": dict(self_cat),
        "breakdown": {
            "device_ops": [[n, s / 1e6] for n, s in sorted(self_op.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
        "spans": [(name, (b - a) / 1e3) for a, b, name in spans],
    }
