# Frozen copy of us_video_medsam2_tpu_torch/utils/traceparse.py at commit 40a6c6c:
# the benchmark reads its traces with this copy, which later changes to the
# program do not touch.
"""Parse torch.profiler Chrome traces into device self-time tallies.

Counterpart of the JAX package's ``utils/traceparse.py``, which reads the
"XLA Ops" track of an xprof trace. Here the device track is the trace's
events of the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` categories (one
thread per CUDA stream). A device event is attributed to the host range that
launched it: its ``correlation`` id names the runtime call (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) on a host thread, and the innermost module or
``record_function`` range around that call names the module (the ranges that
``utils/profiling.py::trace(modules=...)`` records, or any
``user_annotation``), else the outermost operator around it (``aten::linear``,
or in a backward pass ``autograd::engine::evaluate_function: MmBackward0``). The
kernels of a CUDA-graph replay share the correlation id of its one
``cudaGraphLaunch``: they are attributed to the replay (module
``"graph replay"``, or ``"<range> (graph replay)"`` inside a range), not to
the modules that were captured.

Device events on one stream do not nest, so a kernel's self time is its
duration and the tallies sum to the device's busy time (streams that overlap
count both). Device events launched inside a ``WARMUP_RANGE`` range (the
empty kernels ``utils/profiling.py::trace`` starts a trace with) are left out.

A trace is complete when every kernel or graph launch outside that range has
a device event. An H100's profiler was seen to drop the device records of a
trace's first ~31 launches: such a trace under-counts the device time, so
``tallies`` (and with it ``parse_trace`` and ``device_self_time_ms``) raises
``IncompleteTrace`` for it rather than return its sums.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_RANGE_CATEGORIES = ("user_annotation", "python_function")
MODULE_PREFIX = "nn.Module: "
WARMUP_RANGE = "profiling: warm-up launches"
_LAUNCH = re.compile(r"Launch(Cooperative)?Kernel|GraphLaunch")  # runtime and driver calls that run kernels


class IncompleteTrace(ValueError):
    """A trace in which launches have no device event (``lost_launches``)."""


def newest_trace(trace_dir: str) -> str:
    """The newest ``*.json`` / ``*.json.gz`` Chrome trace under ``trace_dir``."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)
             if not p.endswith("summary.json")]
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json, *.json.gz) under {trace_dir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def load_events(trace_dir: str) -> list:
    path = newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_events(events: list, sites: dict | None = None) -> list:
    """The complete (``ph`` X) events of the device track but the warm-up
    launches' (``sites``: ``_launch_sites(events)``, computed when not
    given); raises if there are none, since a trace without them measured
    nothing on the card."""
    sites = _launch_sites(events) if sites is None else sites
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
           and sites.get((e.get("args") or {}).get("correlation"), (None, None))[1] != WARMUP_RANGE]
    if not dev:
        raise ValueError("the trace has no device track (no kernel, gpu_memcpy or gpu_memset event): "
                         "the profiler recorded no device activity")
    return dev


def lost_launches(events: list, sites: dict | None = None) -> list:
    """The kernel and graph launches (runtime or driver calls) outside a
    ``WARMUP_RANGE`` range whose correlation id no device event has, by
    time. A graph launch counts as recorded when one of its kernels is."""
    sites = _launch_sites(events) if sites is None else sites
    seen = {(e.get("args") or {}).get("correlation") for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES}
    launches = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and _LAUNCH.search(e.get("name", ""))]
    return sorted((e for e in launches if (corr := (e.get("args") or {}).get("correlation")) not in seen
                   and sites.get(corr, (None, None))[1] != WARMUP_RANGE), key=lambda e: e["ts"])


def _module_name(name: str) -> str:
    if name.startswith(MODULE_PREFIX):
        name = name[len(MODULE_PREFIX):]
    return ".".join(name.split(".")[:4])


def _launch_sites(events: list) -> dict:
    """correlation id -> (runtime call name, innermost range name or None,
    outermost operator name or None) for every runtime call in the trace."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver") or cat in _RANGE_CATEGORIES or cat == "cpu_op":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    sites = {}
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack = []  # open ranges and operators: (end, category, name)
        for e in evs:
            ts = e["ts"]
            while stack and stack[-1][0] <= ts:
                stack.pop()
            cat = e["cat"]
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is None:
                    continue
                rng = next((n for _, c, n in reversed(stack) if c in _RANGE_CATEGORIES), None)
                op = next((n for _, c, n in stack if c == "cpu_op"), None)
                sites[corr] = (e["name"], rng, op)
            else:
                stack.append((ts + e.get("dur", 0.0), cat, e["name"]))
    return sites


def _attribute(device_event: dict, sites: dict) -> str:
    """The module a device event is attributed to (see the module docstring)."""
    site = sites.get((device_event.get("args") or {}).get("correlation"))
    if site is None:
        return "?"
    call, rng, op = site
    where = _module_name(rng) if rng is not None else op
    if "GraphLaunch" in call:
        return "graph replay" if rng is None else f"{_module_name(rng)} (graph replay)"
    return where if where is not None else call


def parse_trace(trace_dir: str):
    """Self-time tallies from the newest Chrome trace under ``trace_dir``.

    Returns (self_op, self_mod, self_cat, args_of): Counters of device self
    time in MICROSECONDS keyed by kernel (or copy) name, by module (see the
    module docstring), and by device category, plus each name's first
    event's args. Raises if the trace has no device track, and
    ``IncompleteTrace`` if a launch has no device event."""
    return tallies(load_events(trace_dir))


def tallies(events: list):
    """``parse_trace``'s tallies of a trace's loaded events."""
    sites = _launch_sites(events)
    dev = device_events(events, sites)
    lost = lost_launches(events, sites)
    if lost:
        first = lost[0]["ts"]
        raise IncompleteTrace(f"{len(lost)} kernel or graph launches have no device event (the profiler lost "
                              f"their records), the first at ts {first} us, the next "
                              f"{[round(e['ts'] - first) for e in lost[1:10]]} us after it")
    self_op: collections.Counter = collections.Counter()
    self_mod: collections.Counter = collections.Counter()
    self_cat: collections.Counter = collections.Counter()
    args_of: dict = {}
    for e in dev:
        d = float(e.get("dur", 0.0))
        self_op[e["name"]] += d
        self_mod[_attribute(e, sites)] += d
        self_cat[e["cat"]] += d
        args_of.setdefault(e["name"], e.get("args") or {})
    return self_op, self_mod, self_cat, args_of


def event_counts(events: list) -> collections.Counter:
    """A trace's device events (``load_events``) by name: one a kernel launch."""
    return collections.Counter(e["name"] for e in device_events(events))


def device_self_time_ms(trace_dir: str) -> float:
    """Total device busy time (ms) of the newest trace under ``trace_dir``."""
    self_op, _, _, _ = parse_trace(trace_dir)
    return sum(self_op.values()) / 1e3


# Dense bf16 tensor-core peak per card, FLOP/s (NVIDIA's data sheets, without
# sparsity), by the name torch.cuda.get_device_name() gives; used for MFU only.
_PEAK_BF16_FLOPS = {
    "H100 80GB HBM3": 989e12,  # SXM5
    "H100 SXM": 989e12,
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
    "H200": 989e12,
}


def peak_bf16_flops(device_name: str) -> float | None:
    """Dense bf16 peak FLOP/s of the card named ``device_name``, or None for a
    card this table does not know."""
    for key, peak in sorted(_PEAK_BF16_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if key.lower() in device_name.lower():
            return peak
    return None
