"""Profiling hooks: a torch.profiler trace, and the program's spans timed on the card.

Counterpart of the JAX package's ``utils/profiling.py``. ``trace`` writes the
Chrome trace that ``utils/traceparse.py`` reads (CPU ranges and, with a
card, its kernels, copies and fills).

``span(name, rows, device)`` times one stage of the program. It records only
while its gate is open: while a torch profiler records, or inside a
``recording()`` block (stage times in production, with no profiler). With
the gate closed an eager span costs two Python checks, and nothing else.
With it open, a span opens a ``record_function`` range of its name (so it
lies on the profiler's clock beside the device trace), adds its host time,
its count and its ``rows`` (the batch it ran) under the span open around it,
and launches two marks on the device's current stream: one-thread kernels
(``csrc/span_mark.cu``) that read ``%globaltimer`` when the stream reaches
them, the first storing the time in the name's row of a device table, the
second adding the time since. A span's device time therefore runs from the
moment the stream reaches its start to the moment it reaches its end: it
holds the idle time the host leaves inside it and not the time it waited
behind earlier work. On the CPU the marks read the host clock.

A CUDA graph (``utils/graphs.py::FrameGraph``) captures its body's marks
whatever the gate, and records which spans its capture opened (name, rows,
the span around each inside the body). Every mark first reads a flag in the
device table and returns at once when it is 0; before each replay the graph
writes the flag from the gate (only when it changes) and, with the gate
open, adds its spans' counts and rows, under the span open around the
replay. So the frame body's stages are timed inside every replay made while
the gate is open, and a replay made while it is closed costs its marks'
launches. Spans record only under ``torch.inference_mode()``: the training
and eval steps, captured or eager, record none.

``span_totals()`` gives ``{name: {count, rows, host_ms, device_ms,
parents}}`` with one device-to-host read a device; ``reset_spans()`` clears
them. Both are process-wide, as the kernels' launch counters are.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import threading
import time
from typing import Iterator

import torch
from torch.autograd.profiler import record_function

from us_video_medsam2_tpu_torch.kernels import _lib

from us_video_medsam2_tpu_torch.utils.traceparse import MODULE_PREFIX, WARMUP_RANGE


@contextlib.contextmanager
def _module_ranges(root: torch.nn.Module) -> Iterator[None]:
    """A ``record_function`` range ``nn.Module: <path>`` around every forward
    call of ``root``'s modules (global forward hooks, removed on exit)."""
    from torch.nn.modules.module import register_module_forward_hook, register_module_forward_pre_hook

    names = {id(m): n or type(m).__name__ for n, m in root.named_modules()}
    open_ranges = []

    def enter(module, args):
        name = names.get(id(module))
        if name is not None:
            rf = record_function(MODULE_PREFIX + name)
            rf.__enter__()
            open_ranges.append((module, rf))

    def leave(module, args, out):
        if open_ranges and open_ranges[-1][0] is module:
            open_ranges.pop()[1].__exit__(None, None, None)

    pre = register_module_forward_pre_hook(enter)
    post = register_module_forward_hook(leave, always_call=True)
    try:
        yield
    finally:
        pre.remove()
        post.remove()


@contextlib.contextmanager
def trace(log_dir: str, modules: torch.nn.Module | None = None) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (CPU activity, and CUDA activity when a
    card is present) and write its Chrome trace to
    ``log_dir/<host>_<pid>.<ns>.pt.trace.json`` on exit, the name
    torch.profiler's TensorBoard handler gives. With ``modules``, every
    forward call of its submodules is a range named by the submodule's path,
    which ``utils/traceparse.py`` attributes device time to (the kernels of
    a CUDA-graph replay launch outside any forward call). Yields the
    profiler, whose ``key_averages()`` cover the same events.

    On a card the trace begins with ``warm_up``'s launches, which
    ``utils/traceparse.py`` leaves out."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    ranges = _module_ranges(modules) if modules is not None else contextlib.nullcontext()
    with profile(activities=activities) as prof:
        if cuda:
            warm_up()
        with ranges:
            yield prof
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


WARMUP_LAUNCHES = 128


def warm_up() -> None:
    """``WARMUP_LAUNCHES`` launches of an empty kernel (``spin_kernel``) inside
    a ``WARMUP_RANGE`` range, then a synchronize: the first thing to run
    under a profiler that records CUDA activity. On an H100 a profile loses
    the device records of the kernels launched in its first milliseconds:
    9 minutes into a process each trace lost its first 31-32 launches,
    trace after trace, and a profile of 10 calls of a 0.03 ms kernel saw
    none of them, three profiles in a row."""
    with record_function(WARMUP_RANGE):
        for _ in range(WARMUP_LAUNCHES):
            torch.cuda._sleep(0)
    torch.cuda.synchronize()


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (the first card), to stand beside every
    time measured on it: a card set below its maximum power runs slower."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ spans

MAX_SPANS = 31  # span names a process can time: the device table's rows after the flag's

_profiler_enabled = torch._C._autograd._profiler_enabled
_RECORDING = 0  # recording() blocks open
_SLOTS: dict = {}  # name -> its row of the device tables, for the process's life (a captured mark holds it)
_TOTALS: dict = {}  # name -> {count, rows, host_ns, parents}
# device -> int64 [1 + MAX_SPANS, 2]: [0, 0] the flag the marks read, row 1 + slot
# (start, summed ns); made outside any capture, never freed (a graph's marks hold it)
_TABLES: dict = {}
_FLAGS: dict = {}  # device -> the flag's value last written
_mark_fn = None  # usm_span_mark, bound at the first mark on a card


class _Thread(threading.local):
    def __init__(self):
        self.capture = None  # the spans a FrameGraph capture on this thread opened, or None
        self.stack = []  # names of the spans open on this thread, innermost last


_THREAD = _Thread()
_CLOSED = contextlib.nullcontext()


def gate_open() -> bool:
    """Whether spans record: a torch profiler is recording or a ``recording()`` block is open."""
    return bool(_RECORDING) or _profiler_enabled()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans record inside this block, with no profiler running."""
    global _RECORDING
    _RECORDING += 1
    try:
        yield
    finally:
        _RECORDING -= 1


def span(name: str, rows: int = 0, device=None):
    """A context manager that times the enclosed stage as ``name`` (a fixed
    string: the breakdowns group by it), counting ``rows`` (the batch it
    ran). ``device``: the device whose current stream runs the stage's work
    (a CPU device's marks read the host clock); None times the host alone."""
    if _THREAD.capture is None and not (_RECORDING or _profiler_enabled()):
        return _CLOSED
    return _Span(name, rows, device)


class _Span:
    __slots__ = ("name", "rows", "device", "on", "slot", "table", "parent", "range", "t0")

    def __init__(self, name, rows, device):
        self.name, self.rows, self.device = name, rows, device

    def __enter__(self):
        self.on = torch.is_inference_mode_enabled()
        if not self.on:
            return self
        th = _THREAD
        self.slot = _slot(self.name)
        self.parent = th.stack[-1] if th.stack else None
        if th.capture is not None:  # the marks go into the graph; the replays count the span
            self.table = _table(self.device, create=False)
            th.capture.append((self.name, self.rows, self.parent))
            self.range = None
        else:
            self.range = record_function(self.name)
            self.range.__enter__()
            self.table = _table(self.device)
            if self.table is not None:
                arm(self.device, True)
            self.t0 = time.perf_counter_ns()
        _mark(self.table, self.slot, 0)
        th.stack.append(self.name)
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        _THREAD.stack.pop()
        _mark(self.table, self.slot, 1)
        if self.range is not None:
            _add(self.name, self.rows, self.parent, time.perf_counter_ns() - self.t0)
            self.range.__exit__(*exc)
        return False


def _slot(name: str) -> int:
    s = _SLOTS.get(name)
    if s is None:
        if len(_SLOTS) >= MAX_SPANS:
            raise RuntimeError(f"more than {MAX_SPANS} span names: {sorted(_SLOTS)} and {name!r}")
        s = _SLOTS[name] = len(_SLOTS)
    return s


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _table(device, create: bool = True):
    """The device's table of marks (None for ``device`` None), made when
    missing; inside a capture a card's table must exist already (``prepare``)."""
    if device is None:
        return None
    d = _device(device)
    t = _TABLES.get(d)
    if t is None:
        if d.type == "cuda" and not create:
            raise RuntimeError(f"the span table of {d} is made before a capture (profiling.prepare)")
        with torch.inference_mode(False):  # a normal tensor: written in and out of inference mode
            t = _TABLES[d] = torch.zeros(1 + MAX_SPANS, 2, dtype=torch.int64, device=d)
        _FLAGS[d] = False
    return t


def prepare(device) -> None:
    """Make ``device``'s table of marks now, before a capture records marks that write it."""
    _table(device)


def arm(device, on: bool) -> None:
    """Raise or lower the flag that ``device``'s marks read; written only when it changes."""
    if device is None:
        return
    d = _device(device)
    t = _TABLES.get(d)
    if t is not None and _FLAGS[d] != on:
        t[0, 0].fill_(int(on))
        _FLAGS[d] = on


def _mark(table, slot: int, end: int) -> None:
    """A begin (``end`` 0) or end mark of row ``1 + slot``: the kernel on a
    card's current stream, the same arithmetic on the host clock on the CPU."""
    global _mark_fn
    if table is None:
        return
    if table.is_cuda:
        if _mark_fn is None:
            _mark_fn = _lib.fn("usm_span_mark", [_lib.P, _lib.I, _lib.I, _lib.P])
        _lib.check(_mark_fn(table.data_ptr(), slot, end, _lib.stream_ptr(table)), "span mark")
        return
    a = table.numpy()
    if a[0, 0]:
        now = time.perf_counter_ns()
        row = a[1 + slot]
        if end:
            row[1] += now - row[0]
        else:
            row[0] = now


def _add(name: str, rows: int, parent, host_ns: int = 0) -> None:
    rec = _TOTALS.get(name)
    if rec is None:
        rec = _TOTALS[name] = {"count": 0, "rows": 0, "host_ns": 0, "parents": {}}
    rec["count"] += 1
    rec["rows"] += rows
    rec["host_ns"] += host_ns
    rec["parents"][parent] = rec["parents"].get(parent, 0) + 1


@contextlib.contextmanager
def capturing() -> Iterator[list]:
    """Around a graph's capture: the spans its body opens capture their marks
    and are listed, as (name, rows, the span around it in the body or None),
    in the yielded list; they add nothing to the totals."""
    th = _THREAD
    outer, th.stack, th.capture = th.stack, [], []
    try:
        yield th.capture
    finally:
        th.stack, th.capture = outer, None


def replayed(spans) -> None:
    """Count one replay of a graph whose capture opened ``spans`` (``capturing``):
    a span that had none around it in the body counts under the span open now."""
    outer = _THREAD.stack[-1] if _THREAD.stack else None
    for name, rows, parent in spans:
        _add(name, rows, outer if parent is None else parent)


def span_totals() -> dict:
    """{name: {count, rows, host_ms, device_ms, parents: {parent name or None: count}}}
    of every span recorded since ``reset_spans``. ``host_ms`` is eager spans'
    host time; ``device_ms`` the marks' time, replays' included."""
    ns = [0] * MAX_SPANS
    for t in _TABLES.values():
        for i, v in enumerate(t[1:, 1].tolist()):
            ns[i] += v
    return {name: {"count": r["count"], "rows": r["rows"], "host_ms": r["host_ns"] / 1e6,
                   "device_ms": ns[_SLOTS[name]] / 1e6, "parents": dict(r["parents"])}
            for name, r in _TOTALS.items()}


def reset_spans() -> None:
    """Every span's totals back to nothing (the names keep their rows)."""
    _TOTALS.clear()
    for t in _TABLES.values():
        t[1:].zero_()
