"""Profiling hooks: a torch.profiler trace, a step timer, device memory.

Counterpart of the JAX package's ``utils/profiling.py``. ``trace`` writes the
Chrome trace that ``utils/traceparse.py`` reads (CPU ranges and, with a
card, its kernels, copies and fills); ``step_timer`` synchronizes the device
of the tensors it is given before it stops the clock, since a CUDA launch
returns before the card has run it.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import time
from typing import Iterator

import torch
from torch.utils._pytree import tree_leaves

from us_video_medsam2_tpu_torch.utils.traceparse import MODULE_PREFIX, WARMUP_RANGE


@contextlib.contextmanager
def _module_ranges(root: torch.nn.Module) -> Iterator[None]:
    """A ``record_function`` range ``nn.Module: <path>`` around every forward
    call of ``root``'s modules (global forward hooks, removed on exit)."""
    from torch.autograd.profiler import record_function
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
    from torch.autograd.profiler import record_function

    with record_function(WARMUP_RANGE):
        for _ in range(WARMUP_LAUNCHES):
            torch.cuda._sleep(0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def step_timer(name: str = "step", sync=None):
    """Wall-clock a block into the yielded dict (``seconds``, ``name``); before
    stopping, synchronize the card of every CUDA tensor in ``sync`` (a tensor
    or a nest of lists, tuples and dicts of them)."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        devices = {t.device for t in tree_leaves(sync) if isinstance(t, torch.Tensor) and t.is_cuda}
        for d in devices:
            torch.cuda.synchronize(d)
        box["seconds"] = time.perf_counter() - t0
        box["name"] = name


def device_memory_summary() -> dict:
    """Current and peak allocated bytes of card 0 and its size; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(0)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(0).total_memory,
    }


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (the first card), to stand beside every
    time measured on it: a card set below its maximum power runs slower."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]
