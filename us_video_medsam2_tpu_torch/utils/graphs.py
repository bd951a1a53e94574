"""One CUDA graph of a body, with the kernels' launch counts it captured.

The predictor's frame body (``inference/graphs.py``) and the training and
eval steps (``training/train_step.py``) are each captured with a
``FrameGraph``. Before capturing it runs the body once eagerly on a side
stream (as ``torch.cuda.graphs`` asks): capture executes nothing, so every
table that comes into being at first use (the position tables of
``ops/posenc.py``, the ViTDet pos-embed table, cuBLAS and cuDNN state) must
exist before it. What the body returns is kept (``outputs``: the graph's
memory, rewritten at each replay), and the generators the caller names are
registered with the capture, so each replay draws from their state at that
time. A graph runs on the device of the weights it reads.

The kernels' launch counters are Python-side: they tick once at capture and
never at replay. A graph records the counts its capture ticked, takes them
back off, and adds them on every replay, so a counter keeps meaning
launches that the device ran. The program's spans (``utils/profiling.py``)
follow the same pattern: a capture records the spans its body opened, with
their marks inside the graph, and each replay made while spans record adds
their counts (the replay first writes the marks' flag from the gate). A
failed capture or replay raises; nothing falls back to the eager body on the
card.

A graph reads the weights by address. It keeps each weight tensor it read
alive, so no other tensor takes that memory while it lives, with the
tensor's version then (``reads``). Graphs given one ``pool`` (a
``torch.cuda.graph_pool_handle()``) share its memory: they must never run
at once, and the outputs of one are valid only until the next replay of
any of them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from us_video_medsam2_tpu_torch.kernels import _lib
from us_video_medsam2_tpu_torch.utils import profiling

# graphs a predictor or a step keeps: forward and reverse of one shape, or
# its two kernel configurations; past that the least recently used is dropped
MAX_GRAPHS = 2


def read_counts() -> Dict[Callable, int]:
    return {w: w.launches for w in _lib.COUNTED.values()}


def _version(w: torch.Tensor) -> Optional[int]:
    return None if w.is_inference() else w._version  # inference tensors keep no version


class FrameGraph:
    """One captured body over its buffers ``bufs``, with the launches it
    captured (by wrapper), the spans it captured, the seconds its warm-up
    and capture took (and the capture's parts) and the bytes its capture
    added to the pool."""

    def __init__(self, bufs, weights: Sequence[torch.Tensor] = (), pool=None):
        self.bufs = bufs
        self.pool = pool
        # the weights its capture reads, held so that their memory stays
        # theirs, with their versions then
        self.weights = [(w.detach(), _version(w)) for w in weights]
        self.device = self.weights[0][0].device if self.weights else None
        self.graph = None
        self.outputs = None  # what the captured body returned
        self.counts: Dict[Callable, int] = {}
        self.spans: list = []  # (name, rows, parent in the body) of each span the capture opened
        self.capture_s = 0.0  # the eager run and the capture
        self.warm_up_s = 0.0  # of which the eager run
        # of which the capture's set-up (synchronize, gc, empty cache), the
        # body recorded, and the capture's end (the graph instantiated)
        self.parts_s = {"set_up": 0.0, "record": 0.0, "instantiate": 0.0}
        self.pool_bytes = 0

    def warm_up_and_capture(self, body: Callable[[], object], generators: Sequence[torch.Generator] = ()):
        """Run ``body`` once eagerly on a side stream, then capture it;
        returns what the eager run returned."""
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            result = body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warm_up_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.capture(body, generators=generators)
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0
        return result

    def capture(self, body: Callable[[], object], new_graph=torch.cuda.CUDAGraph,
                graph_context=torch.cuda.graph, generators: Sequence[torch.Generator] = ()) -> None:
        """Capture ``body`` (warmed up already) into ``pool`` (a private
        pool when None), keeping what it returns as ``outputs``, with
        ``generators`` registered (beside the device's default one, which a
        capture always registers); the counters it ticked are recorded and
        taken back off, and the spans it opened listed."""
        before = read_counts()
        graph = new_graph()
        for g in generators:
            graph.register_generator_state(g)
        if self.device is not None and torch.is_inference_mode_enabled():
            profiling.prepare(self.device)  # the table the captured marks write
        t0 = time.perf_counter()
        try:
            with profiling.capturing() as spans, (
                    graph_context(graph) if self.pool is None else graph_context(graph, pool=self.pool)):
                t1 = time.perf_counter()
                self.outputs = body()
                t2 = time.perf_counter()
        finally:
            after = read_counts()
            for w, n in before.items():
                w.launches = n
        self.parts_s = {"set_up": t1 - t0, "record": t2 - t1, "instantiate": time.perf_counter() - t2}
        self.counts = {w: after[w] - n for w, n in before.items() if after[w] != n}
        self.spans = spans
        self.graph = graph

    def reads(self, weights: Sequence[torch.Tensor], versions: bool = True) -> bool:
        """Whether ``weights`` are still the tensors this graph read, unchanged
        (with ``versions`` False: the same memory, whatever was written there)."""
        return len(weights) == len(self.weights) and all(
            w.device == held.device and w.data_ptr() == held.data_ptr() and (not versions or _version(w) == v)
            for w, (held, v) in zip(weights, self.weights))

    def replay(self) -> None:
        on = self.spans and profiling.gate_open()
        if self.spans:
            profiling.arm(self.device, on)
        self.graph.replay()
        for w, n in self.counts.items():
            w.launches += n
        if on:
            profiling.replayed(self.spans)
