"""The spans' marks on the card (``csrc/span_mark.cu``, ``utils/profiling.py``).

Marked ``card``: each skips without a CUDA card. On one (this directory's
``conftest.py`` imports JAX, which the card's machine need not have):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_span_marks_card.py -q -s

- ``%globaltimer`` steps by a microsecond or less;
- the four model spans of a replay of t512's serving body (``sam2.encoder``,
  ``sam2.memory_attention``, ``sam2.heads``, ``sam2.memory_encoder``) sum to
  within 3% of the replay's time between CUDA events around it, at B 1 and
  B 32;
- with the flag down (no profiler, no ``recording()``), replays of the body
  with its eight marks take within 1% of replays of the same body captured
  without them, timed in turns.
"""

import statistics

import numpy as np
import pytest
import torch

from us_video_medsam2_tpu_torch.utils import profiling

MODEL = ("sam2.encoder", "sam2.memory_attention", "sam2.heads", "sam2.memory_encoder")
FRAMES = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the marks run on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def t512(card):
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    return build_sam2_video_predictor("sam2.1_hiera_t512", device=card)


def _events_ms(fn, times: int = 1) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(times):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / times


def _serving_graph(pred, n: int):
    """The captured serving body at N ``n`` (one batch served first), its buffers holding that batch's last frame."""
    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate, serve_graph_key, serve_graphs

    size = pred.cfg.image_size
    videos = np.random.default_rng(n).integers(0, 256, (n, FRAMES, size, size, 3), dtype=np.uint8)
    clicks = np.full((n, 1, 2), size / 2, np.float32)
    batched_propagate(pred, videos, clicks, np.ones((n, 1), np.int32))
    torch.cuda.synchronize()
    return serve_graphs(pred).entries[serve_graph_key(pred, n, FRAMES)]


def _without_marks(pred, g):
    """The same body over a copy of ``g``'s buffers, captured outside inference
    mode (under ``no_grad``: the same kernels), where spans capture no mark."""
    from us_video_medsam2_tpu_torch.inference.graphs import FrameGraph, copy_bank, frame_body, make_buffers
    from us_video_medsam2_tpu_torch.inference.graphs import weight_tensors
    from us_video_medsam2_tpu_torch.inference.serve import MAX_COND_SLOTS

    with torch.no_grad():
        bufs = make_buffers(pred.model, g.bufs.bank, False, new_bank=True, per_row_frames=True)
        copy_bank(bufs.bank, g.bufs.bank)
        for dst, src in ((bufs.frame, g.bufs.frame), (bufs.t, g.bufs.t), (bufs.num_frames, g.bufs.num_frames)):
            dst.copy_(src)
        bare = FrameGraph(bufs, weight_tensors(pred.model))
        bare.warm_up_and_capture(lambda: frame_body(pred.model, bufs, bufs.num_frames, False, MAX_COND_SLOTS))
    torch.cuda.synchronize()
    return bare


@pytest.mark.card
def test_globaltimer_steps_by_a_microsecond_or_less(card):
    from us_video_medsam2_tpu_torch.kernels import _lib

    out = torch.zeros(512, dtype=torch.int64, device=card)
    fn = _lib.fn("usm_globaltimer_steps", [_lib.P, _lib.I, _lib.P])
    _lib.check(fn(out.data_ptr(), out.numel(), _lib.stream_ptr(out)), "globaltimer steps")
    steps = out.tolist()
    print(f"\n%globaltimer steps (ns): median {statistics.median(steps)}, min {min(steps)}, max {max(steps)}; "
          f"{torch.cuda.get_device_name(card)}")
    assert min(steps) > 0 and statistics.median(steps) <= 1000


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 32])
def test_the_model_spans_of_a_replay_sum_to_the_replay(t512, n):
    g = _serving_graph(t512, n)
    assert [s[0] for s in g.spans] == list(MODEL)
    replays = 10
    with profiling.recording():
        g.replay()  # raises the flag
        torch.cuda.synchronize()
        profiling.reset_spans()
        events = sum(_events_ms(g.replay) for _ in range(replays))
        got = profiling.span_totals()
    spans = sum(got[m]["device_ms"] for m in MODEL)
    print(f"\nB {n}: {replays} replays {events:.3f} ms by CUDA events, the four model spans {spans:.3f} ms "
          f"({100 * spans / events:.2f}%): " + ", ".join(f"{m} {got[m]['device_ms'] / replays:.4f}" for m in MODEL)
          + " ms a replay")
    assert all(got[m]["count"] == replays and got[m]["rows"] == replays * n for m in MODEL)
    assert abs(spans - events) <= 0.03 * events


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 32])
def test_marks_with_the_flag_down_cost_under_a_percent(t512, n):
    g = _serving_graph(t512, n)
    bare = _without_marks(t512, g)
    assert len(g.spans) == 4 and bare.spans == []
    assert not profiling.gate_open()
    times = 20 if n == 1 else 3
    turns = {"marks": [], "bare": []}
    for graph in (g, bare):
        graph.replay()  # g lowers the flag
    for _ in range(6):
        for name, graph in (("marks", g), ("bare", bare), ("bare", bare), ("marks", g)):
            turns[name].append(_events_ms(graph.replay, times))
    marks, plain = statistics.median(turns["marks"]), statistics.median(turns["bare"])
    print(f"\nB {n}, flag down: {marks:.4f} ms a replay with the marks, {plain:.4f} without "
          f"({100 * (marks / plain - 1):+.3f}%); turns {turns}")
    assert marks <= 1.01 * plain
