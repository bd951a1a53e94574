"""The program's spans (``utils/profiling.py``) on the CPU.

- With the gate closed (no profiler, no ``recording()``) a batched serve and
  an interactive predictor run at MINI open no ``record_function`` range,
  launch no mark and record nothing.
- With it open (a torch profiler or ``recording()``) every span of serving
  (N 2, T 4) and of the predictor (4 frames) is counted with its rows and
  under its parent, with host and (host-clock) mark times, and lies in the
  profiler's events.
- A ``FrameGraph`` captured with a fake graph lists the spans its body
  opened and adds them at each replay only while the gate is open, a
  body's outer span under the span open around the replay.
- The training and eval steps, eager and captured, record no span.
- The marks' arithmetic on the host clock, with the flag down a mark adds
  nothing, and ``reset_spans`` leaves ``span_totals`` empty.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from tests.test_parity import MINI
from tests.test_torch_propagation_graph import _FakeCapture, _FakeGraph
from tests.test_torch_training import LOSS, _video
from tests.test_train_step import TINY
from tests.torch_port_helpers import mini_port_predictor, port_config, t
from us_video_medsam2_tpu_torch.core.build import build_sam2
from us_video_medsam2_tpu_torch.inference.serve import batched_propagate
from us_video_medsam2_tpu_torch.training import train_model as ptm
from us_video_medsam2_tpu_torch.training import train_step as pts
from us_video_medsam2_tpu_torch.training.losses import LossConfig
from us_video_medsam2_tpu_torch.training.optimizer import OptimConfig
from us_video_medsam2_tpu_torch.utils import graphs, profiling

SIZE = MINI.image_size
N, T = 2, 4


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _videos(n, t):
    rng = np.random.default_rng(0)
    vids = rng.standard_normal((n, t, SIZE, SIZE, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    vids[:, :, ((yy - 100) ** 2 + (xx - 120) ** 2) < 40**2] += 3.0
    return vids


def _serve(pred):
    return batched_propagate(pred, _videos(N, T), np.array([[[120.0, 100.0]], [[116.0, 105.0]]], np.float32),
                             np.ones((N, 1), np.int32))


def _predict(pred):
    state = pred.init_state(_videos(1, T)[0], SIZE, SIZE)
    pred.add_new_points_or_box(state, 0, 1, points=np.array([[120.0, 100.0]]), labels=np.array([1]))
    return [m for _, _, m in pred.propagate_in_video(state)]


RUNS = {"serve": _serve, "predictor": _predict}

# name: (count, rows, parents) of one run
SERVE = {
    "serve.prepare": (1, N * T, {None: 1}),
    "serve.prompt": (1, N, {None: 1}),
    "serve.replays": (1, N * (T - 1), {None: 1}),
    "serve.fill_holes": (1, N * T, {None: 1}),
    "sam2.encoder": (T, N * T, {"serve.prompt": 1, "serve.replays": T - 1}),
    "sam2.memory_attention": (T - 1, N * (T - 1), {"serve.replays": T - 1}),
    "sam2.heads": (T, N * T, {"serve.prompt": 1, "serve.replays": T - 1}),
    "sam2.memory_encoder": (T, N * T, {"serve.prompt": 1, "serve.replays": T - 1}),
}
PREDICTOR = {
    "predictor.init_state": (1, T, {None: 1}),
    "predictor.prompt": (1, 1, {None: 1}),
    "predictor.preflight": (1, 1, {None: 1}),
    "predictor.replays": (1, T - 1, {None: 1}),
    "predictor.emit": (2, T, {None: 2}),  # the prompted frame's, then the tracked frames' chunk
    "sam2.encoder": (T, T, {"predictor.prompt": 1, "predictor.replays": T - 1}),
    "sam2.memory_attention": (T - 1, T - 1, {"predictor.replays": T - 1}),
    "sam2.heads": (T, T, {"predictor.prompt": 1, "predictor.replays": T - 1}),
    "sam2.memory_encoder": (T, T, {"predictor.preflight": 1, "predictor.replays": T - 1}),
}
WANT = {"serve": SERVE, "predictor": PREDICTOR}


@pytest.mark.parametrize("path", sorted(RUNS))
def test_a_closed_gate_opens_no_range_and_records_nothing(path, monkeypatch):
    opened, marks = [], []
    mark = profiling._mark
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name) or contextlib.nullcontext())
    monkeypatch.setattr(profiling, "_mark", lambda *a: marks.append(a) or mark(*a))
    RUNS[path](mini_port_predictor(fill_hole_area=8))
    assert not profiling.gate_open()
    assert opened == [] and marks == [] and profiling.span_totals() == {}


@pytest.mark.parametrize("gate", ["profiler", "recording"])
@pytest.mark.parametrize("path", sorted(RUNS))
def test_an_open_gate_records_every_span_with_its_parent_count_and_rows(path, gate):
    pred = mini_port_predictor(fill_hole_area=8)
    opener = torch.profiler.profile() if gate == "profiler" else profiling.recording()
    with opener as prof:
        RUNS[path](pred)
    got = profiling.span_totals()
    want = WANT[path]
    assert sorted(got) == sorted(want)
    for name, (count, rows, parents) in want.items():
        g = got[name]
        assert (g["count"], g["rows"], g["parents"]) == (count, rows, parents), name
        # the marks read the host clock on the CPU, inside the span's own host time
        assert 0 < g["device_ms"] <= g["host_ms"], (name, g)
    outer = got["serve.replays" if path == "serve" else "predictor.replays"]
    assert got["sam2.memory_attention"]["device_ms"] < outer["device_ms"]  # only inside the replays
    if gate == "profiler":  # a range of each span's name on the profiler's clock
        assert set(want) <= {e.key for e in prof.key_averages()}


def _spanned_body():
    with profiling.span("body.outer", 3, "cpu"):
        with profiling.span("body.inner", 2, "cpu"):
            pass


@pytest.mark.parametrize("replays", [1, 4])
def test_replays_add_the_captured_spans_only_while_the_gate_is_open(replays):
    g = graphs.FrameGraph(bufs=None)
    with torch.inference_mode():
        g.capture(_spanned_body, new_graph=_FakeGraph, graph_context=_FakeCapture)
    assert g.spans == [("body.outer", 3, None), ("body.inner", 2, "body.outer")]
    assert profiling.span_totals() == {}  # a capture records the spans, it counts nothing
    with torch.inference_mode():
        for _ in range(replays):
            g.replay()
        assert profiling.span_totals() == {}
        with profiling.recording():
            for _ in range(replays):
                g.replay()
            with profiling.span("around", 0):
                g.replay()
    assert g.graph.replays == 2 * replays + 1
    got = profiling.span_totals()
    assert (got["body.outer"]["count"], got["body.outer"]["rows"]) == (replays + 1, 3 * (replays + 1))
    assert got["body.outer"]["parents"] == {None: replays, "around": 1}
    assert (got["body.inner"]["count"], got["body.inner"]["rows"]) == (replays + 1, 2 * (replays + 1))
    assert got["body.inner"]["parents"] == {"body.outer": replays + 1}
    assert got["body.outer"]["host_ms"] == 0.0  # a replay has no host time of its own


def _fake_captures(monkeypatch):
    def capture(self, body, generators=()):
        self.capture(body, new_graph=_FakeGraph, graph_context=_FakeCapture, generators=())
        return self.outputs

    monkeypatch.setattr(graphs.FrameGraph, "warm_up_and_capture", capture)


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_training_and_eval_steps_record_no_span(kind, monkeypatch):
    _fake_captures(monkeypatch)
    model = build_sam2(port_config(TINY), seed=0).set_compute_dtype(torch.float32, cast_weights=False)
    tcfg = pts.TrainConfig(sim=ptm.TrainSimConfig(num_correction_pt_per_frame=1), loss=LossConfig(**LOSS),
                           optim=OptimConfig(total_steps=10))
    images, masks = _video()
    batch = pts.TrainBatch(t(images), t(masks), torch.ones(1, 2, dtype=torch.bool))
    with profiling.recording():
        if kind == "train":
            state = pts.create_train_state(model, tcfg, device="cpu", dtype=torch.float32)
            step = pts.make_train_step(tcfg)
            eager = step(state, batch, 3)
            body = lambda b, gen: step.body(state, b, gen)  # noqa: E731
        else:
            step = pts.make_eval_step(tcfg)
            eager = step(model, batch, 3)
            body = lambda b, gen: step.body(model, b, gen)  # noqa: E731
        cap = step.captured
        for seed in (4, 5):  # captured, then replayed
            cap.run(cap.key(model, batch), batch, seed, list(model.parameters()), [], body, model)
    assert np.isfinite(float(eager["core_loss"])) and cap.captures == 1 and cap.last.graph.replays == 1
    assert cap.last.spans == [] and profiling.span_totals() == {}


def test_marks_time_the_stage_on_the_host_clock_and_stop_with_the_flag():
    with torch.inference_mode(), profiling.recording():
        with profiling.span("stage", 1, "cpu"):
            time.sleep(0.02)
    got = profiling.span_totals()["stage"]
    assert 20.0 <= got["device_ms"] <= got["host_ms"] < 2000.0
    profiling.arm("cpu", False)  # as a replay made with the gate closed leaves it
    table, slot = profiling._table("cpu"), profiling._slot("stage")
    profiling._mark(table, slot, 0)
    time.sleep(0.005)
    profiling._mark(table, slot, 1)
    assert profiling.span_totals()["stage"]["device_ms"] == got["device_ms"]


def test_a_span_without_inference_mode_records_nothing():
    with profiling.recording(), profiling.span("stage", 1, "cpu"):
        pass
    with profiling.recording(), torch.no_grad(), profiling.span("stage", 1, "cpu"):
        pass
    assert profiling.span_totals() == {}


def test_reset_spans_leaves_the_totals_empty():
    with torch.inference_mode(), profiling.recording(), profiling.span("stage", 2, "cpu"):
        time.sleep(0.001)
    assert profiling.span_totals()["stage"]["rows"] == 2
    profiling.reset_spans()
    assert profiling.span_totals() == {}
    assert not profiling._TABLES[torch.device("cpu")][1:].any()
