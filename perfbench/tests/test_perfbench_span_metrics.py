"""The readers of the program's spans (``perfbench/work/spans.py``): None
without a trace, without the span, or from a program without spans; a
canned registry's device ms over its own counts."""

import pytest

from perfbench import harness

CANNED = {
    "sam2.encoder": {"count": 64, "rows": 2048, "host_ms": 0.0, "device_ms": 1843.2, "parents": {}},
    "sam2.memory_attention": {"count": 62, "rows": 1984, "host_ms": 0.0, "device_ms": 396.8, "parents": {}},
    "sam2.heads": {"count": 64, "rows": 2048, "host_ms": 0.0, "device_ms": 204.8, "parents": {}},
    "sam2.memory_encoder": {"count": 64, "rows": 2048, "host_ms": 0.0, "device_ms": 102.4, "parents": {}},
    "serve.prepare": {"count": 2, "rows": 2048, "host_ms": 3.0, "device_ms": 40.96, "parents": {None: 2}},
    "serve.fill_holes": {"count": 2, "rows": 2048, "host_ms": 9.0, "device_ms": 20.48, "parents": {None: 2}},
    "predictor.init_state": {"count": 6, "rows": 240, "host_ms": 30.0, "device_ms": 12.0, "parents": {None: 6}},
    "predictor.emit": {"count": 24, "rows": 240, "host_ms": 90.0, "device_ms": 60.0, "parents": {None: 24}},
}
WANT = {
    "encoder_ms_per_frame.serve": 0.9,
    "memory_attention_ms_per_frame.serve": 0.2,
    "heads_ms_per_frame.serve": 0.1,
    "memory_encoder_ms_per_frame.serve": 0.05,
    "prepare_ms_per_frame.serve": 0.02,
    "fill_holes_ms_per_frame.serve": 0.01,
    "init_state_ms.interactive": 2.0,
    "emit_ms.interactive": 10.0,
}


def _traced():
    return harness.Run(trace={"busy_s": 1.0, "window_s": 1.0})


def test_every_span_metric_has_its_entry():
    names = {m["name"] for m in harness.benchmark()["per_layer"] if m["source"] == "program_span"}
    assert names == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_gives_none_without_a_trace_and_the_canned_ratio_with_one(name, monkeypatch):
    from us_video_medsam2_tpu_torch.utils import profiling

    read = harness.reader(name)
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(CANNED))
    assert read(harness.Run()) is None
    assert read(_traced()) == pytest.approx(WANT[name])
    monkeypatch.setattr(profiling, "span_totals", lambda: {})  # the span never ran
    assert read(_traced()) is None
    monkeypatch.delattr(profiling, "span_totals")  # a program without spans
    assert read(_traced()) is None
