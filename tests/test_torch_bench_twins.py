"""PyTorch port: the twins of tools/bench_serve.py and tools/bench_longvideo.py
on the CPU at the smallest size they take (``tiny64_test``, a few frames;
the numbers mean nothing here, the card's run is chip_smoke.py phase 13).

Each twin takes its JAX tool's flags (read from the JAX tool's source, which
is not imported: it configures JAX on import) and ``--device``; its JSON
lines parse and carry their keys (the launch counts among them, all 0 on
the CPU, where the plain versions run); the serving twin's ``--trace``
refuses a trace without a device track.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

import pytest

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
SERVE_KEYS = {"metric", "value", "unit", "videos", "frames_per_video", "wall_ms_per_call", "device", "launches"}
VIDEO_KEYS = {"frames", "bank_bucket", "host_store_mb", "init_s", "propagate_s", "fps", "captures",
              "peak_device_mb", "device", "launches"}
SUMMARY_KEYS = {"metric", "value", "unit", "captures_by_bucket", "peak_device_mb", "chunk", "device"}


def load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flags(tool, capsys) -> set:
    with pytest.raises(SystemExit):
        tool.main(["--help"])
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out)) - {"--help"}


def jax_flags(name) -> set:
    with open(os.path.join(TOOLS, f"{name}.py")) as f:
        return set(re.findall(r'add_argument\(\s*"(--[a-z][a-z-]*)"', f.read()))


def json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("name", ["bench_serve", "bench_longvideo"])
def test_twin_takes_the_jax_flags_and_device(name, capsys):
    want, got = jax_flags(name), flags(load(f"torch_{name}"), capsys)
    assert want and got == want | {"--device"}, (sorted(got), sorted(want))


def test_serve_twin_json_line(capsys):
    tool = load("torch_bench_serve")
    rec = tool.main(["--cfg", "tiny64_test", "--videos", "2", "--frames", "2", "--runs", "2", "--json",
                     "--device", "cpu"])
    lines = json_lines(capsys.readouterr().out)
    assert lines == [rec] and set(rec) == SERVE_KEYS
    assert rec["metric"] == "serve_aggregate_fps_tiny64_test" and rec["device"] == "cpu"
    assert (rec["videos"], rec["frames_per_video"]) == (2, 2) and rec["value"] > 0 and rec["wall_ms_per_call"] > 0
    # the plain versions on the CPU launch no kernel; every wrapper the path imports is listed
    assert {"window_attention", "layer_norm", "ln_mlp_residual", "flash_attention"} <= set(rec["launches"])
    assert not any(rec["launches"].values())


def test_serve_twin_trace_needs_a_device_track(tmp_path):
    tool = load("torch_bench_serve")
    with pytest.raises(Exception, match="device"):
        tool.main(["--cfg", "tiny64_test", "--videos", "1", "--frames", "2", "--runs", "1", "--device", "cpu",
                   "--trace", str(tmp_path)])


def test_longvideo_twin_json_lines(capsys, monkeypatch):
    from us_video_medsam2_tpu_torch.inference.video_predictor import build_sam2_video_predictor

    tool = load("torch_bench_longvideo")
    monkeypatch.setattr(tool, "make_predictor",
                        lambda device: build_sam2_video_predictor("tiny64_test", device=device, fill_hole_area=8))
    summary = tool.main(["--lengths", "3,17", "--chunk", "4", "--io-chunk", "2", "--device", "cpu"])
    lines = json_lines(capsys.readouterr().out)
    assert len(lines) == 3 and lines[-1] == summary
    for rec, (frames, bucket) in zip(lines, ((3, 16), (17, 32))):
        assert set(rec) == VIDEO_KEYS and (rec["frames"], rec["bank_bucket"]) == (frames, bucket)
        assert rec["host_store_mb"] == round(frames * 64 * 64 * 3 / 1e6, 1) and rec["captures"] == 0
        assert "flash_attention" in rec["launches"] and not any(rec["launches"].values())
    assert set(summary) == SUMMARY_KEYS and summary["captures_by_bucket"] == {"16": 0, "32": 0}
    assert summary["unit"].endswith("3/17 frames") and summary["chunk"] == 4
