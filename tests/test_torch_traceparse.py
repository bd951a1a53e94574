"""PyTorch port, the measurement layer's trace half: ``utils/traceparse.py``
and ``utils/profiling.py`` on the CPU (no JAX: the JAX package's parser
reads xprof traces, which the port does not write).

- A hand-written Chrome trace in torch.profiler's format: kernels on two
  streams, a device copy and fill, nested module and ``record_function``
  ranges, operators, runtime calls tied to their device events by
  correlation id, a CUDA-graph replay whose kernels share one
  ``cudaGraphLaunch``, and the warm-up launches ``profiling.trace`` begins
  with (left out, one of them without its device event): exact tallies by
  kernel, by module and by category;
- a trace without a device track raises (it measured nothing on the card),
  and so does one in which a kernel or graph launch outside the warm-up has
  no device event (``IncompleteTrace``: its sums would under-count);
- ``profiling.trace`` on the CPU writes a trace that ``parse_trace`` finds
  (and then refuses: no device track), with a range per module call;
- ``peak_bf16_flops``. The spans of ``utils/profiling.py`` are held in
  ``tests/test_torch_spans.py``.
"""

from __future__ import annotations

import gzip
import json
import os
import time

import pytest
import torch

from us_video_medsam2_tpu_torch.utils import profiling, traceparse


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _trace_events():
    """A step of a model with module ranges on host thread 1, a backward
    call on host thread 2, and the device (pid 0) with streams 7 and 13."""
    host = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
        _x("user_annotation", traceparse.WARMUP_RANGE, -50.0, 20.0),  # profiling.trace's first launches
        _x("cuda_runtime", "cudaLaunchKernel", -45.0, 3.0, correlation=90),
        _x("cuda_runtime", "cudaLaunchKernel", -40.0, 3.0, correlation=91),
        _x("user_annotation", "nn.Module: image_encoder", 0.0, 100.0),
        _x("user_annotation", "nn.Module: image_encoder.trunk.blocks_0.attn.qkv", 10.0, 30.0),
        _x("cpu_op", "aten::linear", 12.0, 20.0),
        _x("cpu_op", "aten::addmm", 14.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 16.0, 4.0, correlation=101),
        _x("user_annotation", "my_range", 50.0, 20.0),
        _x("cuda_runtime", "cudaMemcpyAsync", 52.0, 3.0, correlation=102),
        _x("cpu_op", "aten::add", 120.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 122.0, 2.0, correlation=104),
        _x("cuda_runtime", "cudaMemsetAsync", 140.0, 2.0, correlation=105),
        _x("cuda_runtime", "cudaGraphLaunch", 200.0, 5.0, correlation=106),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 300.0, 40.0, tid=2),
        _x("cpu_op", "aten::mm", 305.0, 20.0, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 310.0, 4.0, tid=2, correlation=107),
        {"ph": "s", "id": 101, "pid": 1, "tid": 1, "ts": 16.0, "cat": "ac2g", "name": "ac2g"},
        _x("Trace", "PyTorch Profiler (0)", 0.0, 400.0, pid="Spans", tid="PyTorch Profiler"),
    ]
    dev = [
        _x("kernel", "at::cuda::spin_kernel(long)", -39.0, 1.0, pid=0, tid=7, correlation=91),  # left out
        _x("kernel", "gemm_kernel", 20.0, 6.5, pid=0, tid=7, correlation=101),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 56.0, 1.25, pid=0, tid=7, correlation=102),
        _x("kernel", "add_kernel", 125.0, 2.0, pid=0, tid=13, correlation=104),
        _x("gpu_memset", "Memset (Device)", 143.0, 0.5, pid=0, tid=7, correlation=105),
        _x("kernel", "window_attention_kernel", 206.0, 10.0, pid=0, tid=7, correlation=106),
        _x("kernel", "gemm_kernel", 217.0, 5.0, pid=0, tid=7, correlation=106),
        _x("kernel", "add_kernel", 223.0, 1.0, pid=0, tid=7, correlation=106),
        _x("kernel", "gemm_kernel", 320.0, 3.0, pid=0, tid=7, correlation=107),
        _x("gpu_user_annotation", "my_range", 56.0, 1.25, pid=0, tid=7),  # a range on the device track: not busy
    ]
    return host + dev


def _write(tmp_path, events, name="host_1.1.pt.trace.json", gz=False):
    path = tmp_path / (name + (".gz" if gz else ""))
    data = json.dumps({"schemaVersion": 1, "traceEvents": events})
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    return path


@pytest.mark.parametrize("gz", [False, True])
def test_hand_written_trace_gives_exact_tallies(tmp_path, gz):
    _write(tmp_path, _trace_events(), gz=gz)
    self_op, self_mod, self_cat, args_of = traceparse.parse_trace(str(tmp_path))
    assert dict(self_op) == {"gemm_kernel": 6.5 + 5.0 + 3.0, "Memcpy HtoD (Pinned -> Device)": 1.25,
                             "add_kernel": 2.0 + 1.0, "Memset (Device)": 0.5, "window_attention_kernel": 10.0}
    assert dict(self_mod) == {
        "image_encoder.trunk.blocks_0.attn": 6.5,  # the innermost module range, cut to four path parts
        "my_range": 1.25,  # a record_function range
        "aten::add": 2.0,  # outside any range: the outermost operator
        "cudaMemsetAsync": 0.5,  # outside ranges and operators: the runtime call
        "graph replay": 10.0 + 5.0 + 1.0,  # one cudaGraphLaunch, three kernels
        "autograd::engine::evaluate_function: MmBackward0": 3.0,  # the backward thread
    }
    assert dict(self_cat) == {"kernel": 6.5 + 2.0 + 16.0 + 3.0, "gpu_memcpy": 1.25, "gpu_memset": 0.5}
    assert args_of["gemm_kernel"]["correlation"] == 101
    assert traceparse.device_self_time_ms(str(tmp_path)) == pytest.approx(29.25e-3, abs=1e-12)
    events = traceparse.load_events(str(tmp_path))
    assert traceparse.event_counts(events) == {"gemm_kernel": 3, "add_kernel": 2, "window_attention_kernel": 1,
                                               "Memcpy HtoD (Pinned -> Device)": 1, "Memset (Device)": 1}
    assert traceparse.lost_launches(events) == []  # correlation 90 lost its kernel inside the warm-up range


@pytest.mark.parametrize("lost", [
    [_x("cuda_runtime", "cudaLaunchKernel", 60.0, 3.0, correlation=103)],  # a launch whose kernel is not there
    [_x("cuda_driver", "cuLaunchKernel", 60.0, 3.0, correlation=103),  # a driver-API launch, and a graph
     _x("cuda_runtime", "cudaGraphLaunch", 250.0, 3.0, correlation=108)],  # replay with none of its kernels
])
def test_a_trace_that_lost_a_launch_is_refused(tmp_path, lost):
    """The profiler dropped device records: the trace's sums would under-count
    the card's time, so every reader of them raises."""
    _write(tmp_path, _trace_events() + lost)
    events = traceparse.load_events(str(tmp_path))
    assert [e["args"]["correlation"] for e in traceparse.lost_launches(events)] == [
        e["args"]["correlation"] for e in lost]
    for read in (traceparse.parse_trace, traceparse.device_self_time_ms):
        with pytest.raises(traceparse.IncompleteTrace, match=f"{len(lost)} kernel or graph launches"):
            read(str(tmp_path))
    with pytest.raises(traceparse.IncompleteTrace):
        traceparse.tallies(events)


def test_a_graph_replay_inside_a_range_says_so(tmp_path):
    events = [_x("user_annotation", "propagate", 0.0, 50.0),
              _x("cuda_runtime", "cudaGraphLaunch", 10.0, 5.0, correlation=1),
              _x("kernel", "k", 20.0, 2.0, pid=0, tid=7, correlation=1),
              _x("kernel", "j", 23.0, 3.0, pid=0, tid=7, correlation=2)]  # no runtime call: unattributed
    _write(tmp_path, events)
    _, self_mod, _, _ = traceparse.parse_trace(str(tmp_path))
    assert dict(self_mod) == {"propagate (graph replay)": 2.0, "?": 3.0}


def test_the_newest_trace_is_parsed(tmp_path):
    old = _write(tmp_path, [_x("kernel", "old_kernel", 0.0, 1.0, pid=0, tid=7)], "a.pt.trace.json")
    os.utime(old, (time.time() - 100, time.time() - 100))
    (tmp_path / "sub").mkdir()
    _write(tmp_path / "sub", [_x("kernel", "new_kernel", 0.0, 2.0, pid=0, tid=7)], "b.pt.trace.json")
    (tmp_path / "summary.json").write_text("{}")  # the tool's output beside the traces is not a trace
    assert dict(traceparse.parse_trace(str(tmp_path))[0]) == {"new_kernel": 2.0}


def test_a_trace_without_a_device_track_raises(tmp_path):
    host_only = [e for e in _trace_events() if e.get("pid") != 0]
    _write(tmp_path, host_only)
    with pytest.raises(ValueError, match="no device track"):
        traceparse.parse_trace(str(tmp_path))
    with pytest.raises(ValueError, match="no device track"):
        traceparse.device_self_time_ms(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        traceparse.parse_trace(str(tmp_path / "missing"))


def test_profiling_trace_on_the_cpu_is_found_by_the_parser(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    with profiling.trace(str(tmp_path), modules=model) as prof:
        model(torch.zeros(3, 4))
    path = traceparse.newest_trace(str(tmp_path))
    assert path.endswith(".pt.trace.json") and os.path.dirname(path) == str(tmp_path)
    names = [e["name"] for e in traceparse.load_events(str(tmp_path)) if e.get("cat") == "user_annotation"]
    assert names == ["nn.Module: Sequential", "nn.Module: 0", "nn.Module: 1", "nn.Module: 2"]
    assert any(e.key == "aten::addmm" for e in prof.key_averages())
    with pytest.raises(ValueError, match="no device track"):  # the CPU ran it: nothing on a card
        traceparse.parse_trace(str(tmp_path))
    model(torch.zeros(1, 4))  # the hooks are gone with the trace
    assert len(traceparse.load_events(str(tmp_path))) > 0


def test_peak_bf16_flops():
    assert traceparse.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert traceparse.peak_bf16_flops("NVIDIA H100 PCIe") == 756e12
    assert traceparse.peak_bf16_flops("NVIDIA H100 NVL") == 835e12
    assert traceparse.peak_bf16_flops("NVIDIA A100-SXM4-80GB") is None
    assert traceparse.peak_bf16_flops("cpu") is None


def test_profile_tool_analyzes_a_trace(tmp_path, capsys):
    """``tools/torch_profile_propagation.py --analyze-only`` on the
    hand-written trace: the tables and ``summary.json`` (per tracked frame:
    the prompted frame is not tracked)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_profile_propagation.py")
    spec = importlib.util.spec_from_file_location("torch_profile_propagation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    _write(tmp_path, _trace_events())
    summary = tool.main(["--analyze-only", "--out", str(tmp_path), "--frames", "4", "--top", "3"])
    printed = capsys.readouterr().out
    assert "-- by module --" in printed and "graph replay" in printed
    assert summary["total_ms"] == pytest.approx(29.25e-3)
    assert summary["ms_per_tracked_frame"] == pytest.approx(29.25e-3 / 3)
    assert [op["name"] for op in summary["top_ops"]] == ["gemm_kernel", "window_attention_kernel", "add_kernel"]
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == summary
    assert dict(traceparse.parse_trace(str(tmp_path))[0])  # summary.json beside the trace is not read as one


def test_profile_tool_prints_the_span_totals_beside_the_tallies(tmp_path, capsys):
    """With the run's ``spans.jsonl`` (``profiling.span_totals`` of the traced
    run) beside the trace, the tool prints each span's device ms beside the
    tallies and keeps them in ``summary.json``; the trace is still the one parsed."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_profile_propagation.py")
    spec = importlib.util.spec_from_file_location("torch_profile_propagation", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    _write(tmp_path, _trace_events())
    spans = {"predictor.replays": {"count": 1, "rows": 3, "host_ms": 0.5, "device_ms": 0.02,
                                   "parents": {"None": 1}},
             "sam2.encoder": {"count": 3, "rows": 3, "host_ms": 0.0, "device_ms": 0.012,
                              "parents": {"predictor.replays": 3}}}
    with open(tmp_path / "spans.jsonl", "w") as f:
        for name, t in spans.items():
            f.write(json.dumps({"name": name, **t}) + "\n")
    summary = tool.main(["--analyze-only", "--out", str(tmp_path), "--frames", "4", "--top", "3"])
    printed = capsys.readouterr().out
    assert "-- by program span" in printed and "sam2.encoder" in printed
    assert printed.index("predictor.replays") < printed.index("sam2.encoder")  # most device time first
    assert summary["spans"] == spans and summary["total_ms"] == pytest.approx(29.25e-3)


MEASUREMENT_FILES = ["us_video_medsam2_tpu_torch/utils/profiling.py", "us_video_medsam2_tpu_torch/utils/traceparse.py",
                     "us_video_medsam2_tpu_torch/utils/flops.py", "tools/torch_profile_propagation.py",
                     "tools/torch_bench_train_step.py"]


@pytest.mark.parametrize("rel", MEASUREMENT_FILES)
def test_the_measurement_layer_leaves_jax_out(rel):
    """No import of JAX or the JAX package in the source (function-level
    imports included), and none in sys.modules after loading the file."""
    import ast
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, rel)
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(nm.split(".")[0] in ("jax", "jaxlib", "flax", "us_video_medsam2_tpu") for nm in names)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from us_video_medsam2_tpu_torch.utils import flops, profiling, traceparse\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'us_video_medsam2_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
