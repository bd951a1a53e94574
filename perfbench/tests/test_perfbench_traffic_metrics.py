"""Traffic made from the seed, the work functions and the metric arithmetic on a canned trace."""

import json
import math

import numpy as np
import pytest
import torch

from perfbench import common, harness
from perfbench.drivers import interactive
from perfbench.frozen.video import make_videos
from perfbench.work import kernels


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_inputs_are_a_function_of_the_seed(seed):
    a, ca = make_videos([common.sub_seed(seed, 1, 0, i) for i in range(2)], 3, 32, "cpu")
    b, cb = make_videos([common.sub_seed(seed, 1, 0, i) for i in range(2)], 3, 32, "cpu")
    c, _ = make_videos([common.sub_seed(seed + 1, 1, 0, i) for i in range(2)], 3, 32, "cpu")
    assert torch.equal(a, b) and np.array_equal(ca, cb) and not torch.equal(a, c)
    shapes = {"w.weight": (4, 3), "b.bias": (4,), "n.weight": (3,)}
    s1, s2 = common.state_dict_from(shapes, seed, "cpu"), common.state_dict_from(shapes, seed, "cpu")
    assert all(torch.equal(s1[k], s2[k]) for k in shapes)
    assert torch.equal(s1["n.weight"], torch.ones(3))


def test_every_seed_sends_the_same_lengths():
    cycles = []
    for seed in (1, 2**33):
        order = interactive.lengths(seed, 16, 64)
        cycles.append([next(order) for _ in range(49)])
    assert sorted(cycles[0]) == sorted(cycles[1]) == list(range(16, 65))
    assert cycles[0] != cycles[1]


def test_window_attention_work_by_hand():
    # one 4x4 window, 1 head of 2, no pooling: 16 queries x 16 keys x 2 dims x 2 products x 2
    assert kernels.window_attention(1, 4, 4, 4, 1, 2, False, 0, 2) == (4 * 2 * 16 * 16, 2 * 2 * (2 * 16 + 16 + 16))
    # pooled q: 4 queries a window, each reading its 2x2 input tokens
    ops, bytes_ = kernels.window_attention(1, 4, 4, 4, 1, 2, True, 0, 2)
    assert ops == 4 * 2 * 4 * 16 and bytes_ == 2 * 2 * (2 * 16 + 16 + 4)
    # a cut last strip: 2 windows high, the last keeps 4 of its 16 query rows
    ops, _ = kernels.window_attention(1, 8, 4, 4, 1, 2, False, 4, 2)
    assert ops == 4 * 2 * (16 + 4) * 16
    assert kernels.flash_attention(2, 1, 8, 10, 4, 2) == (4 * 2 * 8 * 10 * 4, 2 * 2 * 4 * (16 + 20))


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1, "args": args}


def canned_trace():
    """A window of 1,000 us: two kernels, a copy kernel, a memcpy, their
    launches, a benchmark span and a host operator over the idle stretch."""
    ev = [
        _event("perfbench.window", "user_annotation", 0, 1000),
        _event("perfbench.batch", "user_annotation", 0, 1000),
        _event("aten::copy_", "cpu_op", 590, 200),
    ]
    kernels_ = [("void window_attention_kernel<96, 13>(...)", "kernel", 100, 100, 1),
                ("flash_fwd_kernel", "kernel", 200, 200, 2),
                ("void at::native::bfloat16_copy_kernel_cuda(...)", "kernel", 400, 50, 3),
                ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 450, 50, 4)]
    for name, cat, ts, dur, corr in kernels_:
        ev.append(_event(name, cat, ts, dur, correlation=corr))
        ev.append(_event("cudaLaunchKernel" if cat == "kernel" else "cudaMemcpyAsync", "cuda_runtime", ts - 50, 5,
                         correlation=corr))
    return ev


def test_metrics_on_a_canned_trace():
    from perfbench.frozen import traceparse

    events = canned_trace()
    self_op, _, self_cat, _ = traceparse.tallies(events)
    summary = harness.summarize(events, self_op, self_cat, 1e-3)
    assert summary["busy_s"] == pytest.approx(400e-6) and summary["window_s"] == pytest.approx(1e-3)
    gaps = dict((n, s) for n, s in summary["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"perfbench.batch": 100e-6, "perfbench.batch / aten::copy_": 500e-6})
    assert summary["breakdown"]["device_ops"][0] == ["flash_fwd_kernel", pytest.approx(200e-6)]
    run = harness.Run(trace=summary, traced_frames=4, traced_requests=2, peak_flops=1e12, flops_per_request=1e5,
                      work_per_request=[("window_attention", dict(b=1, hp=4, wp=4, ws=4, nh=1, hd=2, q_pool=False,
                                                                  q_lq=0, itemsize=2)),
                                        ("flash_attention", dict(b=2, h=1, lq=8, lk=10, d=4, itemsize=2))])
    run.peak_bytes_per_s = 1e9
    read = {name: harness.reader(name)(run) for name in (
        "idle.serve", "copy_ms_per_frame.serve", "mfu.serve", "window_attention_roofline.serve",
        "flash_attention_roofline.serve")}
    assert read["idle.serve"] == pytest.approx(60.0)
    assert read["copy_ms_per_frame.serve"] == pytest.approx(100e-3 / 4)
    assert read["mfu.serve"] == pytest.approx(100 * 2e5 / 1e-3 / 1e12)
    wa_ops, wa_bytes = kernels.window_attention(1, 4, 4, 4, 1, 2, False, 0, 2)
    assert read["window_attention_roofline.serve"] == pytest.approx(
        100 * 2 * max(wa_ops / 1e12, wa_bytes / 1e9) / 100e-6)
    fl_ops, fl_bytes = kernels.flash_attention(2, 1, 8, 10, 4, 2)
    assert read["flash_attention_roofline.serve"] == pytest.approx(
        100 * 2 * max(fl_ops / 1e12, fl_bytes / 1e9) / 200e-6)


def test_readers_return_nothing_without_a_trace():
    run = harness.Run()
    for name in ("idle.serve", "idle.interactive", "copy_ms_per_frame.serve", "mfu.serve",
                 "window_attention_roofline.serve", "flash_attention_roofline.serve", "prompt_ms.interactive",
                 "frames_per_s", "request_ms.p95", "peak_mem_gib"):
        assert harness.reader(name)(run) is None, name


def test_end_to_end_arithmetic():
    run = harness.Run(window_s=2.0, frames=512, request_ms=[float(x) for x in range(1, 201)], prompt_ms=[3.0, 1.0, 2.0],
                      memory_peak_bytes=3 * 2**30, setup_s=12.5)
    assert harness.reader("frames_per_s")(run) == 256.0
    assert harness.reader("request_ms.p95")(run) == 190.0
    assert harness.reader("prompt_ms.interactive")(run) == 2.0
    assert harness.reader("peak_mem_gib")(run) == 3.0
    assert harness.reader("setup_s")(run) == 12.5


def test_judge_and_line():
    run = harness.Run(checks=[("gap_ratio_mean", 1.0, 2.0), ("gap_ratio_max", 5.0, 4.0)], setup_s=1.0)
    assert not harness.judge(run)
    run.checks[1] = ("gap_ratio_max", 3.0, 4.0)
    assert harness.judge(run)
    run.checks.append(("x", math.nan, 1.0))
    assert not harness.judge(run)
    run.checks.pop()
    bench = harness.benchmark()
    cell = "t512.interactive"
    ctx = harness.Context(cell, {}, {}, {}, 1, 1.0, False, "cpu", 0.0)
    run.request_ms = [10.0] * 20
    line = harness.result_line(bench, ctx, run, 1)
    assert list(line)[-1] == "checks" and line["correct"]
    assert set(line["metrics"]) == {"request_ms.p95", "setup_s"}
    json.dumps(line)


def test_the_compared_numbers():
    r = torch.ones(2, 3, 4, 4)
    p = torch.zeros(2, 3, 4, 4)
    p[1, 2] = 3.0  # one frame 2 logits off, the others 1
    w = torch.full((2, 3, 4, 4), 0.5)  # the bf16 reference 0.5 off on every frame
    run = harness.Run()
    common.compare(run, {"gap_ratio_mean": 2.0, "gap_ratio_max": 3.0}, [common.frame_norms(p, r)],
                   [common.frame_norms(w, r)])
    assert run.checks == [("gap_ratio_mean", pytest.approx(7 / 6 / 0.5), 2.0), ("gap_ratio_max", 4.0, 3.0)]
    assert run.gaps[0].shape == (2, 3, 2)
