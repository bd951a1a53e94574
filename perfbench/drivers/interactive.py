"""Interactive propagation: one client, one video a request, closed loop.

The traffic's parameters: ``min_frames`` .. ``max_frames`` (the lengths,
every one of them once in each cycle, in an order drawn from the seed, so
every seed sends the same set of lengths), ``distinct_videos`` (seeded
moving-blob videos of ``max_frames`` frames; a request of length L takes the
first L frames of one, drawn from the seed), ``t_bucket`` (the bank's slots,
so one captured frame body serves every length) and ``kept_requests``, how
many completed requests the comparison samples (the longest length's first
request is compared besides). The window runs whole cycles: it closes at the
end of the first cycle that ends after ``--seconds``, so every run's tail is
taken over the same set of lengths.

A request is what a clinician waits for: ``init_state`` over the uint8 frames
(page-locked on the host), one positive click at blob 0's centre on frame 0
(``add_new_points_or_box``), then ``propagate_in_video`` to the end, every
frame's mask logits at the video's size on the host. Measured: each request's
wall time. Correct: the sampled requests' masks, every frame, against the
reference run on the same frames, click and weights.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import common, harness
from perfbench.frozen.video import make_videos


def lengths(seed: int, lo: int, hi: int):
    """Every length in lo..hi once a cycle, each cycle in an order drawn from the seed."""
    rng = np.random.default_rng(common.sub_seed(seed, 3))
    while True:
        yield from (int(x) for x in rng.permutation(np.arange(lo, hi + 1)))


def run(ctx: harness.Context) -> harness.Run:
    out = harness.Run()
    dev = ctx.device
    cfg, p = ctx.config, ctx.traffic
    size = cfg["model"]["image_size"]
    steps = common.Steps(out.setup_parts, ctx.t_start)
    steps("imports")
    common.build_kernels(dev)
    steps("kernel library")
    sd = common.state_dict(cfg, ctx.seed, dev)
    steps("weights")
    pred = common.program(cfg, sd, dev)
    steps("program")
    v, clicks = make_videos([common.sub_seed(ctx.seed, 1, k) for k in range(p["distinct_videos"])],
                            p["max_frames"], size, dev)
    videos = v.cpu().pin_memory() if dev == "cuda" else v
    del v
    steps("inputs")
    pick = np.random.default_rng(common.sub_seed(ctx.seed, 4))
    span = None
    if ctx.trace:
        from torch.autograd.profiler import record_function as span

    def request(length: int, k: int, timed_prompt: bool = False):
        """The masks of one request, on the host: a [H, W] array a frame."""
        with span("perfbench.prompt") if span else contextlib.nullcontext():
            t0 = common.now()
            state = pred.init_state(videos[k, :length], size, size, t_bucket=p["t_bucket"])
            pred.add_new_points_or_box(state, 0, 1, points=clicks[k][None], labels=np.array([1], np.int32))
            if timed_prompt:
                common.synchronize(dev)
                out.prompt_ms.append((common.now() - t0) * 1e3)
        with span("perfbench.propagate") if span else contextlib.nullcontext():
            return [m[0, 0] for _, _, m in pred.propagate_in_video(state)]

    for length in (p["max_frames"], p["min_frames"]):  # the one capture, then a replayed request
        request(length, 0)
    common.synchronize(dev)
    steps("warm-up")

    order = lengths(ctx.seed, p["min_frames"], p["max_frames"])
    kept, longest = [], None  # reservoir of completed requests; the first of the longest length
    rng = np.random.default_rng(common.sub_seed(ctx.seed, 2))

    def one(i: int, timed_prompt: bool = False):
        nonlocal longest
        length, k = next(order), int(pick.integers(p["distinct_videos"]))
        t0 = common.now()
        masks = request(length, k, timed_prompt)
        out.request_ms.append((common.now() - t0) * 1e3)
        item = (length, k, masks)
        if length == p["max_frames"] and longest is None:
            longest = item
        elif len(kept) < p["kept_requests"]:
            kept.append(item)
        else:  # reservoir: each completed request kept with the same chance
            j = int(rng.integers(i + 1))
            if j < p["kept_requests"]:
                kept[j] = item

    common.reset_peak(dev)
    out.setup_s = common.now() - ctx.t_start
    if ctx.trace:

        def traced_requests():
            for i in range(p["traced_requests"]):
                with span("perfbench.request"):
                    one(i, timed_prompt=True)
            return p["traced_requests"]

        out.traced_requests, out.trace = harness.traced(traced_requests, lambda: common.synchronize(dev))
        out.attempted = out.traced_requests
    else:
        # whole cycles of lengths: the window closes at the first cycle's end
        # past ``seconds``, so every run sends the same set of lengths
        cycle = p["max_frames"] - p["min_frames"] + 1
        t0, i = common.now(), 0
        while i % cycle or common.now() - t0 < ctx.seconds:
            one(i)
            i += 1
        out.window_s = common.now() - t0
        out.attempted = i
    out.memory_peak_bytes = common.peak_bytes(dev)

    del pred
    common.free(dev)
    t_compare = common.now()
    sample = kept + ([longest] if longest is not None else [])
    jobs = [dict(video_u8=videos[k, :length][None].to(dev), coords=torch.as_tensor(clicks[k][None, None], device=dev),
                 labels=torch.ones((1, 1), dtype=torch.int32, device=dev), fill_hole_area=cfg["fill_hole_area"],
                 fill_first=False, video_hw=(size, size)) for length, k, _ in sample]
    expect, witness, _, _ = common.reference_outputs(cfg, sd, dev, jobs)
    common.compare(out, ctx.limits, [common.frame_norms(torch.as_tensor(np.stack(m), device=dev), e[0])
                                     for (_, _, m), e in zip(sample, expect)],
                   [common.frame_norms(w[0], e[0]) for w, e in zip(witness, expect)])
    out.compare_s = common.now() - t_compare
    return out



def control(ctx: harness.Context) -> tuple:
    """The control's comparison: requests of the longest length and of the
    seed's first ``kept_requests`` lengths through the reference under fp8
    products in the program's place; (their frame norms, the bf16
    reference's), each against the float32 reference."""
    dev, cfg, p = ctx.device, ctx.config, ctx.traffic
    size = cfg["model"]["image_size"]
    sd = common.state_dict(cfg, ctx.seed, dev)
    videos, clicks = make_videos([common.sub_seed(ctx.seed, 1, k) for k in range(p["distinct_videos"])],
                                 p["max_frames"], size, dev)
    order = lengths(ctx.seed, p["min_frames"], p["max_frames"])
    sample = [(p["max_frames"], 0)] + [(next(order), k % p["distinct_videos"]) for k in range(p["kept_requests"])]
    jobs = [dict(video_u8=videos[k, :length][None], coords=torch.as_tensor(clicks[k][None, None], device=dev),
                 labels=torch.ones((1, 1), dtype=torch.int32, device=dev), fill_hole_area=cfg["fill_hole_area"],
                 fill_first=False, video_hw=(size, size)) for length, k in sample]
    expect, witness, _, _ = common.reference_outputs(cfg, sd, dev, jobs)
    _, low, _, _ = common.reference_outputs(cfg, sd, dev, jobs, control=True)
    return ([common.frame_norms(a[0], e[0]) for a, e in zip(low, expect)],
            [common.frame_norms(w[0], e[0]) for w, e in zip(witness, expect)])
