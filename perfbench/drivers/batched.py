"""Batched propagation: batches of N videos x T frames back to back, one client.

The traffic's parameters: ``videos`` (N) and ``frames`` (T) a batch, and
``distinct_batches``, how many different batches the run makes from its seed
and sends in turn. Each video is a seeded moving-blob video at the model's
resolution with one positive click at blob 0's centre on frame 0. A batch's
frames start on the host in page-locked memory; ``batched_propagate`` copies
them to the card, prompts frame 0 of every video, tracks frames 1..T-1 (one
replay of the captured frame body a frame, over the N rows) and fills holes;
its logits [N, T, 4fs, 4fs] then go back to page-locked host memory. A batch
is complete when they are there.

Measured: every frame of the completed batches over the window's wall time
(the window ends when the last batch begun in it completes). Correct: one
completed batch drawn from the seed, every row and every frame, against the
reference run on the same frames, clicks and weights.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import common, harness
from perfbench.frozen.video import make_videos


def _inputs(ctx, size: int):
    """The run's distinct batches: ([uint8 videos [N, T, S, S, 3] pinned on the
    host (on the device in the CPU tests)], [clicks [N, 1, 2]])."""
    p = ctx.traffic
    n, t = p["videos"], p["frames"]
    videos, clicks = [], []
    for b in range(p["distinct_batches"]):
        v, c = make_videos([common.sub_seed(ctx.seed, 1, b, i) for i in range(n)], t, size, ctx.device)
        videos.append(v.cpu().pin_memory() if ctx.device == "cuda" else v)
        clicks.append(c[:, None, :])
    return videos, clicks


def run(ctx: harness.Context) -> harness.Run:
    from us_video_medsam2_tpu_torch.inference.serve import batched_propagate

    out = harness.Run()
    dev = ctx.device
    cfg = ctx.config
    size = cfg["model"]["image_size"]
    steps = common.Steps(out.setup_parts, ctx.t_start)
    steps("imports")
    common.build_kernels(dev)
    steps("kernel library")
    sd = common.state_dict(cfg, ctx.seed, dev)
    steps("weights")
    pred = common.program(cfg, sd, dev)
    steps("program")
    videos, clicks = _inputs(ctx, size)
    steps("inputs")
    n, t = videos[0].shape[:2]
    labels = np.ones((n, 1), np.int32)
    pin = dev == "cuda"
    low = 4 * (size // cfg["model"]["backbone_stride"])
    # page-locked output buffers in turn; a traced window keeps each of its batches' own
    host = [torch.empty((n, t, low, low), pin_memory=pin) for _ in range(max(2, ctx.traffic["traced_batches"]))]

    def batch(i: int) -> torch.Tensor:
        """Batch i (of the distinct ones, in turn), its logits on the host."""
        k = i % len(videos)
        logits = batched_propagate(pred, videos[k], clicks[k], labels)
        h = host[i % len(host)]
        h.copy_(logits, non_blocking=pin)
        common.synchronize(dev)
        return h

    for i in range(2):  # capture, then one replayed batch: every shape of the window
        batch(i)
    common.synchronize(dev)
    steps("warm-up")

    rng = np.random.default_rng(common.sub_seed(ctx.seed, 2))
    kept = None  # (batch index, logits): one completed batch, uniform over the window's (reservoir)
    common.reset_peak(dev)
    out.setup_s = common.now() - ctx.t_start
    if ctx.trace:
        from torch.autograd.profiler import record_function

        def traced_batches():
            done = []
            for i in range(ctx.traffic["traced_batches"]):
                with record_function("perfbench.batch"):
                    done.append((i, batch(i)))
            return done

        results, out.trace = harness.traced(traced_batches, lambda: common.synchronize(dev))
        kept = results[int(rng.integers(len(results)))]
        out.traced_requests = out.attempted = len(results)
        out.traced_frames = len(results) * n * t
        out.peak_flops = common.peak_flops(common.card_name(dev))
    else:
        t0 = common.now()
        i = 0
        while common.now() - t0 < ctx.seconds:
            h = batch(i)
            i += 1
            if rng.random() * i < 1.0:
                kept = (i - 1, h.clone())
        out.window_s = common.now() - t0
        out.attempted = i
        out.frames = i * n * t
    out.memory_peak_bytes = common.peak_bytes(dev)

    # the comparison, once the program is freed
    del pred
    common.free(dev)
    t_compare = common.now()
    k = kept[0] % len(videos)
    job = dict(video_u8=videos[k].to(dev), coords=torch.as_tensor(clicks[k], device=dev),
               labels=torch.as_tensor(labels, device=dev), fill_hole_area=cfg["fill_hole_area"], fill_first=True)
    (expect,), (witness,), flops, record = common.reference_outputs(cfg, sd, dev, [job], count=ctx.trace)
    common.compare(out, ctx.limits, [common.frame_norms(kept[1].to(dev), expect)],
                   [common.frame_norms(witness, expect)])
    out.flops_per_request, out.work_per_request = flops, record
    out.compare_s = common.now() - t_compare
    return out


def control(ctx: harness.Context) -> tuple:
    """The control's comparison: the cell's first distinct batch through the
    reference under fp8 products in the program's place; (its frame norms,
    the bf16 reference's), each against the float32 reference."""
    dev, cfg = ctx.device, ctx.config
    sd = common.state_dict(cfg, ctx.seed, dev)
    videos, clicks = _inputs(ctx, cfg["model"]["image_size"])
    n = videos[0].shape[0]
    job = dict(video_u8=videos[0].to(dev), coords=torch.as_tensor(clicks[0], device=dev),
               labels=torch.ones((n, 1), dtype=torch.int32, device=dev), fill_hole_area=cfg["fill_hole_area"],
               fill_first=True)
    (expect,), (witness,), _, _ = common.reference_outputs(cfg, sd, dev, [job])
    _, (low,), _, _ = common.reference_outputs(cfg, sd, dev, [job], control=True)
    return [common.frame_norms(low, expect)], [common.frame_norms(witness, expect)]
