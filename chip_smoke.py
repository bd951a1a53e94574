#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (us_video_medsam2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. the build: every ``csrc/*.cu`` kernel compiled for sm_90a (timed as set-up);
3. each kernel against its plain PyTorch version at every shape the main path
   gives it, in bf16: max abs / rel error against the stated tolerance, and
   times (CUDA events over runs of back-to-back launches) of the kernel, the
   plain version and, where one PyTorch call computes the same function, that
   call (``library_ms``); the
   bound is max(bytes / 3.35 TB/s, flops / peak) from the shapes (bf16 tensor
   peak 989 TFLOP/s for products, 67 TFLOP/s f32 for LayerNorm); the
   attention checks are scaled to the output, and the flash check must reject
   the plain version run with the 24 valid pointer keys masked; then each
   kernel once more at shapes off the main path (ragged tiles, batch and
   heads above 1, a fully masked batch), against the same tolerance;
4. the main path: ``sam2.1_hiera_t512`` at full width in bf16 on the card with
   weights from a seeded generator (the object-score head's output bias is
   set to +10 so the object is present on every frame and the masks are not
   all "no object"), on a seeded video of smooth moving blobs:
   ``init_state`` -> ``add_new_points_or_box`` (frame 0, one click) ->
   ``propagate_in_video``. Launch counters are zeroed just before and read
   just after and must equal 9 window-attention, 12 LayerNorm and 12 MLP
   launches per encoded frame and 8 flash launches per tracked frame. The
   first frames are run again on the host CPU (plain versions, f32) with the
   same weights and compared per frame;
5. the kernels line, the card line, and the device line last.

Exits non-zero without a result when no CUDA device is present or when the
port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# bf16 kernel vs plain. LayerNorm and MLP outputs are O(1): |a - b| <= TOL +
# TOL * |b|, as the JAX kernel tests. An attention output is a softmax average
# of N(0,1) values, with an rms of about sqrt(e / keys) (0.02 over 5,144 keys),
# so an absolute floor of TOL would pass a kernel that drops keys; attention is
# held to its output's own scale instead: max |a - b| <= TOL * max |b| and
# ||a - b|| / ||b|| <= ATTN_REL_L2_TOL.
TOL = 2e-2
ATTN_REL_L2_TOL = 1e-2
# card bf16 vs host f32, per frame. bf16 moves a logit by about 1% of the
# frame's rms logit, so pixels within 5% of rms from 0 may flip sign. With
# seeded weights the foreground after frame 0 is well under 1% of the frame
# and lies mostly in that band, so the plain IoU of such masks swings by
# tens of points (0.83-0.99 measured) and is printed for information; the
# gate is the IoU over the pixels outside the band.
LOGIT_REL_L2_TOL = 0.1
SIGN_BAND = 0.05
MASK_IOU_TOL = 0.99

REPLACES = {
    "layer_norm": "us_video_medsam2_tpu/kernels/fused_ln.py:54",
    "ln_mlp_residual": "us_video_medsam2_tpu/kernels/fused_mlp.py:129",
    "window_attention": "us_video_medsam2_tpu/kernels/fused_window_attention.py:314",
    "flash_attention": "us_video_medsam2_tpu/kernels/flash_attention.py:113",
}
SOURCE = "us_video_medsam2_tpu_torch/csrc/{}.cu"

# main-path shapes of sam2.1_hiera_t512 at 512x512, with launches per frame
LN_SHAPES = [((16384, 96), 2), ((4096, 192), 2), ((1024, 384), 7), ((256, 768), 1)]
MLP_SHAPES = [((16384, 96, 384), 1), ((4096, 192, 768), 2), ((1024, 384, 1536), 7),
              ((256, 768, 3072), 2)]
WIN_SHAPES = [((128, 8, 1, False), 1), ((128, 8, 2, True), 1), ((64, 4, 2, False), 1),
              ((64, 4, 4, True), 1), ((42, 14, 4, False), 3), ((42, 14, 8, True), 1),
              ((21, 7, 8, False), 1)]
HD = 96
FRAMES = 16  # video length of the main path
CHECK_FRAMES = 4  # frames run again on the host CPU
REPEATS = 3  # timed main-path runs, median kept
SEED = 0
PER_ENCODED_FRAME = {"window_attention": 9, "layer_norm": 12, "ln_mlp_residual": 12}
PER_TRACKED_FRAME = {"flash_attention": 8}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, launches: int = 20, batches: int = 5, warmup: int = 3) -> float:
    """Median over ``batches`` of the CUDA-event time of ``launches``
    back-to-back calls, divided by ``launches`` (inputs stay in L2)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def agreement(got, want, attention: bool) -> tuple[bool, str, float]:
    """(within tolerance, message, max abs error) of ``got`` against ``want``."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        return False, "output not finite", float("nan")
    err = (g - w).abs()
    max_abs = err.max().item()
    rel_l2 = (err.norm() / w.norm().clamp(min=1e-30)).item()
    if attention:
        ref_max = w.abs().max().item()
        ok = max_abs <= TOL * ref_max and rel_l2 <= ATTN_REL_L2_TOL
        tol = f"max |d| <= {TOL} max|ref| = {TOL * ref_max:.3e}, rel-L2 <= {ATTN_REL_L2_TOL}"
    else:
        ok = bool((err <= TOL + TOL * w.abs()).all())
        tol = f"|d| <= {TOL} + {TOL}|ref|"
    return ok, f"max_abs {max_abs:.3e} rel-L2 {rel_l2:.3e} (tol {tol})", max_abs


def compare(name: str, got, want, attention: bool = False) -> float:
    ok, msg, max_abs = agreement(got, want, attention)
    log(f"  {name}: {msg} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


class Row:
    """Per-kernel totals over one frame's launches at the main-path shapes."""

    def __init__(self, name):
        self.name = name
        self.max_abs = 0.0
        self.ms = self.plain_ms = self.bound = 0.0
        self.library_ms = None
        self.bytes_bound = 0.0
        self.ops_bound = 0.0
        self.shapes = []

    def add(self, shape, count, err, ms, plain_ms, b, by, lib_ms=None):
        self.max_abs = max(self.max_abs, err)
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bound += count * b
        if by == "bytes":
            self.bytes_bound += count * b
        else:
            self.ops_bound += count * b
        if lib_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + count * lib_ms
        self.shapes.append({"shape": shape, "per_frame": count, "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                            "library_ms": lib_ms})
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"    {shape} x{count}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {b:.4f} ms ({by}), share of bound {b / ms:.3f}")


def check_kernels(g) -> dict:
    import torch
    import torch.nn.functional as F

    from us_video_medsam2_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from us_video_medsam2_tpu_torch.kernels.layer_norm import layer_norm, layer_norm_plain
    from us_video_medsam2_tpu_torch.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
    from us_video_medsam2_tpu_torch.kernels.window_attention import window_attention, window_attention_plain

    dev = "cuda"
    bf = torch.bfloat16

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}
    r = rows["layer_norm"] = Row("layer_norm")
    log("layer_norm (fast variance, eps 1e-6)")
    for (n, d), cnt in LN_SHAPES:
        x = rn(n, d)
        w = 1.0 + rn(d, scale=0.1, dtype=torch.float32)
        b = rn(d, scale=0.1, dtype=torch.float32)
        err = compare(f"({n},{d})", layer_norm(x, w, b), layer_norm_plain(x, w, b))
        wb, bb = w.to(bf), b.to(bf)
        bnd, by = bound_ms(4 * n * d + 8 * d, 7 * n * d, F32_FLOPS)
        r.add([n, d], cnt, err, time_ms(lambda: layer_norm(x, w, b)),
              time_ms(lambda: layer_norm_plain(x, w, b)), bnd, by,
              time_ms(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6)))

    r = rows["ln_mlp_residual"] = Row("ln_mlp_residual")
    log("ln_mlp_residual (two-pass LN eps 1e-6, exact GELU)")
    for (n, d, f), cnt in MLP_SHAPES:
        x = rn(n, d)
        lw = 1.0 + rn(d, scale=0.1, dtype=torch.float32)
        lb = rn(d, scale=0.1, dtype=torch.float32)
        w1, b1 = rn(f, d, scale=d**-0.5), rn(f, scale=0.1, dtype=torch.float32)
        w2, b2 = rn(d, f, scale=f**-0.5), rn(d, scale=0.1, dtype=torch.float32)
        args = (x, lw, lb, w1, b1, w2, b2)
        err = compare(f"({n},{d},{f})", ln_mlp_residual(*args), ln_mlp_residual_plain(*args))
        bnd, by = bound_ms(4 * n * d + 4 * d * f + 4 * (f + 3 * d), 4 * n * d * f, BF16_FLOPS)
        r.add([n, d, f], cnt, err, time_ms(lambda: ln_mlp_residual(*args)),
              time_ms(lambda: ln_mlp_residual_plain(*args)), bnd, by)

    r = rows["window_attention"] = Row("window_attention")
    log(f"window_attention (hd {HD}, f32 scores, bf16 P)")
    for (hp, ws, nh, pool), cnt in WIN_SHAPES:
        qkv = rn(1, hp, hp, 3 * nh * HD)
        wso = ws // 2 if pool else ws
        err = compare(f"{hp}^2 ws{ws} nh{nh} pool={pool}", window_attention(qkv, ws, nh, pool),
                      window_attention_plain(qkv, ws, nh, pool), attention=True)
        nwin = (hp // ws) ** 2
        out_elems = nwin * wso * wso * nh * HD
        flops = 4 * nwin * nh * (wso * wso) * (ws * ws) * HD
        bnd, by = bound_ms(2 * qkv.numel() + 2 * out_elems, flops, BF16_FLOPS)
        r.add([hp, hp, ws, nh, pool], cnt, err, time_ms(lambda: window_attention(qkv, ws, nh, pool)),
              time_ms(lambda: window_attention_plain(qkv, ws, nh, pool)), bnd, by)

    r = rows["flash_attention"] = Row("flash_attention")
    log("flash_attention (D 256, key mask)")
    # memory-attention keys of a tracked frame: 7 memory slots of 1024 tokens
    # (two invalid early in a video) + 16 object pointers x 4 tokens (some invalid)
    lk_cross = 7 * 1024 + 64
    mask = torch.ones(1, lk_cross, dtype=torch.bool, device=dev)
    mask[:, 5 * 1024: 7 * 1024] = False
    mask[:, 7 * 1024 + 24:] = False
    for (lq, lk, m), cnt in (((1024, 1024, None), 4), ((1024, lk_cross, mask), 4)):
        q, k, v = rn(1, 1, lq, 256), rn(1, 1, lk, 256), rn(1, 1, lk, 256)
        want = flash_attention_plain(q, k, v, m)
        err = compare(f"q{lq} k{lk} mask={m is not None}", flash_attention(q, k, v, m), want,
                      attention=True)
        if m is not None:
            # the check must reject a kernel that drops the 24 valid pointer keys
            m_drop = m.clone()
            m_drop[:, 7 * 1024:] = False
            ok, msg, _ = agreement(flash_attention_plain(q, k, v, m_drop), want, attention=True)
            log(f"  self-test, pointer keys dropped: {msg} {'passed (FAIL)' if ok else 'rejected'}")
            if ok:
                raise AssertionError("the flash check does not see 24 dropped keys")
        valid = lk if m is None else int(m.sum().item())
        nbytes = 2 * 2 * lq * 256 + 2 * 2 * valid * 256 + (0 if m is None else lk)
        bnd, by = bound_ms(nbytes, 4 * lq * valid * 256, BF16_FLOPS)
        am = None if m is None else m[:, None, None, :]
        r.add([lq, lk, 256, m is not None], cnt, err, time_ms(lambda: flash_attention(q, k, v, m)),
              time_ms(lambda: flash_attention_plain(q, k, v, m)), bnd, by,
              time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am)))

    # once more, untimed, at shapes off the main path that the wrappers take:
    # ragged last tiles, batch and heads above 1, a batch whose keys are all masked
    log("edge shapes (bf16, untimed)")
    x = rn(1005, 384)
    w, b = 1.0 + rn(384, scale=0.1, dtype=torch.float32), rn(384, scale=0.1, dtype=torch.float32)
    compare("layer_norm (1005,384)", layer_norm(x, w, b), layer_norm_plain(x, w, b))
    x = rn(1000, 192)
    args = (x, w[:192], b[:192], rn(768, 192, scale=192**-0.5), rn(768, scale=0.1, dtype=torch.float32),
            rn(192, 768, scale=768**-0.5), rn(192, scale=0.1, dtype=torch.float32))
    compare("ln_mlp_residual (1000,192,768)", ln_mlp_residual(*args), ln_mlp_residual_plain(*args))
    for shape, ws, nh, pool in (((2, 28, 42), 14, 2, True), ((2, 14, 21), 7, 3, False)):
        qkv = rn(*shape, 3 * nh * HD)
        compare(f"window_attention B{shape[0]} {shape[1]}x{shape[2]} ws{ws} nh{nh} pool={pool}",
                window_attention(qkv, ws, nh, pool), window_attention_plain(qkv, ws, nh, pool),
                attention=True)
    q, k, v = rn(2, 2, 1000, 256), rn(2, 2, 1100, 256), rn(2, 2, 1100, 256)
    mask = torch.rand(2, 1100, generator=g, device=dev) > 0.3
    mask[1] = False
    compare("flash_attention B2 H2 q1000 k1100, batch 1 all masked", flash_attention(q, k, v, mask),
            flash_attention_plain(q, k, v, mask), attention=True)
    return rows


def make_video(frames: int, size: int, seed: int):
    """uint8 [T, size, size, 3]: smooth moving Gaussian blobs on a gradient,
    and the (x, y) centre of blob 0 on frame 0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    n_blobs = 3
    c0 = rng.uniform(0.25, 0.75, (n_blobs, 2)) * size
    vel = rng.uniform(-3.0, 3.0, (n_blobs, 2))
    rad = rng.uniform(0.06, 0.12, n_blobs) * size
    col = rng.uniform(80, 255, (n_blobs, 3))
    base = (20 + 40 * xx / size + 30 * yy / size)[..., None] * np.ones(3, np.float32)
    video = np.empty((frames, size, size, 3), np.uint8)
    for t in range(frames):
        img = base.copy()
        for i in range(n_blobs):
            cx, cy = c0[i] + vel[i] * t
            a = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * rad[i] ** 2))[..., None]
            img = img * (1 - a) + col[i] * a
        video[t] = np.clip(img, 0, 255).astype(np.uint8)
    return video, (float(c0[0, 0]), float(c0[0, 1]))


def run_main_path(predictor, video, click, stop_after=None):
    """init_state -> add_new_points_or_box (frame 0, one positive click) ->
    propagate_in_video. Returns ({frame: video-res logits [1, H, W]},
    seconds of init_state + prompt, seconds of propagation)."""
    import torch

    sync = torch.cuda.synchronize if predictor.device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    size = video.shape[1]
    state = predictor.init_state(video, size, size)
    predictor.add_new_points_or_box(state, 0, 1, points=[list(click)], labels=[1])
    sync()
    t1 = time.perf_counter()
    out = {}
    for f, _, masks in predictor.propagate_in_video(state):
        out[f] = masks[:, 0]
        if stop_after is not None and len(out) >= stop_after:
            break
    sync()
    return out, t1 - t0, time.perf_counter() - t1


def profile_main_path(predictor, video, click, out_dir, wall_s):
    """One main-path run under torch.profiler: device time by kernel, and a
    Chrome trace in ``out_dir``. The idle share is taken against ``wall_s``,
    the unprofiled run's wall time (the profiler slows the host down)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_main_path(predictor, video, click)
    wall_us = wall_s * 1e6
    prof.export_chrome_trace(os.path.join(out_dir, "main_path_trace.json"))
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile: device busy {busy / 1e3:.2f} ms over the main path, unprofiled wall "
        f"{wall_us / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, "
        f"{sum(r[1] for r in rows)} kernel launches")
    for us, count, key in rows[:25]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% x{count:<5d} {key[:110]}")


def iou(a, b) -> float:
    union = (a | b).sum()
    return 1.0 if union == 0 else float((a & b).sum() / union)


def counters():
    from us_video_medsam2_tpu_torch.kernels import flash_attention, layer_norm, ln_mlp_residual, window_attention

    return {
        "window_attention": window_attention.window_attention,
        "layer_norm": layer_norm.layer_norm,
        "ln_mlp_residual": ln_mlp_residual.ln_mlp_residual,
        "flash_attention": flash_attention.flash_attention,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", help="also profile one main-path run, trace into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from us_video_medsam2_tpu_torch.core.build import build_sam2
        from us_video_medsam2_tpu_torch.inference.video_predictor import SAM2VideoPredictor
        from us_video_medsam2_tpu_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1/5] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. the build
    t0 = time.perf_counter()
    msgs = []
    lib = _lib.build(log=msgs.append)
    _lib.load()
    build_s = time.perf_counter() - t0
    if msgs:
        (lib.parent / "nvcc.log").write_text("\n".join(msgs))
    log(f"[2/5] build: {lib.name} in {build_s:.2f} s (set-up)")

    # 3. each kernel against its plain version
    log("[3/5] kernels vs plain versions at the main-path shapes (bf16)")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = check_kernels(g)

    # 4. the main path
    log("[4/5] main path: sam2.1_hiera_t512, bf16, seeded weights and video")
    model = build_sam2("sam2.1_hiera_t512", seed=SEED)
    with torch.no_grad():
        model.sam_mask_decoder.obj_score_head.layers_2.bias.fill_(10.0)
    host_sd = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to("cuda").set_compute_dtype(torch.bfloat16)
    predictor = SAM2VideoPredictor(model, fill_hole_area=8)
    video, click = make_video(FRAMES, model.cfg.image_size, SEED)

    run_main_path(predictor, video, click)  # warm-up: lazy CUDA / library initialisation
    wrappers = counters()
    n = FRAMES
    expected = {k: v * n for k, v in PER_ENCODED_FRAME.items()}
    expected.update({k: v * (n - 1) for k, v in PER_TRACKED_FRAME.items()})
    runs = []
    for _ in range(REPEATS):
        for w in wrappers.values():
            w.launches = 0
        masks, t_prompt, t_prop = run_main_path(predictor, video, click)
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"  launches {launches}, expected {expected}")
        if launches != expected:
            raise AssertionError(f"launch counts {launches} != {expected}")
        runs.append((t_prompt + t_prop, t_prompt, t_prop))
    wall, t_prompt, t_prop = sorted(runs)[len(runs) // 2]
    log(f"  walls of the {len(runs)} runs (s): {[round(r[0], 4) for r in runs]}; median below")
    if sorted(masks) != list(range(n)):
        raise AssertionError(f"frames yielded {sorted(masks)}")
    for f, m in masks.items():
        if m.shape != (1, video.shape[1], video.shape[2]) or not torch.isfinite(torch.from_numpy(m)).all():
            raise AssertionError(f"frame {f}: mask logits shape {m.shape} or non-finite values")
    fg = [float((masks[f] > 0).mean()) for f in range(n)]
    log(f"  foreground fraction per frame: {[round(x, 4) for x in fg]}")
    log(f"  {n} frames in {wall:.3f} s: {n / wall:.2f} frames/s, {1e3 * wall / n:.2f} ms/frame "
        f"(init_state + prompt + propagation, host clock) on {card}")
    log(f"  init_state + prompt {1e3 * t_prompt:.2f} ms; propagation {1e3 * t_prop:.2f} ms = "
        f"{1e3 * t_prop / (n - 1):.2f} ms per tracked frame ({(n - 1) / t_prop:.2f} frames/s)")
    if args.profile:
        profile_main_path(predictor, video, click, args.profile, wall)

    k = CHECK_FRAMES
    log(f"  host CPU reference (plain versions, f32) on the first {k} frames")
    cpu_model = build_sam2("sam2.1_hiera_t512", state_dict=host_sd)
    cpu_pred = SAM2VideoPredictor(cpu_model, fill_hole_area=8, device="cpu")
    t0 = time.perf_counter()
    ref, _, _ = run_main_path(cpu_pred, video, click, stop_after=k)
    log(f"  host run {time.perf_counter() - t0:.1f} s")
    for f in sorted(ref):
        a, b = masks[f].astype("float64"), ref[f].astype("float64")
        rel = float(((a - b) ** 2).sum() ** 0.5 / max(((b ** 2).sum()) ** 0.5, 1e-12))
        clear = abs(b) > SIGN_BAND * float((b ** 2).mean()) ** 0.5
        iou_all = iou(a > 0, b > 0)
        iou_clear = iou((a > 0) & clear, (b > 0) & clear)
        ok = rel <= LOGIT_REL_L2_TOL and iou_clear >= MASK_IOU_TOL
        log(f"  frame {f}: logit rel-L2 {rel:.4e} (tol {LOGIT_REL_L2_TOL}), mask IoU {iou_clear:.5f} "
            f"on the {float(clear.mean()):.4f} of pixels with |logit| > {SIGN_BAND} rms "
            f"(tol {MASK_IOU_TOL}); IoU over all pixels {iou_all:.5f}, foreground "
            f"{float((b > 0).mean()):.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"frame {f}: card and host disagree")

    # 5. the kernels line, the card line, the device line
    kernels = []
    for kname, r in rows.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE.format(kname),
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": r.max_abs, "ms": r.ms, "plain_ms": r.plain_ms,
            "bound_ms": r.bound, "bound_by": "bytes" if r.bytes_bound >= r.ops_bound else "operations",
            "library_ms": r.library_ms,
        })
    detail = {r.name: r.shapes for r in rows.values()}
    log("[5/5] per-shape detail " + json.dumps(detail))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
