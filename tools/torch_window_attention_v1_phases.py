#!/usr/bin/env python3
"""Where a window_attention_v1 attention-kernel call's time goes: the clock of each phase of its blocks (one GPU).

    PYTHONPATH=. python3 tools/torch_window_attention_v1_phases.py [--stages N]

Builds a copy of ``us_video_medsam2_tpu_torch/csrc/window_attention_v1.cu``
with ``clock64()`` stamps inserted at the attention kernel's phase boundaries
(into ``build/window_attention_v1_phases/``, with the port's nvcc flags; with
``--stages``, the ring's depth changed), and runs it at every geometry of
chip_smoke.py's ``V1_SHAPES`` with both ``ln_inside`` values and
``plan_for``'s pick, seeded inputs (chip_smoke.v1_args). Thread 0 of every
block records SM cycles from the kernel's start to the end of: the bias,
gamma, beta and address tables (the first pass's chunks already issued),
LayerNorm (the statistics, and the resident tokens where the plan holds
them), the K/V pass, the exchange of the cluster's K/V shares, the q pass,
cluster barrier 2, attention and o's store. It also sums the cycles thread 0
waits in the projection passes (cp.async wait and block barrier a chunk).
Prints, per call, the output's agreement with the plain version, the mean
cycles of each phase over the blocks, the slowest block's total, the wait
cycles and the stamped call's device ms (torch.profiler, both kernels);
then the card's name, power limit and SM clock.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

PHASES = ("tables", "LayerNorm", "K/V pass", "share exchange", "q pass", "barrier 2", "attention")
# (anchor in the source, text put before it); each anchor must occur once
STAMPS = [
    ("  // pooled q slab rows past lq", "  STAMP(0)\n"),
    ("  const int ya_col = (lane >> 4) * 8;", "  STAMP(1)\n"),
    ("  if (csz > 1) {\n    // this rank's K and V share", "  STAMP(2)\n"),
    ("  // 2. q of the rank's slabs", "  STAMP(3)\n"),
    ("  if (csz > 1) cluster_wait();  // barrier 2", "  STAMP(4)\n"),
    ("  // 3. attention, one", "  STAMP(5)\n"),
]
MAX_BLOCKS = 16384


def instrument(src: str, stages: int) -> str:
    def once(text, anchor, new):
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} found {text.count(anchor)} times in window_attention_v1.cu")
        return text.replace(anchor, new)

    src = once(src, "namespace {\n\nusing namespace usm;",
               f"__device__ long long v1_clk[{MAX_BLOCKS} * 8];\n__device__ long long v1_wait[{MAX_BLOCKS}];\n"
               "namespace {\n\nusing namespace usm;")
    src = once(src, "    bf16* __restrict__ o, const Geo geo, float scale) {",
               "    bf16* __restrict__ o, const Geo geo, float scale) {\n  const long long t_start = clock64();\n"
               "#define STAMP(k) if (threadIdx.x == 0) v1_clk[blockIdx.x * 8 + (k)] = clock64() - t_start;\n")
    for anchor, before in STAMPS:
        src = once(src, anchor, before + anchor)
    src = once(src, "    __syncwarp();\n  }\n}\n\n// out[m, n]", "    __syncwarp();\n  }\n  __syncthreads();\n  STAMP(6)\n}\n\n"
               "// out[m, n]")
    src = once(src, "constexpr int STAGES = 3;", f"constexpr int STAGES = {stages};")
    src = once(src, "    cp_wait<STAGES - 2>();  // this thread's copies of chunk c have landed",
               "    const long long t_w0 = clock64();\n    cp_wait<STAGES - 2>();  // this thread's copies of chunk c "
               "have landed")
    src = once(src, "    __syncthreads();  // chunk c is in place for every thread, and chunk c - 1's stage is free",
               "    __syncthreads();  // chunk c is in place for every thread, and chunk c - 1's stage is free\n"
               "    if (threadIdx.x == 0) v1_wait[blockIdx.x] += clock64() - t_w0;")
    return src + (
        '\nextern "C" int usm_v1_clocks(long long* clk, long long* wait, int n) {\n'
        "  cudaError_t e = cudaMemcpyFromSymbol(clk, v1_clk, n * 8 * sizeof(long long));\n"
        "  return e != cudaSuccess ? e : cudaMemcpyFromSymbol(wait, v1_wait, n * sizeof(long long));\n}\n"
        f'extern "C" int usm_v1_clear_waits() {{\n  static long long z[{MAX_BLOCKS}];\n'
        "  return cudaMemcpyToSymbol(v1_wait, z, sizeof(z));\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, default=3, help="the ring's stages in the stamped copy")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_window_attention_v1_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from us_video_medsam2_tpu_torch.kernels import _lib
    from us_video_medsam2_tpu_torch.kernels.rejected import window_attention_v1 as v1

    out_dir = _lib.BUILD_DIR / "window_attention_v1_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "window_attention_v1_phases.cu"
    src.write_text(instrument((_lib.CSRC / "window_attention_v1.cu").read_text(), args.stages))
    so = out_dir / f"libv1_phases_{args.stages}.so"
    build = subprocess.run([_lib.nvcc_path(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared", "-o", str(so),
                            str(src), str(_lib.CSRC / "errors.cu")], capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    fn = lib.usm_window_attention_v1_bf16
    fn.argtypes = [_lib.P] * 13 + [_lib.I] * 14 + [_lib.F, _lib.F, _lib.P]
    lib.usm_v1_clocks.argtypes = [_lib.P, _lib.P, _lib.I]

    g = torch.Generator(device="cuda").manual_seed(c.SEED)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    for (hp, cin, nh, co, ws, pool, real), _ in c.V1_SHAPES:
        for ln in (not pool, pool):
            a = c.v1_args(rn, 1, hp, cin, nh, co, real)
            x = a[0]
            p = v1.plan_for(1, hp, hp, ws, nh, pool, cin, co, ln)
            side = hp // ws * (ws // 2 if pool else ws)
            o = torch.empty(1, side, side, nh * c.HD, dtype=torch.bfloat16, device="cuda")
            out = torch.empty(1, side, side, co, dtype=torch.bfloat16, device="cuda")

            def call():
                _lib.check(fn(x.data_ptr(), *(t.data_ptr() for t in a[1:]), o.data_ptr(), out.data_ptr(), 1, hp, hp,
                              cin, nh, c.HD, co, ws, int(pool), int(ln), p.g, p.c, p.rows, p.nt, 1e-6, c.HD**-0.5,
                              _lib.stream_ptr(x)), "stamped window_attention_v1")
                return out

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            _lib.check(lib.usm_v1_clear_waits(), "clear")
            call()
            torch.cuda.synchronize()
            blocks = -(-(hp // ws) ** 2 // p.g) * nh * p.c
            clk = torch.zeros(blocks * 8, dtype=torch.int64)
            wait = torch.zeros(blocks, dtype=torch.int64)
            _lib.check(lib.usm_v1_clocks(clk.data_ptr(), wait.data_ptr(), blocks), "clocks")
            ok, msg, _ = c.agreement(out, v1.window_attention_v1_plain(*a, ws, pool, ln, 1e-6), attention=True)
            stamps = clk.reshape(blocks, 8)[:, :7].double()
            mean = stamps.mean(0)
            steps = [mean[0].item()] + [(mean[i] - mean[i - 1]).item() for i in range(1, 7)]
            print(f"{hp}^2 C{cin} nh{nh} ws{ws} pool={pool} ln_inside={ln} plan {tuple(p)} "
                  f"({'ok' if ok else 'FAIL: ' + msg}): " + ", ".join(f"{n} {s:.0f}" for n, s in zip(PHASES, steps))
                  + f"; slowest block {stamps[:, 6].max().item():.0f} cycles; pass waits "
                  f"{wait.double().mean().item():.0f}; device ms {c.device_ms(call):.4f}", flush=True)
    print(c.card_line(), f"SM clock max {c.sm_clock_hz() / 1e6:.0f} MHz", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
