#!/usr/bin/env python3
"""Where a CXBlock kernel call's time goes: the clock of each phase of its blocks (one GPU).

    PYTHONPATH=. python3 tools/torch_cxblock_phases.py [--splits 4 6 8] [--source FILE]

Builds a copy of ``us_video_medsam2_tpu_torch/csrc/cxblock.cu`` (or of a
variant of it, ``--source``, to see where a change moves the time) with
``clock64()`` stamps inserted at the kernel's phase boundaries (into
``build/cxblock_phases/``, with the port's nvcc flags), and runs it at [1, 32,
32, 256] at each number of ``--splits`` and at [3, 32, 32, 256] with
``plan_for``'s pick, seeded inputs (chip_smoke.cxblock_args). Thread 0 of
every block records SM cycles from the kernel's start to the end of: the
depthwise conv (of which: until its first pass's halo and taps have landed,
with the first weights in flight behind them), the exchange of
the channel shares and cluster barrier 2, LayerNorm, the products (thread 0's
last chunk; also the cycles it spent waiting for its copies and the block
barrier), the push of the partials and cluster barrier 3, the epilogue.
Prints, per call, the output's agreement with the plain version, its device
ms (torch.profiler), and the mean cycles of each phase over the blocks; then
the card's name, power limit and SM clock. The stamps cost a few registers;
the device ms beside them is the stamped kernel's.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

PHASES = ("conv", "exchange + barrier 2", "LayerNorm", "products", "push + barrier 3", "epilogue")
# (anchor in the source, text put before it); each anchor must occur once
STAMPS = [
    ("  if (splits > 1) {\n    cluster_wait();  // barrier 1", "  STAMP(1)\n"),
    ("  // 2. LayerNorm in place", "  STAMP(2)\n"),
    ("  // 3. the rank's chunks", "  STAMP(3)\n"),
    ("  // 4. each f32 partial", "  STAMP(4)\n"),
    ("  // 5. the owner's columns", "  STAMP(5)\n"),
]


def instrument(src: str) -> str:
    def once(text, anchor, new):
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} found {text.count(anchor)} times in cxblock.cu")
        return text.replace(anchor, new)

    src = once(src, "int splits, float eps) {",
               "int splits, float eps, long long* __restrict__ clk) {\n"
               "  const long long t_start = clock64();\n  long long t_wait = 0;\n"
               "#define STAMP(k) if (threadIdx.x == 0) clk[blockIdx.x * 8 + (k)] = clock64() - t_start;\n")
    for anchor, before in STAMPS:
        src = once(src, anchor, before + anchor)
    src = once(src, "  cp_wait<NS - 1>();  // the first pass has landed\n  __syncthreads();\n",
               "  cp_wait<NS - 1>();  // the first pass has landed\n  __syncthreads();\n  STAMP(0)\n")
    src = once(src, "    cp_wait<NS - 2>();  // entry e has landed",
               "    const long long t_w0 = clock64();\n    cp_wait<NS - 2>();  // entry e has landed")
    src = once(src, "    __syncthreads();    // for every warp; every warp is done",
               "    __syncthreads(); t_wait += clock64() - t_w0;  // for every warp; every warp is done")
    src = once(src, "}\n\ncudaLaunchConfig_t config",
               "  __syncthreads();\n  STAMP(6)\n  if (threadIdx.x == 0) clk[blockIdx.x * 8 + 7] = t_wait;\n}\n\n"
               "cudaLaunchConfig_t config")
    src = once(src, "float eps, void* stream) {", "float eps, void* stream, void* clk) {")
    return once(src, "splits, eps);\n  if (e != cudaSuccess) return e;",
                "splits, eps, static_cast<long long*>(clk));\n  if (e != cudaSuccess) return e;")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[4, 6, 8], help="splits timed at B 1")
    ap.add_argument("--source", type=Path, help="a variant of csrc/cxblock.cu to clock instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_cxblock_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from us_video_medsam2_tpu_torch.kernels import _lib
    from us_video_medsam2_tpu_torch.kernels import cxblock as cx

    out_dir = _lib.BUILD_DIR / "cxblock_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "cxblock_phases.cu"
    src.write_text(instrument((args.source or _lib.CSRC / "cxblock.cu").read_text()))
    print(f"clocking {args.source or 'csrc/cxblock.cu'}")
    so = out_dir / "libcxblock_phases.so"
    r = subprocess.run([_lib.nvcc_path(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared", "-o", str(so),
                        str(src)], capture_output=True, text=True)
    print((r.stdout + r.stderr).strip()[-2000:])
    if r.returncode != 0:
        return 1
    fn = ctypes.CDLL(str(so)).usm_cxblock_bf16
    fn.argtypes = [_lib.P] * 11 + [_lib.I] * 6 + [_lib.F, _lib.P, _lib.P]
    fn.restype = ctypes.c_int

    g = torch.Generator(device="cuda").manual_seed(c.SEED)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    calls = [((1, 32, 32), s) for s in args.splits]
    calls.append(((c.TRAIN_OBJECTS, 32, 32), cx.plan_for(c.TRAIN_OBJECTS, 32, 32)))
    for (b, h, w), splits in calls:
        a = c.cxblock_args(rn, b, h, w)
        out = torch.empty_like(a[0])
        blocks = cx.tiles(b, h, w) * splits
        clk = torch.zeros(blocks * 8, dtype=torch.int64, device="cuda")

        def call():
            _lib.check(fn(*[t.data_ptr() for t in a], out.data_ptr(), b, h, w, a[0].shape[-1], a[5].shape[0],
                          splits, 1e-6, _lib.stream_ptr(a[0]), clk.data_ptr()),
                       "stamped cxblock")

        dev = c.device_ms(call)
        ok, msg, _ = c.agreement(out, cx.cxblock_plain(*a), attention=False)
        k = clk.view(blocks, 8).cpu().double()
        ends = k[:, 1:7]
        spans = torch.cat([ends[:, :1], ends[:, 1:] - ends[:, :-1]], 1).mean(0).tolist()
        print(f"[{b}, {h}, {w}, 256] {splits} splits: {'agrees' if ok else 'DISAGREES'} ({msg}); "
              f"device {dev:.4f} ms; mean cycles a block: "
              + ", ".join(f"{name} {v:.0f}" for name, v in zip(PHASES, spans))
              + f" (of the conv, until the first pass landed {k[:, 0].mean():.0f})"
              + f"; total {ends[:, -1].mean():.0f} (max {ends[:, -1].max():.0f}); "
              f"waiting in the products {k[:, 7].mean():.0f}", flush=True)
        if not ok:
            return 1
    print(c.card_line())
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60)
    print(f"SM clock (current, max): {clocks.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
