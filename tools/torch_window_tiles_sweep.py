#!/usr/bin/env python3
"""Device time of the window-attention kernel over its grid (one GPU).

    PYTHONPATH=. python3 tools/torch_window_tiles_sweep.py [--warps 1 2 4 8]

At each geometry the serving and training paths give the kernel
(chip_smoke.py's WIN_SHAPES at batch 1 and at the training path's batch 4,
hd 96, and WIN64_SHAPES at hd 64, each with the last-strip cut where the map
is padded, as the models call it), with seeded inputs: for every count of
warps a block in ``--warps`` (shared memory permitting), the output held
against the plain version at chip_smoke.py's attention tolerance and the
same bits as ``window_tiles``' pick, the blocks of the grid and the blocks
an SM holds (``blocks_per_sm``), and the device time per call from
torch.profiler's kernel events. The pick of ``window_tiles`` is marked.
Prints one line per (geometry, warps), then the card's name and power limit.
Needs a CUDA device; about a minute.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)

    import torch

    from us_video_medsam2_tpu_torch.kernels import window_attention as wa

    if not torch.cuda.is_available():
        print("torch_window_tiles_sweep: no CUDA device", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = ([(cs.HD, b, s) for b in (1, cs.TRAIN_T) for s, _ in cs.WIN_SHAPES]
             + [(cs.HD_VIT, 1, s) for s, _ in cs.WIN64_SHAPES])
    for hd, b, (hp, ws, nh, pool, real) in cases:
        qkv = (torch.randn(b, hp, hp, 3 * nh * hd, generator=g, device="cuda")).to(torch.bfloat16)
        real_h = real if real < hp else None
        want = wa.window_attention_plain(qkv, ws, nh, pool, real_h)
        pick = wa.window_tiles(b, hp, hp, ws, nh, hd, pool, real_h)
        ref = wa._kernel(qkv, ws, nh, pool, real_h, pick)
        q_lq = wa.cut_query_rows(hp, ws, pool, real_h)
        for w in args.warps:
            if wa.smem_bytes(hd, ws, w) > wa.SMEM_PER_BLOCK:
                continue
            got = wa._kernel(qkv, ws, nh, pool, real_h, w)
            ok, msg, _ = cs.agreement(got, want, attention=True)
            if not ok or not torch.equal(got, ref):
                raise AssertionError(f"hd {hd} B{b} {hp}^2 ws{ws} nh{nh} warps {w}: {msg}, "
                                     f"same bits as the pick: {torch.equal(got, ref)}")
            blocks = sum(r["blocks"] for r in wa.grid(b, hp, hp, ws, nh, pool, q_lq, w))
            held = wa.blocks_per_sm(hd, ws, w)
            dev = cs.device_ms(lambda: wa._kernel(qkv, ws, nh, pool, real_h, w))
            mark = " <- window_tiles" if w == pick else ""
            print(f"hd {hd} B{b} {hp}^2 ws{ws} nh{nh} pool={pool} real_h={real_h} warps {w}: "
                  f"{blocks:5d} blocks, {held} an SM, device {dev:.4f} ms a call{mark}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
