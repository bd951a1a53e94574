#!/usr/bin/env python3
"""Device time of the ln_mlp_residual kernel over its number of hidden splits (one GPU).

    PYTHONPATH=. python3 tools/torch_mlp_splits_sweep.py [--splits 1 2 4 8 9 16 17]

At each (N, D, F) the main path and the training path give the kernel
(chip_smoke.py's MLP_SHAPES, and 4x their tokens), with seeded inputs: for
every split count S that the shape admits (at most one split per hidden
chunk), the kernel's output held against its plain version at chip_smoke.py's
tolerance, and its device time per call (both kernels: the products and, for
S > 1, the combine) from torch.profiler's kernel events. The pick of
``mlp_splits`` is marked. Prints one line per (shape, S), then the card's name
and power limit. Needs a CUDA device; about a minute.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3, 4, 6, 8, 9, 12, 16, 17, 24, 32])
    args = ap.parse_args(argv)

    import torch

    from us_video_medsam2_tpu_torch.kernels import ln_mlp_residual as m

    if not torch.cuda.is_available():
        print("torch_mlp_splits_sweep: no CUDA device", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    shapes = [s for s, _ in cs.MLP_SHAPES]
    for n, d, f in shapes + [(cs.TRAIN_T * n, d, f) for n, d, f in shapes]:
        inputs = cs.mlp_args(rn, n, d, f)
        want = m.ln_mlp_residual_plain(*inputs)
        pick = m.mlp_splits(n, d, f)
        tiles = -(-n // m.BLOCK_M[d])
        for s in sorted(set(args.splits) | {pick}):
            if s > f // m.HIDDEN_CHUNK[d]:
                continue
            ok, msg, _ = cs.agreement(m._kernel(*inputs, 1e-6, s), want, attention=False)
            if not ok:
                raise AssertionError(f"({n},{d},{f}) with {s} splits: {msg}")
            dev = cs.device_ms(lambda: m._kernel(*inputs, 1e-6, s))
            mark = " <- mlp_splits" if s == pick else ""
            print(f"({n},{d},{f}) S {s:3d}: {tiles * s:4d} blocks, device {dev:.4f} ms a call{mark}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
