"""Readings that the correctness limits are set from, in one process.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6] [--seconds 2]

For each of ``--seeds`` one short run of the cell as the benchmark makes it
(the program's sound readings: the lower ends of the limits), then for each of
``--control-seeds`` the control (the reference under fp8 products in the
program's place: the upper ends). Prints one JSON line a reading, on the card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import common, faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--profile", action="store_true", help="print every compared frame's gap")
    ap.add_argument("--fault", default="", help="a fault of perfbench/faults.py planted in the program's runs")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.benchmark()
    harness.cuda_devices(int(harness.cell_entry(bench, args.workload)["chips"]))
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            ctx = harness.context(args.workload, seed, args.seconds, False, "cuda", time.perf_counter(), bench)
            ctx.limits = {}  # every number, whichever the cell compares
            drv = harness.driver(ctx.traffic["kind"])
            if kind == "program":
                patches = faults.Patches()
                if args.fault:
                    {**faults.FAULTS, **faults.PROBES}[args.fault](patches, args.workload)
                try:
                    run = drv.run(ctx)
                finally:
                    patches.undo()
            else:
                run = harness.Run()
                common.compare(run, {}, *drv.control(ctx))
            checks = {name: value for name, value, _ in run.checks}
            line = {"cell": args.workload, "kind": kind, "seed": seed, "fault": args.fault or None, **checks}
            if args.profile:  # each request's frames' rms gaps (the program's, the bf16 reference's)
                line["norms"] = [g.reshape(-1, g.shape[-2], 2).tolist() for g in run.gaps]
            print(json.dumps(line), flush=True)
            common.free("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
