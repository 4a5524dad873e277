#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, the
cell's set-up, ``--calls`` timed calls, and the numbers that decide
``correct`` for the program and, with ``--control``, for the control (the
reference in the nearest precision below the configuration's, in the
program's place). One JSON line a seed, all seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        --calls 20 [--control] [--witness]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(workload: str, seeds, calls: int, control: bool, dev,
             overrides=None, witness: bool = False):
    """Yield {seed, program, control, float32} for each seed (the last
    two as asked)."""
    import torch
    from portbench import harness
    _, _, traffic, config = harness.load_cell(workload)
    overrides = overrides or {}
    traffic = {**traffic, **overrides.get("traffic", {})}
    config = {**config, **overrides.get("config", {})}
    drv = harness.driver_of(config)
    for seed in seeds:
        t0 = time.perf_counter()
        job = drv.setup(config, traffic, seed, dev)
        for i in range(calls):
            job.call(i)
        row = {"seed": seed, "setup_and_calls_s": time.perf_counter() - t0,
               "program": job.readings()}
        if control:
            row["control"] = job.readings("control")
        if witness:
            row["float32"] = job.readings("float32")
        del job
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        yield row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true",
                    help="BA cells: the reference in plain float32 too")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    for row in readings(args.workload, args.seeds, args.calls, args.control,
                        torch.device("cuda", 0), witness=args.witness):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
