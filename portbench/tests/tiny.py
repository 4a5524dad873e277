"""Sizes at which a test drives a whole run of each cell on the CPU."""

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _slam():
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "slam_vga.json").read_text())
    return {"traffic": {"streams": 2, "frames": 24, "warm_frames": 8,
                        "follow_from": 20, "start_frames": 12,
                        "trace_calls": 1},
            "config": {"frame": {"height": 96, "width": 128},
                       "slam": dict(conf["slam"],
                                    intrinsics=[128.0, 128.0, 64.0, 48.0]),
                       "tracker": dict(conf["tracker"], capacity=256,
                                       detect_k=128),
                       "scene": dict(conf["scene"], points=400)}}


def overrides(cell: str) -> dict:
    if cell.startswith("slam_vga."):
        return _slam()
    return {"traffic": {"poses": 12, "landmarks": 600, "pool": 2,
                        "check_stride": 2, "trace_calls": 2}}


def run(cell: str, seed: int = 5, trace: int = 0):
    """(result object, check lines) of a whole run on the CPU."""
    import torch
    from portbench import harness
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", "0.5", "--trace", str(trace)])
    return harness.run(args, torch.device("cpu"), time.perf_counter(),
                       overrides(cell))
