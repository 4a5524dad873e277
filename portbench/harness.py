"""One run of one cell: set-up, the measured window, the traced window's
reduction, the comparison that decides ``correct``, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``configs/<config>.json`` names its driver
(``drivers/<driver>.py``), ``traffic/<cell>.json`` holds the cell's
parameters, and ``metrics/<metric>.py`` reads one per-layer metric from
the traced window (``metrics/<base>.py`` for a metric ``<base>.<part>``
that has no file of its own: one quantity split by the end-to-end metric
it moves). A driver module has ``setup(config, traffic, seed,
device)``, which returns a job with:

* ``call(i)``: the ``i``-th timed call, returned once its result is ready
  (the caller waits for each result: a closed loop, one caller);
* ``steps_per_call``: the steps a per-layer metric divides by;
* ``end_to_end(window_s, calls, call_s)``: ``{name: (value, unit)}``
  from the window's length, its whole calls and each call's seconds on
  the host's clock;
* ``check()``: after the window, ``[(name, value, limit)]``: the numbers
  that decide ``correct``, a value over its limit (or NaN) failing.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench.trace import SPAN

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules that no process of the benchmark may load
BANNED = ("jax", "jaxlib", "flax", "vpp_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str) -> Tuple[dict, dict, dict, dict]:
    """(manifest, its workload entry, the traffic file, the config
    file) of the cell ``name``. A cell whose traffic file is there but
    that the manifest does not list (one kept for a later benchmark) runs
    on one card with ``configs/<its config>.json``; ``FileNotFoundError``
    for a cell with no traffic file."""
    man = manifest()
    with open(BENCH / "traffic" / f"{name}.json") as f:
        traffic = json.load(f)
    cells = {w["name"]: w for w in man["workloads"]}
    cell = cells.get(name, {"name": name, "config": traffic["config"],
                            "chips": 1})
    confs = {c["name"]: c for c in man["configs"]}
    path = ROOT / confs[cell["config"]]["file"] if cell["config"] in confs \
        else BENCH / "configs" / f"{cell['config']}.json"
    with open(path) as f:
        config = json.load(f)
    return man, cell, traffic, config


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else
    that of the part of its name before the first dot."""
    own = BENCH / "metrics" / f"{metric}.py"
    return own if own.is_file() else BENCH / "metrics" / \
        f"{metric.split('.')[0]}.py"


def driver_of(config: dict):
    return load_module(BENCH / "drivers" / f"{config['driver']}.py",
                       f"portbench_driver_{config['driver']}")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def check_lines(checks) -> Tuple[bool, Dict[str, dict], List[str]]:
    """(all passed, the result line's entries, the standard-error lines)
    of ``[(name, value, limit)]``; a NaN value fails."""
    ok_all, entries, lines = True, {}, []
    for name, value, limit in checks:
        value = float(value)
        ok = not math.isnan(value) and value <= limit
        ok_all &= ok
        entries[name] = {"value": value, "limit": limit, "ok": ok}
        lines.append(f"check {name}: {value!r} <= {limit!r} "
                     f"{'ok' if ok else 'FAILED'}")
    return ok_all, entries, lines


def window(torch, job, seconds: float, trace_calls: Optional[int]):
    """The measured window: calls back to back until ``seconds`` have
    passed (with ``trace_calls``, under the profiler and at most that many
    calls). Returns (calls, window seconds, profiler or None, each call's
    seconds)."""
    prof = None
    if trace_calls is not None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    n = 0
    t0 = time.perf_counter()
    ends = []
    try:
        while True:
            if prof is not None:
                with torch.profiler.record_function(SPAN + "call"):
                    job.call(n)
            else:
                job.call(n)
            n += 1
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if elapsed >= seconds or (trace_calls is not None
                                      and n >= trace_calls):
                break
    finally:
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    return n, window_s, prof, [b - a for a, b in zip([0.0] + ends, ends)]


def _spread(values: List[float]) -> dict:
    """The calls' seconds: least, median, most (the window's own record,
    beside the metrics)."""
    v = sorted(values)
    return {"min": v[0], "median": v[len(v) // 2], "max": v[-1]}


def _progress(msg: str) -> None:
    print(f"portbench: {msg} ({time.strftime('%H:%M:%S')})", file=sys.stderr,
          flush=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_process_start: float) -> int:
    args = parse(argv)
    try:
        load_cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"portbench: unknown cell {args.workload!r} ({exc})",
              file=sys.stderr)
        return 2
    chips = load_cell(args.workload)[1]["chips"]
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result, lines = run(args, dev, t_process_start)
    found = banned_modules()
    if found:
        print(f"portbench: banned modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["device"]["power"] = power_limit()
    result["checks"] = result.pop("checks")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def run(args, dev, t_process_start: float, overrides=None):
    """Set-up, window and check of one cell on ``dev``: (the result line's
    object, the check lines for standard error). On a CPU device (the
    tests) the card's clocks and memory read nothing; ``overrides``
    ({"traffic": {...}, "config": {...}}) replaces top-level entries of
    the traffic and config files (the tests' sizes)."""
    import torch
    man, cell, traffic, config = load_cell(args.workload)
    overrides = overrides or {}
    traffic = {**traffic, **overrides.get("traffic", {})}
    config = {**config, **overrides.get("config", {})}
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    job = driver_of(config).setup(config, traffic, args.seed, dev)
    sync()
    setup_s = time.perf_counter() - t_process_start
    _progress(f"set-up done at {setup_s:.3f} s")

    trace_calls = int(traffic["trace_calls"]) if args.trace else None
    calls, window_s, prof, call_s = window(torch, job, args.seconds,
                                           trace_calls)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    _progress(f"window done: {calls} calls in {window_s:.3f} s")

    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": False, "attempted": calls, "failed": 0,
              "call_s": _spread(call_s)}
    breakdown = None
    if args.trace:
        from portbench import trace as trace_mod
        tr = trace_mod.reduce(prof, window_s, calls, job.steps_per_call)
        del prof
        metrics = {}
        for m in man["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            reader = load_module(reader_path(m["name"]),
                                 f"portbench_metric_{m['name']}")
            value = reader.read(tr, job)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        breakdown = tr.breakdown()
        _progress(f"trace read: {len(tr.ops)} device operations")
    else:
        e2e = job.end_to_end(window_s, calls, call_s)
        e2e["setup_s"] = (setup_s, "s")
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": e2e[m["name"]][1]}
                   for m in man["end_to_end"]
                   if args.workload in m.get("workloads", [args.workload])}

    checks = job.check()
    del job
    sync()
    _progress("check done")
    ok, entries, lines = check_lines(checks)
    result.update(correct=ok, metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = entries
    return result, lines
