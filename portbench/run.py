#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vpp_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``<cell>`` is a name under ``workloads`` in ``BENCHMARK.json``. The run
needs a CUDA card and exits with a non-zero code, printing no result,
without one. Its last line on standard output is one JSON object (the
end-to-end metrics with ``--trace 0``, the per-layer ones with ``--trace
1``); its last lines on standard error are the numbers that decide
``correct``, each beside its limit.
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``), so that set-up counts the interpreter's start."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = _process_age_s()

if __name__ == "__main__":
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    sys.path.insert(0, ROOT)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START - AGE_AT_START))
