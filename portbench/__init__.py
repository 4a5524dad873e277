"""The benchmark of ``vpp_tpu_torch`` on one H100: cells, traffic,
drivers, per-layer readers, operation counts, inputs and the plain
reference, all found by the names in ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""
