"""The port's benchmark: one online fleet session per run, its cells
described as data (`BENCHMARK.json`, `configs/`, `traffic/`, `limits/`,
`metrics/`). Run one cell once with

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""
