"""The benchmark of clipcap_tpu_torch on one NVIDIA H100.

One command runs one cell once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the checkout names the cells. A cell pairs
a configuration (`benchmark/configs/<config>.json`) with a traffic mix
(`benchmark/traffic/<traffic>.json`), and the mix names the driver
(`benchmark/drivers/<driver>.py`) that runs it. Each per-layer metric is
read by `benchmark/metrics/<metric>.py`. The plain reference that decides
`correct` lives in `benchmark/reference/` and imports nothing of the port.
"""
