"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Stages: the driver of the cell's traffic mix seeds the weights on the card,
warms up the cell's own shapes, measures for `--seconds`, frees the
program and has the plain reference judge what the timed path produced.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number beside its limit; the same
numbers close standard error. Without a CUDA device, or with fewer than
the cell asks for, the run exits 2 and prints no result; a run after which
JAX or the JAX package is loaded exits 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "clipcap_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc, boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _entry(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic mix (as
    parsed from their files), its limits, the run's arguments and the
    device, and a clock for the window."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_process: float = 0.0  # time.perf_counter() at process start
    setup_s: Optional[float] = None
    control_bits: Optional[int] = None  # benchmark/tools/control.py: judge the control too

    def window_opens(self, at: Optional[float] = None) -> float:
        """Mark the end of set-up, now or at the time.perf_counter() reading
        `at`; returns that reading."""
        now = time.perf_counter() if at is None else at
        self.setup_s = now - self.t_process
        return now


def load_cell(name: str) -> tuple:
    """(cell, config, traffic, limits) of the cell `name`, from BENCHMARK.json
    and the files it names."""
    man = manifest()
    cell = _entry(man["workloads"], name, "workload")
    cfg_entry = _entry(man["configs"], cell["config"], "config")
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    return cell, config, traffic, limits


def read_metric(name: str, rec: dict) -> Optional[float]:
    """The per-layer metric `name` from its reader benchmark/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: end-to-end ones, or per-layer
    ones with --trace 1; an entry without `workloads` holds for every cell."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in man[key] if "workloads" not in m or cell in m["workloads"]]


def run_cell(ctx: Context) -> Dict[str, Any]:
    """Drive the cell once and assemble its result (no device checks here)."""
    driver = importlib.import_module(f"benchmark.drivers.{ctx.traffic['driver']}")
    rec = driver.run(ctx)
    rec["setup_s"] = ctx.setup_s
    man = manifest()
    metrics = {}
    for m in cell_metrics(man, ctx.cell["name"], ctx.trace):
        if ctx.trace:
            value = read_metric(m["name"], rec)
        else:
            value = ctx.setup_s if m["name"] == "setup_s" else rec["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in rec["checks"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": rec["card"]["kind"], "count": 1,
              "memory_peak_bytes": int(rec["memory_peak_bytes"]),
              "power_limit_w": rec["card"]["power_limit_w"]}
    out = {"correct": bool(correct), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics, "device": device}
    if ctx.trace and rec.get("trace"):
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    return out


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    t_process = time.perf_counter() - process_age_s()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell, config, traffic, limits = load_cell(args.workload)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "benchmark_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    ctx = Context(cell=cell, config=config, traffic=traffic, limits=limits, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), t_process=t_process)
    out = run_cell(ctx)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(out)
    return 0


def emit(out: Dict[str, Any]) -> None:
    """The card and each compared number beside its limit as the last lines
    of standard error, then the result as the last line of standard output."""
    print(f"card: {out['device']['kind']}, power limit {out['device']['power_limit_w']} W",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
