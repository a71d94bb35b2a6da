"""Readings that set a cell's limits, on the card at the cell's own size.

For each seed it runs the cell once (a short window at the cell's load)
and prints one JSON line with every compared number. With `--bits 4` the
reference also judges the control on the same prompts and tokens: GPT-2
with its weights rounded to 4 bits, one step below the int8 the
configuration states, and its tokens are judged in the program's place.
With `--fault <name>` the run serves with that fault planted
(benchmark/tools/faults.py).

    python3 -m benchmark.tools.control --workload gpt2xl.serve_backlog \
        --seeds 11,12,13 --seconds 10 [--bits 4] [--fault token]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run as B
from benchmark.tools.faults import FAULTS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="limit readings of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--bits", type=int, default=None, help="the control's weight bits")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell, config, traffic, limits = B.load_cell(args.workload)
    undo = FAULTS[args.fault]() if args.fault else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            ctx = B.Context(cell=cell, config=config, traffic=traffic, limits=limits, seed=seed,
                            seconds=args.seconds, trace=False, t_process=t0,
                            control_bits=args.bits)
            rec = __import__(f"benchmark.drivers.{traffic['driver']}",
                             fromlist=["run"]).run(ctx)
            line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                    "bits": args.bits, "correct": all(v <= lim for _, v, lim in rec["checks"]),
                    "checks": {n: [v, lim] for n, v, lim in rec["checks"]},
                    "verdict": rec.get("verdict"), "e2e": rec["e2e"], "setup_s": ctx.setup_s,
                    "card": rec["card"], "run_s": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    finally:
        if undo:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
