"""The knee of a Poisson-arrival serving cell: the highest rate it sustains
without a growing backlog, by one sweep on the card.

For each rate it runs the cell once with that rate in place of the mix's
and prints one JSON line: the latency p50 and p95, how late the stream
handed requests over (the backlog waiting for a free slot) in the first
and the last third of the window, the queue of requests due and not yet
handed over at seven points of the window, and how long the engine took
after the last arrival to finish. A backlog that grows shows as a last third far
later than the first and a drain that lengthens with the rate.

    python3 -m benchmark.tools.knee_sweep --workload gpt2xl.serve_rate \
        --rates 80,120,160,200 --seconds 30 --seed 7
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

from benchmark import run as B


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="knee sweep of a Poisson serving cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated arrivals per second")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from benchmark.drivers import serve

    cell, config, traffic, limits = B.load_cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(traffic)
        mix["rate"] = rate
        t0 = time.perf_counter()
        ctx = B.Context(cell=cell, config=config, traffic=mix, limits=limits, seed=args.seed,
                        seconds=args.seconds, trace=False, t_process=t0)
        rec = serve.run(ctx)
        st = rec["sweep"]
        late, due = np.asarray(st["late"]), np.asarray(st["due"])
        third = args.seconds / 3
        line = {"workload": args.workload, "rate": rate, "requests": len(late),
                "latency_p50_s": st["latency_p50_s"], "latency_p95_s": rec["e2e"]["latency_p95_s"],
                "late_p50_first_third_s": float(np.median(late[due < third])),
                "late_p50_last_third_s": float(np.median(late[due >= 2 * third])),
                "late_max_s": float(late.max()), "drain_after_last_arrival_s": st["drain_s"],
                "queue_at_s": st["queue_s"],
                "checks": {n: [v, lim] for n, v, lim in rec["checks"]}, "card": rec["card"]}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
