"""What the port's own tracer costs, and what it reads, in one cell.

    python3 -m benchmark.tools.trace_overhead --workload <cell> --seed <n> \
        [--seconds 20] [--rounds 4] [--profile 1] [--out_json PATH]

The cell's module in benchmark/drivers/ builds the program once, with the
port's tracer (clipcap_tpu_torch/utils/profiling.py) on from before the
build to the end of the set-up. Then the cell's window runs `--rounds` times in one
process, the tracer off, on, on, off, and so on (the CUDA profiler off
throughout), so both sides share the card, the build and the warm caches.
Each round reports the cell's end-to-end metric and, for serving, the
engine's host ms per step ((dispatch + refill dispatch) / steps over the
round's serve calls). The rounds with the tracer on also give the
readings of benchmark/program_spans.py (`READERS`) and, at a fixed rate,
the largest difference per request between the program's assigned -
arrival and the harness's latency - `latency_s`. With `--profile 1` a last
round runs with the tracer and the CUDA profiler on, and splits the card's
idle time by the innermost program span the host was in. The summary also
gives the host cost of recording one span (two clock reads and an append),
timed alone, which bounds the tracer's own cost per decode step below the
noise of the rounds.

The benchmark's command does not run this tool. The last line of standard
output is the JSON summary; `--out_json` writes it to a file as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np

from .. import device as D
from .. import program_spans as PS
from .. import run as B
from .. import traffic as T
from ..drivers import beam as BD
from ..drivers import serve as SD


class StampedArrivals(SD.Arrivals):
    """benchmark/drivers/serve.py's Poisson stream, each request stamped
    with its scheduled due time as `arrival_ns`."""

    def _hand(self, now):
        req = super()._hand(now)
        return dataclasses.replace(req, arrival_ns=int(round(self.due[req.request_id] * 1e9)))


def _backlog_round(ctx, engine, pool, caps, program):
    """One backlog window, by benchmark/drivers/serve.py's rule: from the
    first harvest after the warm-up to a harvest --seconds or more later,
    an even number of harvests apart."""
    mix = ctx.traffic
    stream, done, win = SD.Backlog(caps, len(pool)), {}, {}
    t_serve = time.perf_counter()

    def on_result(rid, res):
        t = time.perf_counter()
        done[rid] = (t, res)
        if "open" not in win and t >= t_serve + mix["warm_s"]:
            win["open"] = t
            stream.stop = t + ctx.seconds + mix["close_slack_s"]

    engine.serve(stream, seed=ctx.seed, prefix_pool=pool, on_result=on_result,
                 admission=mix["admission"])
    hv = SD.harvests(done)
    k0 = max(k for k, (t, _) in enumerate(hv) if t <= win["open"])
    k1 = next((k for k, (t, _) in enumerate(hv)
               if t >= win["open"] + ctx.seconds and (k - k0) % 2 == 0),
              k0 + 2 * ((len(hv) - 1 - k0) // 2))
    t_open, t_close = hv[k0][0], hv[k1][0]
    n = sum(len(ids) for _, ids in hv[k0 + 1: k1 + 1])
    st = engine.last_stats
    program.update(t_open_ns=int(t_open * 1e9), t_close_ns=int(t_close * 1e9))
    return {"captions_per_s": n / (t_close - t_open),
            "host_ms_per_step": 1e3 * (st["dispatch_s"] + st["refill_dispatch_s"]) / st["steps"]}


def _rate_round(ctx, engine, pool, caps, program):
    """One fixed-rate window: arrivals over the warm-up and --seconds, the
    window's requests timed from their scheduled arrival to their harvest,
    served as `serve_arrivals` serves them."""
    mix = ctx.traffic
    t0 = time.perf_counter()
    offsets = T.poisson_arrivals(mix["rate"], mix["warm_s"] + ctx.seconds, ctx.seed)
    stream, done = StampedArrivals(caps, len(pool), t0, offsets), {}
    host_s, steps, serves = 0.0, 0, 0
    while stream.i < len(stream.due):
        engine.serve(stream, seed=ctx.seed + serves, prefix_pool=pool, admission=mix["admission"],
                     on_result=lambda rid, res: done.__setitem__(rid, (time.perf_counter(), res)))
        serves += 1
        st = engine.last_stats or {"dispatch_s": 0.0, "refill_dispatch_s": 0.0, "steps": 0}
        host_s += st["dispatch_s"] + st["refill_dispatch_s"]
        steps += st["steps"]
        if stream.i < len(stream.due):
            time.sleep(max(0.0, stream.due[stream.i] - time.perf_counter()))
    t_open = t0 + mix["warm_s"]
    ids = [i for i in range(len(stream.due)) if t_open <= stream.due[i] < t_open + ctx.seconds]
    lat = [done[i][0] - stream.due[i] if i in done else np.inf for i in ids]
    program.update(t_open_ns=int(t_open * 1e9), t_close_ns=int((t_open + ctx.seconds) * 1e9),
                   window_ids=ids)
    out = {"latency_p95_s": float(np.percentile(lat, 95)), "host_ms_per_step": 1e3 * host_s / steps,
           "serve_calls": serves}
    tr = program.get("tracer")
    if tr is not None:  # the program's assigned - arrival against the harness's wait
        admit = {s.request_id: s for s in tr.intervals if s.name == "serving.request.admit"}
        queued = {s.request_id: s for s in tr.intervals if s.name == "serving.request.queued"}
        diffs = [abs((admit[i].end_ns - queued[i].start_ns) / 1e9
                     - (done[i][0] - stream.due[i] - done[i][1]["latency_s"]))
                 for i in ids if i in done]
        out["assigned_wait_max_diff_s"] = max(diffs) if len(diffs) == len(ids) else None
    return out


def _beam_round(ctx, bundle, batches, program):
    """One beam window: caption_pixels calls back to back for --seconds."""
    from clipcap_tpu_torch.cli import infer

    mix = ctx.traffic
    kw = dict(use_beam_search=True, beam_size=mix["beam_size"], entry_length=mix["max_new_tokens"],
              beam_image_batch=mix["images"])
    t0 = time.perf_counter()
    calls = 0
    while True:
        infer.caption_pixels(bundle, None, batches[calls % len(batches)], **kw)
        calls += 1
        if time.perf_counter() >= t0 + ctx.seconds:
            break
    t1 = time.perf_counter()
    program.update(t_open_ns=int(t0 * 1e9), t_close_ns=int(t1 * 1e9), calls=calls,
                   beam_steps=mix["max_new_tokens"] - 1)
    return {"captions_per_s": calls * mix["images"] / (t1 - t0), "calls": calls}


def span_cost_ns(n: int = 200_000) -> float:
    """Host ns to time and record one call-stack span, as the engine's step
    tiles do (a clock read and `Tracer.add`), on a tracer of its own."""
    from clipcap_tpu_torch.utils import profiling as P

    tr, now = P.Tracer(), P.now_ns
    t0 = now()
    for _ in range(n):
        t = now()
        tr.add("serving.step.lm", t, now())
    return (now() - t0) / n


def measure(ctx, rounds: int = 4, profile: bool = False) -> dict:
    """Build the cell's program with the tracer on, run its window `rounds`
    times alternating off, on, on, off, then optionally a profiled round;
    returns the summary."""
    import torch

    from clipcap_tpu_torch.utils import profiling as P

    on_card = ctx.device == "cuda"
    serving = ctx.traffic["driver"] == "serve"
    with P.tracing() as setup:
        built = SD.build(ctx) if serving else BD.build(ctx)
    if serving:
        bundle, pool, engine = built
        caps = T.seeded_caps(ctx.traffic, ctx.seed)
        window = _backlog_round if ctx.traffic["arrivals"] == "backlog" else _rate_round
        go = lambda program: window(ctx, engine, pool, caps, program)  # noqa: E731
    else:
        bundle, batches = built
        from clipcap_tpu_torch.cli import infer

        infer.caption_pixels(bundle, None, batches[0], use_beam_search=True,
                             beam_size=ctx.traffic["beam_size"],
                             entry_length=ctx.traffic["max_new_tokens"],
                             beam_image_batch=ctx.traffic["images"])  # warm-up
        go = lambda program: _beam_round(ctx, bundle, batches, program)  # noqa: E731
    if on_card:
        torch.cuda.synchronize()
    setup_s = {n: q["total_s"] for n, q in setup.summary().items()}
    out = {"cell": ctx.cell["name"], "seed": ctx.seed, "seconds": ctx.seconds,
           "setup_spans_s": setup_s,
           "kernels_built": sorted(s.attrs["kernel"] for s in setup.named("kernels.build")),
           "bundle.init_s.setup": PS.bundle_init_s({"tracer": setup,
                                                   "t_open_ns": time.perf_counter_ns()}),
           "span_cost_ns": span_cost_ns(), "rounds": []}
    for k in range(rounds):
        traced = k % 4 in (1, 2)
        program = {"tracer": P.start()} if traced else {}
        try:
            res = go(program)
        finally:
            P.stop()
        res["tracer"] = traced
        if traced:
            tr = program["tracer"]
            res["spans"] = len(tr.spans) + len(tr.intervals)
            res["readings"] = {name: PS.READERS[name](program)
                               for name, cells in PS.CELLS.items()
                               if ctx.cell["name"] in cells and name != "bundle.init_s.setup"}
        out["rounds"].append(res)
        print(f"round {k} tracer {'on' if traced else 'off'}: {res}", file=sys.stderr)
    key = "latency_p95_s" if "latency_p95_s" in out["rounds"][0] else "captions_per_s"
    for side in ("off", "on"):
        vals = [r[key] for r in out["rounds"] if r["tracer"] == (side == "on")]
        out[f"{key}.{side}"] = statistics.median(vals) if vals else None
        hosts = [r["host_ms_per_step"] for r in out["rounds"]
                 if r["tracer"] == (side == "on") and "host_ms_per_step" in r]
        out[f"host_ms_per_step.{side}"] = statistics.median(hosts) if hosts else None
    if profile and on_card:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        marker = D.launch_marker()
        program = {"tracer": P.start()}
        try:
            res = go(program)
        finally:
            tr = P.stop()
        torch.cuda.synchronize()
        prof.stop()
        gaps, busy_s = PS.device_gaps(prof, marker, program["t_open_ns"], program["t_close_ns"])
        window_s = (program["t_close_ns"] - program["t_open_ns"]) / 1e9
        t0, t1 = program["t_open_ns"], program["t_close_ns"]
        inside = [s for s in tr.spans if s is not None and s.end_ns > t0 and s.start_ns < t1]
        out["profiled"] = {**res, "busy_s": busy_s, "window_s": window_s,
                           "idle_s_by_span": PS.idle_by_span(gaps, inside)}
        print(f"profiled round: {out['profiled']}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--profile", type=int, choices=(0, 1), default=1)
    p.add_argument("--out_json", default=None, help="also write the summary here")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_overhead: no CUDA device", file=sys.stderr)
        return 2
    cell, config, traffic, limits = B.load_cell(args.workload)
    ctx = B.Context(cell=cell, config=config, traffic=traffic, limits=limits, seed=args.seed,
                    seconds=args.seconds, trace=False)
    out = measure(ctx, rounds=args.rounds, profile=bool(args.profile))
    out["card"] = D.card()
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
