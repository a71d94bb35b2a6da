"""Serving cells: clipcap_tpu_torch/cli/serve.py's `serve_shard` path.

Set-up builds the captioner bundle in bf16 from seeded weights, switches
on int8 decode (`CaptionerBundle.enable_int8_decode`), projects a shard of
seeded CLIP features into a prefix pool through `project_prefix` in blocks
of 512 rows, builds the engine with `make_serving_engine` at serve_shard's
settings and warms it up. The window drives `ServingEngine.serve` over a
lazy request stream:

- `"arrivals": "backlog"`: the stream always has a request ready, cycling
  over the pool with the mix's caps, until the window closes; captions
  harvested inside the window count, the drain after it does not.
- `"arrivals": "poisson"`: requests arrive on a schedule at `rate` per
  second drawn from the seed. The engine has no arrival API: the stream
  hands over only requests that are due (its `__next__` raises
  StopIteration while none is, and yields again later), and `serve`, which
  returns once nothing is due and nothing is in flight, is called again at
  the next arrival. Each request is timed from its scheduled arrival to
  its harvest on the harness's clock. A traced run profiles only a phase
  of its own after the window has drained (`traced_arrivals`), since the
  profiler slows the host below the rate.

After the window the engine drains; the run reads the memory peak, frees
the program and judges a sample of the finished requests, drawn from the
seed with the longest among them, against the plain reference
(benchmark/reference/serving.py). Every harvested request's length is also
checked against its cap and its stop.
"""

from __future__ import annotations

import gc
import importlib
import sys
import time

import numpy as np

from .. import device as D
from .. import flops as F
from .. import traffic as T
from .. import weights as W


def build(ctx):
    """The bundle (int8 decode switched on where the configuration says),
    its prefix pool and a warmed-up engine."""
    import torch

    from clipcap_tpu_torch.core.config import CaptionerConfig, MapperConfig
    from clipcap_tpu_torch.decode.engine import GenerationSettings
    from clipcap_tpu_torch.models.bundle import CaptionerBundle

    cfg, mix = ctx.config, ctx.traffic
    family = importlib.import_module(f"benchmark.families.{cfg['family']}")
    lm_cfg, lm_type, lm_variant = family.program_configs(cfg)
    cap_cfg = CaptionerConfig(lm_type=lm_type, lm_variant=lm_variant, visual_encoder_type="none",
                              mapper=MapperConfig(**cfg["mapper"]))
    bundle = CaptionerBundle.create(cap_cfg, lm_cfg, None, seed=ctx.seed, device=ctx.device,
                                    dtype=torch.bfloat16)
    state = W.make(W.captioner_layout(cfg), ctx.seed, ctx.device, torch.bfloat16)
    bundle.model.load_state_dict(state, strict=True)
    del state
    if cfg["decode"] == "int8":
        bundle.enable_int8_decode()
    feats = W.clip_features(mix["pool_rows"], cfg["mapper"]["dim_clip"], ctx.seed, ctx.device)
    pool = torch.cat([bundle.project_prefix(feats[i:i + 512]) for i in range(0, len(feats), 512)])
    del feats
    s = mix["settings"]
    settings = GenerationSettings(max_new_tokens=s["max_new_tokens"], top_p=s["top_p"],
                                  repetition_penalty=s["repetition_penalty"],
                                  eos_token_id=s["eos_token_id"], stop_token_id=s["stop_token_id"],
                                  filter_method=s["filter_method"])
    engine = bundle.make_serving_engine(settings, slots=mix["slots"], refill_size=None,
                                        steps_per_sync=mix["steps_per_sync"],
                                        max_request_length=None)
    engine.warmup()
    return bundle, pool, engine


class Backlog:
    """A request stream that is never empty until `stop` is set and passed."""

    def __init__(self, caps, n_pool: int):
        from clipcap_tpu_torch.decode.serving import Request

        self.Request, self.caps, self.n_pool = Request, caps, n_pool
        self.stop = float("inf")
        self.i = 0
        self.handed = {}

    def __iter__(self):
        return self

    def _hand(self, now):
        i = self.i
        self.i += 1
        self.handed[i] = now
        return self.Request(i, i % self.n_pool, max_length=int(self.caps[i % len(self.caps)]))

    def __next__(self):
        now = time.perf_counter()
        if now >= self.stop:
            raise StopIteration
        return self._hand(now)


class Arrivals(Backlog):
    """Requests handed over only once due: StopIteration while none is."""

    def __init__(self, caps, n_pool: int, t0: float, offsets):
        super().__init__(caps, n_pool)
        self.due = t0 + np.asarray(offsets)

    def __next__(self):
        now = time.perf_counter()
        if self.i >= len(self.due) or self.due[self.i] > now:
            raise StopIteration
        return self._hand(now)


def harvests(done: dict, gap_s: float = 0.05) -> list:
    """The harvests as [(time of its first result, [request ids])]: results
    handed back within gap_s of each other came from one harvest."""
    out = []
    for rid, (t, _) in sorted(done.items(), key=lambda kv: kv[1][0]):
        if out and t - out[-1][2] <= gap_s:
            out[-1][1].append(rid)
            out[-1][2] = t
        else:
            out.append([t, [rid], t])
    return [(t, ids) for t, ids, _ in out]


def instrument(engine, spans, on_dispatch):
    """Calls on_dispatch(stats) before every chunk the engine dispatches,
    with its `last_stats` counters as the serve call holds them so far
    (read in place from the call); with `spans`, spans around the engine's
    layers (dispatch, refill, harvest wait)."""
    import torch

    chunk = engine._chunk
    live = {}

    def timed_chunk(st, n):
        if "stats" not in live:
            live["stats"] = sys._getframe(1).f_locals.get("stats")
        on_dispatch(live["stats"])
        t0 = time.perf_counter_ns()
        try:
            return chunk(st, n)
        finally:
            if spans is not None:
                spans.add("serve.dispatch", t0, time.perf_counter_ns())

    engine._chunk = timed_chunk
    if spans is None:
        return
    spans.wrap(engine, "_refill", "serve.refill")
    harvestable = engine._harvestable

    class TimedEvent:
        def __init__(self, ev):
            self.ev = ev

        def synchronize(self):
            t0 = time.perf_counter_ns()
            self.ev.synchronize()
            spans.add("serve.harvest_wait", t0, time.perf_counter_ns())

    def timed_harvestable(packed):
        host, done = harvestable(packed)
        return host, (TimedEvent(done) if isinstance(done, torch.cuda.Event) else done)

    engine._harvestable = timed_harvestable


def start_profile():
    """A CUDA-only torch.profiler, started, and the clock marker launched
    under it."""
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof, D.launch_marker()


def serve_arrivals(engine, stream, pool, seed: int, on_result, admission: str) -> int:
    """Serve an `Arrivals` stream to its end: `serve` returns once nothing
    is due and nothing is in flight, and is called again at the next
    arrival. Returns the number of serve calls."""
    serves = 0
    while stream.i < len(stream.due):
        engine.serve(stream, seed=seed + serves, prefix_pool=pool, on_result=on_result,
                     admission=admission)
        serves += 1
        if stream.i < len(stream.due):
            time.sleep(max(0.0, stream.due[stream.i] - time.perf_counter()))
    return serves


def traced_arrivals(ctx, engine, pool, caps, on_card: bool):
    """The profiled phase of a traced Poisson run, after the measured window
    has drained: the profiler slows the host below the mix's rate, so the
    window's latencies and queue waits come from the untraced serving
    before it. The same arrivals are served again for the mix's warm-up
    and `trace_s` seconds under the profiler (on the card). Returns
    (profiler, marker, window start ns, window end ns), the profiler None
    off the card."""
    import torch

    mix = ctx.traffic
    prof, marker = start_profile() if on_card else (None, None)
    t0 = time.perf_counter()
    offsets = T.poisson_arrivals(mix["rate"], mix["warm_s"] + mix["trace_s"], ctx.seed)
    stream = Arrivals(caps, len(pool), t0, offsets)
    serve_arrivals(engine, stream, pool, ctx.seed, lambda rid, res: None, mix["admission"])
    if on_card:
        torch.cuda.synchronize()
        prof.stop()
    t_open = t0 + mix["warm_s"]
    return prof, marker, int(t_open * 1e9), int((t_open + mix["trace_s"]) * 1e9)


COUNTERS = ("steps", "live_slot_steps", "slot_steps", "dispatch_s", "refill_dispatch_s",
            "harvest_wait_s")


def run(ctx) -> dict:
    import torch

    from ..reference import serving as R

    mix, cfg = ctx.traffic, ctx.config
    on_card = ctx.device == "cuda"
    card = D.card() if on_card else {"kind": "cpu", "power_limit_w": None}
    bundle, pool, engine = build(ctx)
    caps = T.seeded_caps(mix, ctx.seed)
    n_pool = len(pool)
    done = {}
    spans = D.Spans()
    snaps = []  # (time, counters) before each chunk

    instrument(engine, spans if ctx.trace else None,
               lambda st: snaps.append((time.perf_counter(),
                                        {k: (st or {}).get(k, 0) for k in COUNTERS})))
    prof, marker = None, None
    if on_card:
        torch.cuda.synchronize()
    if ctx.trace and on_card and mix["arrivals"] == "backlog":
        prof, marker = start_profile()
    t_serve = time.perf_counter()
    warm = mix["warm_s"]
    win = {}

    if mix["arrivals"] == "backlog":
        # the window opens at the first harvest after the warm-up and closes
        # at a harvest --seconds or more later: both ends are deliveries
        stream = Backlog(caps, n_pool)

        def on_result(rid, res):
            t = time.perf_counter()
            done[rid] = (t, res)
            if "open" not in win and t >= t_serve + warm:
                win["open"] = t
                stream.stop = t + ctx.seconds + mix["close_slack_s"]

        engine.serve(stream, seed=ctx.seed, prefix_pool=pool, on_result=on_result,
                     admission=mix["admission"])
        serves = 1
    else:
        # arrivals over the warm-up and the window; the window's are judged
        offsets = T.poisson_arrivals(mix["rate"], warm + ctx.seconds, ctx.seed)
        stream = Arrivals(caps, n_pool, t_serve, offsets)
        win["open"] = t_serve + warm

        def on_result(rid, res):
            done[rid] = (time.perf_counter(), res)

        serves = serve_arrivals(engine, stream, pool, ctx.seed, on_result, mix["admission"])
    t_drained = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    traced = None
    if ctx.trace and mix["arrivals"] == "poisson":
        traced = traced_arrivals(ctx, engine, pool, caps, on_card)
    if "open" not in win:
        raise RuntimeError(f"no caption was harvested after the {warm} s warm-up")
    t_open = win["open"]
    ctx.window_opens(at=t_open)

    # --- end-to-end metrics
    attempted = stream.i
    rec = {"card": card, "memory_peak_bytes": memory_peak, "attempted": attempted,
           "failed": attempted - len(done), "layer": {}, "trace": None}
    if mix["arrivals"] == "backlog":
        hv = harvests(done)
        k0 = max(k for k, (t, _) in enumerate(hv) if t <= t_open)
        # harvests alternate large and small (the FIFO refills turn the
        # slots over every two chunks): the window spans an even number
        k1 = next((k for k, (t, _) in enumerate(hv)
                   if t >= t_open + ctx.seconds and (k - k0) % 2 == 0), None)
        if k1 is None:
            k1 = k0 + 2 * ((len(hv) - 1 - k0) // 2)
        t_open, t_close = hv[k0][0], hv[k1][0]
        in_window = [rid for _, ids in hv[k0 + 1: k1 + 1] for rid in ids]
        rec["e2e"] = {"captions_per_s": len(in_window) / (t_close - t_open)}
        print(f"window {t_close - t_open!r} s from harvest {k0} to {k1} of {len(hv)}: "
              f"{len(in_window)} captions; harvests (s from the open, captions): "
              f"{[(round(t - t_open, 2), len(ids)) for t, ids in hv]}", file=sys.stderr)
    else:
        t_close = t_open + ctx.seconds
        due = stream.due[:attempted]
        in_window = [i for i in range(attempted) if t_open <= due[i] < t_close]
        lat = np.array([done[i][0] - due[i] if i in done else np.inf for i in in_window])
        rec["e2e"] = {"latency_p95_s": float(np.percentile(lat, 95))}
        late = np.array([stream.handed[i] - due[i] for i in in_window])
        waits = np.array([done[i][0] - due[i] - done[i][1]["latency_s"] for i in in_window
                          if i in done])
        rec["layer"]["queue_wait_p95_s"] = float(np.percentile(waits, 95))
        handed = np.array([stream.handed[i] for i in range(attempted)])

        def queue(t):  # requests due by t and not yet handed to the engine
            return int(((due <= t) & (handed > t)).sum())

        rec["sweep"] = {"late": late.tolist(), "due": (due[in_window] - t_open).tolist(),
                        "latency_p50_s": float(np.percentile(lat, 50)),
                        "queue_s": [[q, queue(t_open + q)] for q in
                                    np.linspace(0, ctx.seconds, 7).tolist()],
                        "drain_s": t_drained - float(due[-1])}
        print(f"window {ctx.seconds} s: {len(in_window)} arrivals; generator lateness p50 "
              f"{np.percentile(late, 50)!r} s, p95 {np.percentile(late, 95)!r} s, max "
              f"{late.max()!r} s; {serves} serve calls; latency p50 {np.percentile(lat, 50)!r} s,"
              f" p95 {np.percentile(lat, 95)!r} s", file=sys.stderr)
    # the engine's counters over the chunks dispatched inside the window
    inside = [c for t, c in snaps if t_open <= t <= t_close]
    stats = ({k: inside[-1][k] - inside[0][k] for k in inside[0]} if len(inside) > 1 else {})
    print(f"engine in the window: {stats}; drain ended {t_drained - t_close!r} s after the "
          f"close; {attempted} requests handed over", file=sys.stderr)

    # --- per-layer readings (traced run)
    if ctx.trace:
        lay = rec["layer"]
        lay["stats"] = stats
        if mix["arrivals"] == "backlog":
            lay["model_ops"] = F.served_ops(cfg, mix, [done[r][1]["length"] for r in in_window])
        lay["window_s"] = t_close - t_open
        lay["peak_ops_per_s"] = D.PEAKS[cfg["peak"]]
        lay["k3_bound_ms"] = D.sampler_bound(mix["slots"], cfg["vocab_size"], True)[0]
        if prof is not None:
            rec["trace"] = D.reduce_trace(prof, marker, int(t_open * 1e9), int(t_close * 1e9),
                                          spans)
        elif traced is not None and traced[0] is not None:
            rec["trace"] = D.reduce_trace(*traced, spans)

    # --- correctness: free the program, then the reference
    results = {rid: done[rid][1] for rid in in_window if rid in done}
    req_caps = {rid: int(caps[rid % len(caps)]) for rid in results}
    rows = {rid: rid % n_pool for rid in results}
    del engine, bundle, pool
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = R.judge(ctx, results, req_caps, rows, control_bits=ctx.control_bits)
    rec["verdict"] = verdict
    # the numbers the cell's limits name; with the control, its tokens are
    # judged in the program's place
    judged = dict(verdict["control"]["sampled"] if ctx.control_bits else verdict,
                  cap_faults=verdict["cap_faults"])
    rec["checks"] = [(name, judged[name], lim) for name, lim in ctx.limits.items()]
    print(f"judged {verdict['requests_judged']} requests, {verdict['tokens_judged']} tokens; "
          f"reference {verdict['reference_s']!r} s", file=sys.stderr)
    return rec
