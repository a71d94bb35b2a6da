"""Serving cells of a model the card holds only once (clipcap-moonlight16b:
15.96 B parameters, 31.9 GB in bf16): clipcap_tpu_torch/cli/serve.py's
`serve_shard` path, with the `serve` driver's backlog window.

What differs from benchmark/drivers/serve.py, whose set-up would hold the
weights twice (the bundle's own draws and the seeded state beside them):

- set-up builds the bundle (`CaptionerBundle.create`) and fills every
  tensor in place from the seeded stream of benchmark/weights.py, the
  tensors `make` would draw, one at a time (`fill`); the bundle then
  projects the pool and builds and warms the engine as `serve` does;
- `--trace 1` also starts the port's tracer (utils/profiling.py), for its
  `lm.moe` spans, and has the LM log every MoE call's tokens per expert
  on the card (`DeepseekV3.log_experts`, set before the engine captures
  its graph step), which the cell's per-layer metrics read over the
  window between two marks of the log taken at chunk dispatches;
- the model's operations are counted by benchmark/moe_flops.py;
- every run keeps, for each decode step, the logits each slot sampled its
  token from at LOGIT_COLUMNS columns of the vocabulary drawn from the
  seed, with each slot's emitted token and count of tokens (`StepLogits`):
  two device copies a step, read after the window for the judged
  requests' tokens;
- the judge is benchmark/reference/serving_blockwise.py, which holds the
  weights once in bf16 and widens one layer at a time, and also compares
  those logits with the reference's.

The window, the harvests and the token checks are the `serve` driver's
backlog ones.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time

import numpy as np

from .. import device as D
from .. import moe_flops as MF
from .. import traffic as T
from .. import weights as W
from .serve import COUNTERS, Backlog, harvests, instrument, start_profile

# MoE calls the traced run's expert log holds: a 51 s window at ~40 ms a
# step makes ~1,300 steps of 26 MoE calls, and each refill 26 more
EXPERT_LOG_CALLS = 1 << 18


def fill(model, layout, seed: int, device, dtype) -> None:
    """Copy the tensors `weights.make(layout, seed, device, dtype)` would
    return into the module's own, one at a time: the same seeded stream,
    with no second copy of the model."""
    import torch

    own = model.state_dict(keep_vars=True)
    missing = sorted(set(own) - {name for name, *_ in layout})
    if missing:
        raise KeyError(f"the layout lacks {missing[:5]}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    buf, used = None, 0
    with torch.no_grad():
        for name, shape, kind, value in layout:
            t = own[name]
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: the module has {tuple(t.shape)}, the layout {shape}")
            if kind == "const":
                t.fill_(value)
                continue
            n = math.prod(shape)
            if buf is None or used + n > buf.numel():
                buf = None  # the old draw goes before the new one is made
                buf = torch.randn(max(W.CHUNK, n), generator=gen, device=device)
                used = 0
            t.copy_((buf[used: used + n].view(shape) * value).to(dtype))
            used += n


def build(ctx):
    """The bundle, its prefix pool and a warmed-up engine, the weights held
    once."""
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
    fill(bundle.model, W.captioner_layout(cfg), ctx.seed, ctx.device, torch.bfloat16)
    if ctx.trace:
        bundle.lm_decode.log_experts(EXPERT_LOG_CALLS)
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


class StepLogits:
    """What each decode step of a serve call sampled from, kept on the
    device: the logits each slot's token was drawn from at the columns
    `cols` ([B, K] f32, read before the step's LM overwrites them), and the
    token each slot emitted with its count of emitted tokens after the step
    ([2, B]). With FIFO admission from a stream that hands out ids 0, 1,
    ... in order, the host knows where each request sat: the first B in
    slots 0..B-1 from step 0, then each refill's requests in its slot
    block from the step after it.

    Wraps the engine's step (the graph step's replay, or the eager LM step)
    and its `_chunk` and `_refill` on the instance."""

    def __init__(self, engine, cols):
        import torch

        self.cols = cols
        self.logits, self.emitted, self.placed = [], [], [(0, 0, 0, engine._hi - engine._lo)]
        self.next_id = engine._hi - engine._lo
        held = {}
        chunk, refill = engine._chunk, engine._refill

        def held_chunk(st, n):
            held["st"] = st
            return chunk(st, n)

        def placed_refill(r, st, prefixes, q, new_max_len, n_real):
            self.placed.append((len(self.logits), q, self.next_id, n_real))
            self.next_id += n_real
            return refill(r, st, prefixes, q, new_max_len, n_real)

        def keep(tokens):
            st = held["st"]
            self.logits.append(st.last_logits.index_select(1, cols))
            self.emitted.append(torch.stack([tokens.long(), st.gen_count.long()]))

        engine._chunk, engine._refill = held_chunk, placed_refill
        if engine._graph is not None:
            graph, replay = engine._graph, engine._graph.replay

            def kept_replay(tokens, cache, pos, start):
                keep(tokens)
                return replay(tokens, cache, pos, start)

            graph.replay = kept_replay
        else:
            step = engine._lm_step

            def kept_step(tokens, cache, pos, start, index=None):
                keep(tokens)
                return step(tokens, cache, pos, start, index)

            engine._lm_step = kept_step

    def for_requests(self, results: dict, rids) -> tuple:
        """({rid: [n, K] f32 host tensor, NaN rows where a token's step was
        not found}, the number not found) for the requests `rids`: token i
        of a request is the one its slot emitted at the first step, from its
        placement on, whose count reached i + 1, and must be the token the
        harvest returned."""
        import torch

        if not self.logits:
            return {}, sum(len(results[r]["tokens"]) for r in rids)
        em = torch.stack(self.emitted).cpu().numpy()  # [S, 2, B]
        tok, count = em[:, 0], em[:, 1]
        n_steps = len(em)
        starts = {}  # rid -> (slot, first step, the slot's next placement)
        by_slot = {}
        for k0, q, rid0, n in self.placed:
            for j in range(n):
                by_slot.setdefault(q + j, []).append((k0, rid0 + j))
        for slot, seq in by_slot.items():
            for (k0, rid), nxt in zip(seq, seq[1:] + [(n_steps, None)]):
                starts[rid] = (slot, k0, nxt[0])
        where, owner, missing = [], [], 0
        for rid in rids:
            toks = results[rid]["tokens"]
            if rid not in starts:
                missing += len(toks)
                continue
            slot, k0, k1 = starts[rid]
            col = count[k0:k1, slot]
            for i, t in enumerate(toks):
                k = k0 + int(np.searchsorted(col, i + 1, side="left"))
                if k < k1 and count[k, slot] == i + 1 and tok[k, slot] == t:
                    where.append((k, slot))
                    owner.append((rid, i))
                else:
                    missing += 1
        out = {rid: torch.full((len(results[rid]["tokens"]), len(self.cols)), float("nan"))
               for rid in rids}
        if where:
            ks, ss = (torch.tensor(v, device=self.cols.device) for v in zip(*where))
            got = torch.stack(self.logits)[ks, ss].float().cpu()
            for (rid, i), row in zip(owner, got):
                out[rid][i] = row
        return out, missing


def moe_readings(log, mark0, mark1, tracer, t0_ns: int, t1_ns: int) -> dict:
    """The window's MoE calls from the LM's expert log between two marks:
    per call the token-expert pairs routed, the experts hit and the most
    tokens any expert received; and the host time in `lm.moe` (eager
    calls: the refills' prefills)."""
    c0, c1 = int(mark0), int(mark1)
    if log is None or c1 <= c0 or c1 - c0 > log.counts.shape[0]:
        return {}
    c = log.read(c0, c1).astype(np.int64)
    return {"calls": len(c), "pairs": c.sum(1).tolist(), "experts_hit": (c > 0).sum(1).tolist(),
            "max_expert_tokens": c.max(1).tolist(), "experts": int(c.shape[1]),
            "host_s": sum(s.end_ns - s.start_ns for s in tracer.spans
                          if s is not None and s.name == "lm.moe"
                          and t0_ns <= s.start_ns <= t1_ns) / 1e9}


def run(ctx) -> dict:
    import torch

    from clipcap_tpu_torch.utils import profiling as P

    from ..reference import serving_blockwise as R

    mix, cfg = ctx.traffic, ctx.config
    if mix["arrivals"] != "backlog":
        raise ValueError("serve_large drives backlog windows only")
    on_card = ctx.device == "cuda"
    card = D.card() if on_card else {"kind": "cpu", "power_limit_w": None}
    if mix["admission"] != "fifo":
        raise ValueError("serve_large places requests in slots by FIFO admission")
    bundle, pool, engine = build(ctx)
    log = getattr(bundle.lm_decode.layers[-1].mlp, "log", None)
    caps = T.seeded_caps(mix, ctx.seed)
    n_pool = len(pool)
    done = {}
    spans = D.Spans()
    snaps = []  # (time, counters, the expert log's mark) before each chunk

    cols = torch.as_tensor(R.logit_columns(cfg["vocab_size"], ctx.seed), device=ctx.device)
    kept = StepLogits(engine, cols)  # inside `instrument`'s wrapper, which reads its caller
    instrument(engine, spans if ctx.trace else None,
               lambda st: snaps.append((time.perf_counter(),
                                        {k: (st or {}).get(k, 0) for k in COUNTERS},
                                        log.mark() if log is not None else None)))
    prof, marker = None, None
    if on_card:
        torch.cuda.synchronize()
    if ctx.trace and on_card:
        prof, marker = start_profile()
    tracer = P.start() if ctx.trace else None
    t_serve = time.perf_counter()
    warm = mix["warm_s"]
    win = {}
    stream = Backlog(caps, n_pool)

    def on_result(rid, res):
        t = time.perf_counter()
        done[rid] = (t, res)
        if "open" not in win and t >= t_serve + warm:
            win["open"] = t
            stream.stop = t + ctx.seconds + mix["close_slack_s"]

    try:
        engine.serve(stream, seed=ctx.seed, prefix_pool=pool, on_result=on_result,
                     admission=mix["admission"])
    finally:
        if tracer is not None:
            P.stop()
    t_drained = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if "open" not in win:
        raise RuntimeError(f"no caption was harvested after the {warm} s warm-up")
    ctx.window_opens(at=win["open"])

    attempted = stream.i
    rec = {"card": card, "memory_peak_bytes": memory_peak, "attempted": attempted,
           "failed": attempted - len(done), "layer": {}, "trace": None}
    hv = harvests(done)
    k0 = max(k for k, (t, _) in enumerate(hv) if t <= win["open"])
    k1 = next((k for k, (t, _) in enumerate(hv)
               if t >= win["open"] + ctx.seconds and (k - k0) % 2 == 0), None)
    if k1 is None:
        k1 = k0 + 2 * ((len(hv) - 1 - k0) // 2)
    t_open, t_close = hv[k0][0], hv[k1][0]
    in_window = [rid for _, ids in hv[k0 + 1: k1 + 1] for rid in ids]
    rec["e2e"] = {"captions_per_s": len(in_window) / (t_close - t_open)}
    print(f"window {t_close - t_open!r} s from harvest {k0} to {k1} of {len(hv)}: "
          f"{len(in_window)} captions; harvests (s from the open, captions): "
          f"{[(round(t - t_open, 2), len(ids)) for t, ids in hv]}", file=sys.stderr)
    inside = [(c, m) for t, c, m in snaps if t_open <= t <= t_close]
    stats = ({k: inside[-1][0][k] - inside[0][0][k] for k in inside[0][0]}
             if len(inside) > 1 else {})
    print(f"engine in the window: {stats}; drain ended {t_drained - t_close!r} s after the "
          f"close; {attempted} requests handed over; memory peak {memory_peak} bytes",
          file=sys.stderr)

    if ctx.trace:
        lay = rec["layer"]
        lay["stats"] = stats
        lay["model_ops"] = MF.served_ops(cfg, mix, [done[r][1]["length"] for r in in_window])
        lay["window_s"] = t_close - t_open
        lay["peak_ops_per_s"] = D.PEAKS[cfg["peak"]]
        lay["moe"] = (moe_readings(log, inside[0][1], inside[-1][1], tracer, int(t_open * 1e9),
                                   int(t_close * 1e9)) if len(inside) > 1 else {})
        if lay["moe"]:
            lay["moe"]["bound_s"] = MF.expert_gemm_bound_s(cfg, lay["moe"]["experts_hit"],
                                                           lay["moe"]["pairs"])
        if prof is not None:
            rec["trace"] = D.reduce_trace(prof, marker, int(t_open * 1e9), int(t_close * 1e9),
                                          spans, top=16)
            tr = rec["trace"]
            expert_s = sum(sec for name, (sec, _) in tr["kernels"].items()
                           if any(f in name for f in MF.EXPERT_KERNELS))
            lay["moe_expert_kernel_s"] = expert_s
            print(f"trace: busy {tr['busy_s']!r} of {tr['window_s']!r} s; expert kernels "
                  f"{expert_s!r} s; top kernels {tr['device_ops']}; idle {tr['idle_gaps']}",
                  file=sys.stderr)
        m = lay["moe"]
        if m:
            print(f"moe: {m['calls']} calls in the window, host {m['host_s']!r} s in lm.moe, "
                  f"experts hit mean {np.mean(m['experts_hit'])!r}, max expert tokens mean "
                  f"{np.mean(m['max_expert_tokens'])!r}, bound {m['bound_s']!r} s",
                  file=sys.stderr)

    results = {rid: done[rid][1] for rid in in_window if rid in done}
    req_caps = {rid: int(caps[rid % len(caps)]) for rid in results}
    rows = {rid: rid % n_pool for rid in results}
    logits = kept.for_requests(results, R.pick(results, mix["judge_requests"], ctx.seed))
    del engine, bundle, pool, tracer, kept, log
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    verdict = R.judge(ctx, results, req_caps, rows, control_bits=ctx.control_bits,
                      program_logits=logits)
    if on_card:
        verdict["judge_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["verdict"] = verdict
    judged = dict(verdict["control"]["sampled"] if ctx.control_bits else verdict,
                  cap_faults=verdict["cap_faults"])
    rec["checks"] = [(name, judged[name], lim) for name, lim in ctx.limits.items()]
    print(f"judged {verdict['requests_judged']} requests, {verdict['tokens_judged']} tokens; "
          f"reference {verdict['reference_s']!r} s; judge memory peak "
          f"{verdict.get('judge_memory_peak_bytes')} bytes; gaps {verdict['top_gaps']}; "
          f"logits {verdict['logits']}"
          + (f"; the control's {verdict['control']['logits']}" if ctx.control_bits else ""),
          file=sys.stderr)
    return rec
