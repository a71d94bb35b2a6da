"""Batch caption server: CLIP-feature shards -> captions by continuous
batching (port of clipcap_tpu/cli/serve.py: serve_shard,
pick_slots_for_p50 and main).

`serve_shard` projects a shard of CLIP features through the bundle's
mapper into a prefix pool on the bundle's device and drives
decode/serving.ServingEngine over it: a fixed batch of slots, each refilled
with the next image as soon as its caption finishes. It writes one JSONL
line per image.

    python -m clipcap_tpu_torch.cli.serve --checkpoint_path CKPT \
        --tokenizer_vocab_dir VOCAB --prefixes_npy FEATS.npy --out_jsonl OUT

CKPT is a checkpoint directory (train/checkpoints.py) with a GPT-2, GPT-J
or T5/T0 LM, VOCAB its LM's tokenizer files (GPT-J uses GPT-2's BPE files,
T5 a `tokenizer.json`); the server runs on the card unless `--device cpu`.

`--target_p50_s` picks the slot count from LATENCY_CURVE_P50_S, measured
on an H100 by tools/serving_latency_curve.py, by JAX's rule.

`--spans_jsonl SPANS` traces the run (utils/profiling.py): when it ends, it
writes every span as a JSON line (set-up, the engine's chunks, refills and
harvests, and each request's queued/admit/decode/harvest phases) and prints
the p50 and p95 of each request phase.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np
import torch


#: serving latency curve on the card: slot count -> median p50 request
#: latency_s over 3 timed runs of tools/serving_latency_curve.py (GPT2-XL
#: int8 at 48 layers, 2,048 requests with caps ~N(12, 4) clipped to [5, 30],
#: top-p 0.8, K3 every step), measured on an NVIDIA H100 80GB HBM3 at
#: 700.00 W (PERF.md). The card is busy 29 / 38 / 61 % of a run's wall and
#: the shared host sets the rest: the figures move between calls and
#: machines, so read them as the order of the slot counts.
LATENCY_CURVE_P50_S = {128: 3.714, 256: 5.037, 512: 5.065}


def pick_slots_for_p50(target_p50_s: float, curve: Optional[Dict[int, float]] = None) -> int:
    """The largest measured slot count whose p50 request latency (`curve`:
    slot count -> seconds; LATENCY_CURVE_P50_S by default) meets the
    target, since throughput grows with slots; the smallest measured count
    when nothing fits."""
    curve = curve if curve is not None else LATENCY_CURVE_P50_S
    fitting = [s for s, p50 in curve.items() if p50 <= target_p50_s]
    return max(fitting) if fitting else min(curve)


def serve_shard(
    bundle,
    clip_features,  # [N, dim_clip] (or [N, clip_length, dim]) host array
    out_path: str,
    slots: int = 256,
    refill_size: int = 0,
    steps_per_sync: int = 16,
    map_batch: int = 512,
    admission: str = "fifo",
    max_lengths=None,  # optional [N] per-image new-token caps
    max_request_length: int = 0,
    **generation_kwargs,
) -> int:
    """Caption every row of clip_features; returns the number written.

    `max_request_length` > 0 declares the bound on every request's cap;
    the engine sizes its KV ring to it, and every decode step reads the
    whole ring. Each request's cap (max_lengths[i], else max_new_tokens)
    must be within the declared bound (decode/serving.py checks)."""
    from ..decode.engine import GenerationSettings
    from ..decode.serving import Request

    settings = GenerationSettings(**generation_kwargs)
    if max_request_length and settings.eos_token_id is None:
        # caps bind through the engine's completion logic, which runs only
        # with eos handling on: without it rows outrun the declared ring
        raise ValueError("max_request_length requires eos_token_id (length caps bind "
                         "through the engine's eos/completion logic)")
    engine = bundle.make_serving_engine(
        settings, slots=slots, refill_size=refill_size or None, steps_per_sync=steps_per_sync,
        max_request_length=max_request_length or None)

    n = len(clip_features)
    feats = np.asarray(clip_features, np.float32)
    pool = torch.cat([bundle.project_prefix(torch.from_numpy(feats[i:i + map_batch]))
                      for i in range(0, n, map_batch)])

    def cap(i):
        if max_lengths is not None:
            return int(max_lengths[i])
        if max_request_length:
            # a declared bound is the hard cap when no per-image caps are given
            return min(int(max_request_length), int(settings.max_new_tokens))
        return None

    arrived = time.perf_counter_ns()  # the whole shard arrives at once
    results = engine.serve([Request(i, i, max_length=cap(i), arrival_ns=arrived)
                            for i in range(n)], prefix_pool=pool, admission=admission)

    special = set(getattr(bundle.tokenizer, "all_special_ids", ()))
    with open(out_path, "w") as f:
        for i in range(n):
            res = results[i]
            ids = [t for t in res["tokens"] if t not in special]
            f.write(json.dumps({"id": i, "caption": bundle.tokenizer.decode_tokens(ids),
                                "tokens": res["length"], "stopped": res["stopped"]}) + "\n")
    return n


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="continuous-batching caption server over a prefix shard")
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--tokenizer_vocab_dir", required=True)
    p.add_argument("--prefixes_npy", required=True,
                   help="CLIP-feature shard (the prefixes/*.npy layout)")
    p.add_argument("--out_jsonl", required=True)
    p.add_argument("--slots", type=int, default=256)
    p.add_argument("--target_p50_s", type=float, default=None,
                   help="pick --slots from the latency curve measured on an H100 "
                        "(LATENCY_CURVE_P50_S: GPT2-XL int8, 2,048 short captions): the "
                        "largest slot count whose p50 meets the target. Its figures are "
                        "medians of runs that the host holds back, which move between "
                        "calls and machines")
    p.add_argument("--refill_size", type=int, default=0, help="0 = slots // 8")
    p.add_argument("--steps_per_sync", type=int, default=16)
    p.add_argument("--max_request_length", type=int, default=0,
                   help="declare the per-request new-token cap bound; the KV ring is "
                        "sized to it instead of max_new_tokens. Length caps bind through "
                        "the engine's completion logic, so --eos_token_id must be set")
    p.add_argument("--int8_decode", action="store_true",
                   help="int8 weight-streaming decode (gpt2/gptj/t5): int8 weights, and an "
                        "int8 KV ring for gpt2/gptj")
    p.add_argument("--max_new_tokens", type=int, default=67)
    p.add_argument("--top_p", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--repetition_penalty", type=float, default=1.0)
    p.add_argument("--stop_token_id", type=int, default=None)
    p.add_argument("--eos_token_id", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--spans_jsonl", default=None,
                   help="trace the run and write its host spans as JSON lines here when it "
                        "ends (name, start_ns and end_ns on time.perf_counter_ns, parent, "
                        "request_id, attributes); prints each request phase's p50 and p95")
    args = p.parse_args(argv)
    if args.spans_jsonl is None:
        return _serve_main(args)
    from ..utils import profiling as P

    with P.tracing() as tracer:
        n = _serve_main(args)
    tracer.write_jsonl(args.spans_jsonl)
    for name, q in tracer.summary().items():
        if name.startswith("serving.request."):
            print(f"{name}: p50 {q['p50_s']:.4f} s, p95 {q['p95_s']:.4f} s over {q['count']}")
    print(f"wrote the spans to {args.spans_jsonl}")
    return n


def _serve_main(args) -> int:
    from .loading import load_captioner_bundle

    bundle = load_captioner_bundle(args.checkpoint_path, args.tokenizer_vocab_dir,
                                   device=args.device)
    if args.int8_decode:
        bundle.enable_int8_decode()
    slots = args.slots
    if args.target_p50_s is not None:
        slots = pick_slots_for_p50(args.target_p50_s)
        print(f"target_p50_s={args.target_p50_s}: serving with {slots} slots")
    n = serve_shard(
        bundle, np.load(args.prefixes_npy), args.out_jsonl,
        slots=slots, refill_size=args.refill_size, steps_per_sync=args.steps_per_sync,
        max_request_length=args.max_request_length, max_new_tokens=args.max_new_tokens,
        top_p=args.top_p, top_k=args.top_k, temperature=args.temperature,
        repetition_penalty=args.repetition_penalty,
        greedy=(args.top_p == 0.0 and args.top_k == 0),
        stop_token_id=args.stop_token_id, eos_token_id=args.eos_token_id)
    print(f"wrote {n} captions to {args.out_jsonl}")
    return n


if __name__ == "__main__":
    main()
