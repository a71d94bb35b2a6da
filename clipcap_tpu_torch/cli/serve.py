"""Batch caption server: CLIP-feature shards -> captions by continuous
batching (port of clipcap_tpu/cli/serve.py: serve_shard and
pick_slots_for_p50).

`serve_shard` projects a shard of CLIP features through the bundle's
mapper into a prefix pool on the bundle's device and drives
decode/serving.ServingEngine over it: a fixed batch of slots, each refilled
with the next image as soon as its caption finishes. It writes one JSONL
line per image. The command-line `main()`, which loads a checkpoint and a
GPT-2 vocabulary, comes with the CLI/loading slice.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch


def pick_slots_for_p50(target_p50_s: float, curve: Dict[int, float]) -> int:
    """The largest slot count whose measured p50 request latency (`curve`:
    slot count -> seconds, measured on the card that serves) meets the
    target, since throughput grows with slots; the smallest measured count
    when nothing fits."""
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

    results = engine.serve([Request(i, i, max_length=cap(i)) for i in range(n)],
                           prefix_pool=pool, admission=admission)

    special = set(getattr(bundle.tokenizer, "all_special_ids", ()))
    with open(out_path, "w") as f:
        for i in range(n):
            res = results[i]
            ids = [t for t in res["tokens"] if t not in special]
            f.write(json.dumps({"id": i, "caption": bundle.tokenizer.decode_tokens(ids),
                                "tokens": res["length"], "stopped": res["stopped"]}) + "\n")
    return n
