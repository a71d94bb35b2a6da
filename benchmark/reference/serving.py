"""The judgment of a serving run: caps and stops of every harvested request,
and the served tokens of a sample against the plain reference.

The reference draws the weights and the CLIP features again from the seed
(benchmark/weights.py), widens them to float32, runs ClipCap's mapper on
the features of each sampled request's pool row and GPT-2 over that
prefix and the request's served tokens, in the int8 decode the
configuration states (benchmark/reference/<family>.py), and judges each
served token by benchmark/reference/judge.py. The sample is drawn from the
seed and holds the longest request. Run with `control_bits`, the same
prompts and tokens also go through the control, that decode at that many
bits.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import weights as W
from . import common as C
from . import judge as J

BLOCK = 32  # requests per reference forward


def cap_faults(results: Dict[int, dict], caps: Dict[int, int], vocab: int, stops) -> int:
    """Requests whose tokens break their cap or their stop: an id outside the
    vocabulary, a stop token before the last token, more tokens than the
    cap, or fewer without a stop at the end."""
    bad = 0
    for rid, res in results.items():
        toks = res["tokens"]
        n, cap = len(toks), caps[rid]
        stopped = n > 0 and toks[-1] in stops
        if (n == 0 or any(t < 0 or t >= vocab for t in toks) or any(t in stops for t in toks[:-1])
                or n > cap or (n < cap and not stopped)):
            bad += 1
    return bad


def pick(results: Dict[int, dict], n: int, seed: int) -> list:
    """Up to n request ids drawn from the seed, the longest request among them."""
    ids = sorted(results)
    if not ids:
        return []
    longest = max(ids, key=lambda r: (len(results[r]["tokens"]), -r))
    rest = [r for r in ids if r != longest]
    rng = np.random.default_rng([seed, 2])
    take = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in take]


@torch.no_grad()
def judge(ctx, results: Dict[int, dict], caps: Dict[int, int], rows: Dict[int, int],
          control_bits: Optional[int] = None) -> dict:
    t0 = time.perf_counter()
    cfg, mix = ctx.config, ctx.traffic
    s = mix["settings"]
    stops = {s["eos_token_id"], s["stop_token_id"]}
    faults = cap_faults(results, caps, cfg["vocab_size"], stops)
    sample = pick(results, mix["judge_requests"], ctx.seed)
    dev = ctx.device
    C.no_tf32()
    LM = importlib.import_module(f"benchmark.reference.{cfg['family']}").LM
    w = {k: v.float() for k, v in W.make(W.captioner_layout(cfg), ctx.seed, dev,
                                           torch.bfloat16).items()}
    feats = W.clip_features(mix["pool_rows"], cfg["mapper"]["dim_clip"], ctx.seed, dev)
    ref = LM(w, cfg, quant_bits=8 if cfg["decode"] == "int8" else None)
    ctrl = LM(w, cfg, quant_bits=control_bits) if control_bits else None
    p_len = cfg["mapper"]["prefix_length"]
    gen = torch.Generator().manual_seed(int(ctx.seed))
    gaps = []
    control = {"sampled": [], "first": []}
    for i in range(0, len(sample), BLOCK):
        block = sample[i:i + BLOCK]
        lens = [len(results[r]["tokens"]) for r in block]
        toks = torch.zeros(len(block), max(lens), dtype=torch.long)
        for j, r in enumerate(block):
            toks[j, :lens[j]] = torch.tensor(results[r]["tokens"]).clamp(0, cfg["vocab_size"] - 1)
        toks = toks.to(dev)
        prefix = C.mapper(w, cfg["mapper"], feats[torch.tensor([rows[r] for r in block],
                                                               device=dev)])
        embeds = torch.cat([prefix, ref.embed(toks[:, :-1])], 1)
        z = ref.logits(embeds, p_len)[:, p_len - 1:]
        zc = ctrl.logits(embeds, p_len)[:, p_len - 1:] if ctrl is not None else None
        for j, r in enumerate(block):
            n = lens[j]
            served = torch.tensor(results[r]["tokens"], device=dev)
            gaps.append(J.served_gaps(z[j, :n], served, s["repetition_penalty"],
                                      s["top_p"]).cpu())
            if zc is not None:
                c = J.control_gaps(z[j, :n], zc[j, :n], served, s["repetition_penalty"],
                                   s["top_p"], gen)
                for k, cg in c.items():
                    control[k].append(cg)
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    out = {**J.summary(g),
           "cap_faults": faults, "requests_judged": len(sample), "tokens_judged": len(g),
           "reference_s": time.perf_counter() - t0, "tokens_outside": int((g > 0).sum()),
           "top_gaps": g.topk(min(5, len(g))).values.tolist()}
    if ctrl is not None:
        out["control"] = {k: J.summary(torch.cat(cg)) for k, cg in control.items()}
    return out
