"""The judgment of a serving run for a model too large to hold twice: the
same numbers as benchmark/reference/serving.py's `judge` (`served_gap`,
`far_share`, `cap_faults`, over the same drawn sample with its longest
request), with the weights drawn once in bf16 and each layer widened to
float32 only while it runs (the family's reference `hidden`).

All sampled requests go through the decoder together, layer by layer, so
every layer is widened once (once more for the control); the head's
logits are taken in blocks of BLOCK requests. The mapper, small, is
widened whole.

It also compares logits, which sampled tokens cannot show apart: the
program's logits that each judged token was drawn from, at the
LOGIT_COLUMNS columns of the vocabulary `logit_columns` draws from the
seed (benchmark/drivers/serve_large.py keeps them on the timed path),
against the reference's at the same positions and columns. Per position
the root mean square of the difference over the columns; `logit_rms` is
its median over the judged positions, and `logit_unmatched` counts the
judged tokens whose step the run did not find. The control's `logit_rms`
is its own logits' distance from the reference's at the same positions.
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
from .serving import BLOCK, cap_faults, pick

LOGIT_COLUMNS = 64


def logit_columns(vocab: int, seed: int) -> np.ndarray:
    """LOGIT_COLUMNS distinct vocabulary ids drawn from the seed, sorted."""
    return np.sort(np.random.default_rng([seed, 3]).choice(vocab, LOGIT_COLUMNS, replace=False))


def logit_summary(errors: list, unmatched: int) -> dict:
    e = torch.cat(errors).cpu() if errors else torch.zeros(0)
    if not len(e):
        return {"logit_rms": float("inf"), "positions": 0, "unmatched": unmatched}
    q = torch.quantile(e.double(), torch.tensor([0.5, 0.9], dtype=torch.float64))
    return {"logit_rms": float(q[0]), "p90": float(q[1]), "max": float(e.max()),
            "positions": len(e), "unmatched": unmatched}


@torch.no_grad()
def judge(ctx, results: Dict[int, dict], caps: Dict[int, int], rows: Dict[int, int],
          control_bits: Optional[int] = None, program_logits: Optional[tuple] = None) -> dict:
    """The serving judge's numbers; with program_logits, ({request: [n,
    LOGIT_COLUMNS] logits, NaN rows where not found}, the count not found)
    from the run, the logits' too."""
    t0 = time.perf_counter()
    cfg, mix = ctx.config, ctx.traffic
    s = mix["settings"]
    stops = {s["eos_token_id"], s["stop_token_id"]}
    faults = cap_faults(results, caps, cfg["vocab_size"], stops)
    sample = pick(results, mix["judge_requests"], ctx.seed)
    dev = ctx.device
    C.no_tf32()
    LM = importlib.import_module(f"benchmark.reference.{cfg['family']}").LM
    w = W.make(W.captioner_layout(cfg), ctx.seed, dev, torch.bfloat16)
    mapper_w = {k: v.float() for k, v in w.items() if k.startswith("mapper.")}
    feats = W.clip_features(mix["pool_rows"], cfg["mapper"]["dim_clip"], ctx.seed, dev)
    p_len = cfg["mapper"]["prefix_length"]
    lens = [len(results[r]["tokens"]) for r in sample]
    toks = torch.zeros(len(sample), max(lens, default=1), dtype=torch.long)
    for j, r in enumerate(sample):
        toks[j, :lens[j]] = torch.tensor(results[r]["tokens"]).clamp(0, cfg["vocab_size"] - 1)
    toks = toks.to(dev)
    prefix = torch.cat([C.mapper(mapper_w, cfg["mapper"],
                                 feats[torch.tensor([rows[r] for r in sample[i:i + BLOCK]],
                                                    device=dev)])
                        for i in range(0, len(sample), BLOCK)]) if sample else None
    del mapper_w, feats

    def states(bits):
        lm = LM(w, cfg, quant_bits=bits)
        embeds = torch.cat([prefix, lm.embed(toks[:, :-1])], 1)
        return lm.hidden(embeds)[:, p_len - 1:], lm.head_weight()

    gaps = []
    control = {"sampled": [], "first": []}
    cols = torch.as_tensor(logit_columns(cfg["vocab_size"], ctx.seed), device=dev)
    kept, unmatched = program_logits if program_logits is not None else ({}, 0)
    errors, control_errors = [], []

    def rms(a, b):
        return (a - b).square().mean(-1).sqrt()

    if sample:
        h, head = states(None)
        hc, head_c = states(control_bits) if control_bits else (None, None)
        gen = torch.Generator().manual_seed(int(ctx.seed))
        for i in range(0, len(sample), BLOCK):
            z = h[i:i + BLOCK] @ head.T
            zc = hc[i:i + BLOCK] @ head_c.T if hc is not None else None
            for j, r in enumerate(sample[i:i + BLOCK]):
                n = lens[i + j]
                served = torch.tensor(results[r]["tokens"], device=dev)
                gaps.append(J.served_gaps(z[j, :n], served, s["repetition_penalty"],
                                          s["top_p"]).cpu())
                if zc is not None:
                    c = J.control_gaps(z[j, :n], zc[j, :n], served, s["repetition_penalty"],
                                       s["top_p"], gen)
                    for k, cg in c.items():
                        control[k].append(cg)
                if r in kept:
                    got = kept[r].to(dev)
                    found = ~torch.isnan(got[:, 0])
                    want = z[j, :n][:, cols][found]
                    errors.append(rms(got[found], want))
                    if zc is not None:
                        control_errors.append(rms(zc[j, :n][:, cols][found], want))
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    logits = logit_summary(errors, unmatched)
    out = {**J.summary(g),
           "cap_faults": faults, "requests_judged": len(sample), "tokens_judged": len(g),
           "logit_rms": logits["logit_rms"], "logit_unmatched": unmatched, "logits": logits,
           "reference_s": time.perf_counter() - t0, "tokens_outside": int((g > 0).sum()),
           "top_gaps": g.topk(min(5, len(g))).values.tolist()}
    if control_bits:
        out["control"] = {k: J.summary(torch.cat(cg) if cg else torch.zeros(0))
                          for k, cg in control.items()}
        # the control stands in the program's place at the positions the run found
        out["control"]["logits"] = logit_summary(control_errors, unmatched)
        out["control"]["sampled"].update(logit_rms=out["control"]["logits"]["logit_rms"],
                                         logit_unmatched=unmatched)
    return out
