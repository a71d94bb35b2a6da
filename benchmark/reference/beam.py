"""The judgment of a beam run: the beam each sampled image is captioned with
against the reference.

The reference draws the weights and the pixel batches again from the seed
(benchmark/weights.py), widens them to float32 and runs CLIP's ViT, the
mapper and the LM (benchmark/reference/) over each sampled image and the
tokens of the beam the program captions it with (the best by the
program's own scores, as `caption_pixels` picks it). The number compared
is `score_gap`: the widest difference, over the images, between the score
the program gave that beam (its log-probabilities summed over its length,
divided by the length: what ranks the beams) and the score the reference
gives the same tokens. The mean difference is printed too.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from .. import weights as W
from . import common as C


def sequence_score(lm, prefix: torch.Tensor, tokens: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """The normalised score beam search gives each sequence: the summed
    log-probabilities of tokens [N, T] after prefix [N, P, D] over its first
    lengths[n] tokens, divided by the length. [N]."""
    p = prefix.shape[1]
    embeds = torch.cat([prefix, lm.embed(tokens[:, :-1])], 1)
    logp = torch.log_softmax(lm.start(embeds)[:, p - 1:], -1)
    picked = logp.gather(2, tokens[:, :, None])[:, :, 0]
    keep = torch.arange(tokens.shape[1], device=tokens.device)[None] < lengths[:, None]
    return torch.where(keep, picked, torch.zeros_like(picked)).sum(1) / lengths


BLOCK = 32  # sequences per reference forward


@torch.no_grad()
def judge(ctx, results: list, calls: int) -> dict:
    """results: each timed call's beam_search_batched output on the host, in
    call order; call c captioned pixel batch c % batches."""
    t0 = time.perf_counter()
    cfg, mix = ctx.config, ctx.traffic
    dev = ctx.device
    n_img = mix["images"]
    used = min(calls, mix["batches"])
    rng = np.random.default_rng([ctx.seed, 3])
    picks = sorted(rng.choice(used * n_img, size=min(mix["judge_images"], used * n_img),
                              replace=False).tolist())
    toks, lens, own = [], [], []
    for flat in picks:
        b, r = divmod(flat, n_img)
        scores = results[b]["scores"][r].float()
        best = int(np.argmax(scores.numpy()))
        toks.append(results[b]["tokens"][r, best].long())
        lens.append(float(results[b]["seq_lengths"][r, best]))
        own.append(float(scores[best]))
    C.no_tf32()
    w = W.make(W.captioner_layout(cfg), ctx.seed, dev, torch.bfloat16)
    w = {k: w.pop(k).float() for k in list(w)}
    v = cfg["visual"]
    lm = importlib.import_module(f"benchmark.reference.{cfg['family']}").LM(w, cfg)
    batch = {}
    under_ref = []
    for i in range(0, len(picks), BLOCK):
        block = picks[i:i + BLOCK]
        pix = []
        for flat in block:
            b = flat // n_img
            if b not in batch:
                batch = {b: W.pixels(n_img, v["image_size"], ctx.seed, b, dev)}
            pix.append(batch[b][flat % n_img])
        prefix = C.mapper(w, cfg["mapper"], C.clip_vit_pooled(w, v, torch.stack(pix)))
        under_ref.append(sequence_score(lm, prefix, torch.stack(toks[i:i + BLOCK]).to(dev),
                                        torch.tensor(lens[i:i + BLOCK], device=dev)))
    score_gaps = (torch.cat(under_ref) - torch.tensor(own, device=dev)).abs()
    return {"score_gap": float(score_gaps.max()), "score_gap_mean": float(score_gaps.mean()),
            "images_judged": len(picks), "score_gaps": score_gaps.tolist(),
            "reference_s": time.perf_counter() - t0}
