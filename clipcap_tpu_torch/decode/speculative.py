"""Speculative greedy decoding: a small draft LM proposes, the target verifies
(port of clipcap_tpu/decode/speculative.py).

Each chunk, the draft decodes gamma tokens greedily; one (gamma+1)-token
target forward scores all of them; the longest prefix where the target's
own argmax agrees is accepted, plus the target's token at the first
disagreement (or the bonus token when every proposal agreed). For greedy
decoding the output is target-only greedy decode for ANY draft: the draft
controls speed only. In low precision the chunk's multi-token attention and
the single-token decode step reduce in different orders, so a position
whose top-2 logits lie within rounding noise can resolve differently (the
JAX docstring's caveat).

Batch 1: speculative decoding is a latency technique, and per-row
acceptance lengths would need per-row cache indices. Prompts are
embeddings in each model's own space (a ClipCap draft has its own mapper);
the models share a tokenizer, and a draft with a narrower vocabulary than
its target embeds the target's wider ids clamped to its last row, as JAX's
gather does.

JAX runs the whole loop as one `lax.while_loop`. Here it is a Python loop:
the draft's gamma+1 chained steps, the target's chunk and the acceptance
arithmetic all stay on the device, and the host reads one small tensor per
chunk (the emitted count and whether eos was hit) to advance the loop and
rewind both caches. A rejection rewinds a cache by its host-int index only
(`cache._replace(index=...)`): stale K/V beyond the index are never
attended (the float caches attend [:index], the int8 caches mask the rest)
and the next chunk overwrites them. No kernel runs here: the argmaxes and
the caches' attention are plain torch ops, as they are XLA in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


@torch.no_grad()
def speculative_greedy(
    target_lm: Any,
    draft_lm: Any,
    target_prompt: torch.Tensor,  # [1, P, D_target] embeddings
    draft_prompt: torch.Tensor,  # [1, Pd, D_draft] embeddings (same token content)
    max_new_tokens: int = 32,
    gamma: int = 4,
    eos_token_id: Optional[int] = None,
    target_cache_constraint: Optional[Callable] = None,  # cache -> cache, applied once
    device="cuda",
) -> dict:
    """Returns {"tokens" [1, N] int32, "lengths" [1], "chunks" [1]} on the
    device: the tokens of target-only greedy decode (pad 0 after a stop),
    and `chunks`, the target forwards spent (the prefill included); plain
    greedy spends `lengths` of them. Runs on `device`, the card unless
    asked for the CPU; both LMs and both prompts must lie there."""
    dev = torch.device(device)
    for name, t in (("target", target_prompt), ("draft", draft_prompt)):
        if t.device.type != dev.type:
            raise ValueError(f"{name} prompt on {t.device}, speculative decode asked for {dev}")
    if target_prompt.shape[0] != 1:
        raise ValueError("speculative decoding is batch-1 (latency path)")
    n, g = max_new_tokens, gamma
    buf = n + g + 1  # emit buffer with chunk overshoot headroom
    dev = target_prompt.device

    t_cache = target_lm.init_cache(1, target_prompt.shape[1] + buf, dtype=target_prompt.dtype)
    if target_cache_constraint is not None:
        t_cache = target_cache_constraint(t_cache)
    d_cache = draft_lm.init_cache(1, draft_prompt.shape[1] + buf, dtype=draft_prompt.dtype)
    t_logits, t_cache = target_lm.prefill(target_prompt, t_cache)
    _, d_cache = draft_lm.prefill(draft_prompt, d_cache)
    first = torch.argmax(t_logits[0, -1], dim=-1)

    tokens = torch.zeros(buf, dtype=torch.int64, device=dev)
    tokens[0] = first
    slots = torch.arange(g + 1, device=dev)
    count, chunks = 1, 1
    done = eos_token_id is not None and int(first) == eos_token_id
    while not done and count < n:
        last = tokens[count - 1: count]  # [1]
        # g+1 chained draft steps fed [last, p1..pg]: the proposals p1..pg,
        # and the draft cache covers through pg's position, so full
        # acceptance needs no draft catch-up
        tok, proposal = last, []
        for _ in range(g + 1):
            emb = draft_lm.embed_tokens(tok)[:, None, :].to(draft_prompt.dtype)
            logits, d_cache = draft_lm.decode_step(emb, d_cache)
            tok = torch.argmax(logits, dim=-1)  # [1]
            proposal.append(tok)
        proposal = torch.cat(proposal[:g])  # [g]

        # one target forward over [last, p1..pg]: slot i's argmax is the
        # target's choice following chunk token i
        chunk_emb = target_lm.embed_tokens(torch.cat([last, proposal])[None])
        logits, t_cache = _chunk_forward(target_lm, chunk_emb.to(target_prompt.dtype), t_cache)
        t_argmax = torch.argmax(logits[0], dim=-1)  # [g+1]

        # the longest agreeing prefix; t_argmax[n_accept] is the correction
        # at the first disagreement, or the bonus token
        agree = (proposal == t_argmax[:g]).to(torch.int64)
        n_accept = torch.cumprod(agree, dim=0).sum()
        emit = torch.where(slots < n_accept, torch.cat([proposal, proposal[-1:]]),
                           t_argmax[n_accept])  # slots past n_accept are padding
        n_emit = n_accept + 1
        hit = torch.zeros((), dtype=torch.bool, device=dev)
        if eos_token_id is not None:
            hits = (emit == eos_token_id) & (slots < n_emit)
            eos_at = torch.where(hits, slots, torch.full_like(slots, buf)).min()
            n_emit = torch.minimum(n_emit, eos_at + 1)
            hit = hits.any()
        tokens[count: count + g + 1] = emit
        n_emit, hit = torch.stack([n_emit, hit.to(torch.int64)]).tolist()  # the chunk's one read

        # rewind both caches to the emitted history minus its newest token
        # (the loop-entry invariant), from the eos-truncated count
        back = (g + 1) - n_emit
        t_cache = t_cache._replace(index=t_cache.index - back)
        d_cache = d_cache._replace(index=d_cache.index - back)
        count += n_emit
        chunks += 1
        done = bool(hit) or count >= n

    count = min(count, n)
    tokens[count:] = 0  # the engine's pad, so tokens compare with generate's
    return {"tokens": tokens[:n][None].to(torch.int32),
            "lengths": torch.tensor([count], dtype=torch.int32, device=dev),
            "chunks": torch.tensor([chunks], dtype=torch.int32, device=dev)}


def _chunk_forward(lm, chunk_emb: torch.Tensor, cache):
    """The (gamma+1)-token verification forward -> (logits [1, T, V], cache).
    An LM marked `chunked_forward` continues its cache in one multi-token
    forward (JAX's `_forward_cached`); the int8 modules, which decode one
    position per row, and T5, which has no such attribute (JAX's int8
    adapters and its T5 have no `_forward_cached`), take one decode_step
    per chunk token: the same tokens, but each step streams the whole
    weights again, so such a target cannot beat its own plain greedy
    decode."""
    if getattr(lm, "chunked_forward", False):
        return lm.forward_cached(chunk_emb, cache)
    steps = []
    for i in range(chunk_emb.shape[1]):
        logits, cache = lm.decode_step(chunk_emb[:, i: i + 1], cache)
        steps.append(logits)
    return torch.stack(steps, dim=1), cache
