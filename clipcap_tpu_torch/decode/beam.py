"""Beam search over prefix embeddings, KV-cached (port of
clipcap_tpu/decode/beam.py).

The decode semantics of the reference's generate_beam
(inference.py:70-148): log-softmax scores, length-normalised selection
(score sums / sequence lengths), stopped beams frozen (a stopped row offers
one 0-logprob continuation at column 0), '.'-token stopping, and the final
order by normalised score. Beams live in the batch axis of the KV cache,
image i's beams in rows [i*beam, (i+1)*beam); each step reorders the
cache's generated tail along that axis with a gather. An LM with the
shared-prefix beam protocol (`beam_prefix_cache`, the int8 GPT-2) keeps
the prefill K/V once per image instead and reorders only the tails, with
bit-equal logits (JAX beam.py:176-190).

Selection is plain torch ops, as it is plain XLA in the JAX package: no
kernel runs here. The f32 operations keep the JAX order (log_softmax of
logits / temperature, then scores + logp, then / seq_lengths). The host
reads nothing back inside the loop. A cross-attention cache (T5's encoder
output and mask bias) is repeated once per beam at the expansion and then
left alone: every beam of an image reads the same rows, so reordering them
would change no bit (JAX's `_CROSS_FIELDS`). A token-id adapter
(`lm.takes_token_ids`, the BLIP decoder's decoder_lm) takes an [N, P] int
prompt, picks its own cache dtype and is fed ids each step (JAX
beam.py:147-154, :194-197).

With a tracer active (utils/profiling.py), a call records the call-stack
span `beam.search` and, for each of its max_new_tokens - 1 steps, `beam.step`
tiled by `beam.step.select` (the log-softmax, the top-k, the gathers and the
cache reorder) and `beam.step.lm` (the next decode; none in the last step).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import profiling as P


#: cross-attention / encoder cache fields, with the axis their batch lives on
_CROSS_FIELDS = {"cross_k": 1, "cross_v": 1, "cross_bias": 0, "enc_hidden": 0, "enc_bias": 0}


def _beam_slabs(cache) -> dict:
    """The self-attention slabs that follow the beams, by field name: k and v,
    and the int8 cache's per-position scales ks and vs."""
    return {name: getattr(cache, name) for name in ("k", "v", "ks", "vs") if hasattr(cache, name)}


def _reorder_cache_tail(cache, global_source: torch.Tensor, p_len: int):
    """Beam-reorder the cache's batch axis over the generated tail only,
    positions [p_len, index): the prefix rows of an image's beams are equal
    (expanded from one prefilled row) and the gather stays within an image,
    so moving them would change no bit; positions from `index` on are not
    written yet. Time is axis 2 of the float cache and axis 3 of the int8
    one. The gather reads into a new tensor before the write-back, since it
    reads the slab it writes."""
    index = [slice(None)] * 4
    index[3 if hasattr(cache, "ks") else 2] = slice(p_len, cache.index)
    index = tuple(index)
    for slab in _beam_slabs(cache).values():
        slab[index] = slab[index].index_select(1, global_source)
    return cache


def _expand_beams(cache, beam_size: int):
    """Replicate each row of a prefilled cache beam_size times on the batch
    axis (row i*beam + b is image i): the self-attention slabs on their
    [L, B, ...] axis 1, the cross fields on their own batch axis."""
    upd = {name: slab.repeat_interleave(beam_size, dim=1)
           for name, slab in _beam_slabs(cache).items()}
    for name, axis in _CROSS_FIELDS.items():
        val = getattr(cache, name, None)
        if val is not None:
            upd[name] = val.repeat_interleave(beam_size, dim=axis)
    return cache._replace(**upd)


def _topk_iter(x: torch.Tensor, k: int):
    """Per-row top-k by k masked argmaxes: [N, M] -> ([N, k] values,
    [N, k] indices), values descending, ties lowest index first (argmax
    returns the first maximum: `lax.top_k`'s order). Beam search never
    asks for more picks than a row has finite entries."""
    cols = torch.arange(x.shape[-1], device=x.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1)
        vals.append(torch.gather(x, -1, i[:, None])[:, 0])
        idxs.append(i)
        x = torch.where(cols[None, :] == i[:, None], float("-inf"), x)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


@P.traced("beam.search")
@torch.no_grad()
def beam_search_batched(
    lm,  # LM module implementing the lm/registry protocol
    prompt_embeds: torch.Tensor,  # [N, P, D], or [N, P] ids for a token-id adapter
    beam_size: int = 5,
    max_new_tokens: int = 67,
    temperature: float = 1.0,
    stop_token_id: Optional[int] = None,
    device="cuda",
    cache_constraint=None,  # cache -> cache (multi-card hook, see engine.generate)
) -> dict:
    """Beam search over N images in one loop: returns {tokens [N, beam, n]
    int32, seq_lengths [N, beam] int32, scores [N, beam]}, where scores are
    the length-normalised log-probs that order the beams (reference
    inference.py:139-144). Per image it is exactly beam_search; selection
    stays within each image's beams. Runs on `device`, the card unless
    asked for the CPU; the LM and the prompt must lie there.

    `cache_constraint` is applied once to the fresh image cache. Under
    data parallelism each rank searches its images [lo, hi) and the result
    is all-gathered over `data`, as engine.generate does.

    The JAX loop decodes once more after the last step and drops the
    logits; this one skips that decode, which changes no output."""
    from ..parallel.dp import layout_of

    dev = torch.device(device)
    if prompt_embeds.device.type != dev.type:
        raise ValueError(f"prompt on {prompt_embeds.device}, beam search asked for {dev}")
    n_img, p_len = prompt_embeds.shape[:2]
    n = max_new_tokens
    temp = temperature if temperature > 0 else 1.0
    dev = prompt_embeds.device

    token_mode = bool(getattr(lm, "takes_token_ids", False))
    cache = lm.init_cache(n_img, p_len + n, dtype=None if token_mode else prompt_embeds.dtype)
    if cache_constraint is not None:
        cache = cache_constraint(cache)
    dp = layout_of(cache_constraint)
    if dp is not None:
        lo, hi = dp.rows(n_img)
        prompt_embeds, n_img = prompt_embeds[lo:hi], hi - lo
    logits, cache = lm.prefill(prompt_embeds, cache)
    logp = torch.log_softmax(logits[:, -1].float() / temp, dim=-1)  # [N, V]
    vocab = logp.shape[-1]

    # first expansion (reference :102-110)
    scores, first_tokens = _topk_iter(logp, beam_size)  # [N, beam]
    tokens = torch.zeros((n_img, beam_size, n), dtype=torch.int64, device=dev)
    tokens[:, :, 0] = first_tokens
    seq_lengths = torch.ones((n_img, beam_size), dtype=torch.float32, device=dev)
    has_stopped = (first_tokens == stop_token_id if stop_token_id is not None
                   else torch.zeros((n_img, beam_size), dtype=torch.bool, device=dev))
    shared_prefix = hasattr(lm, "beam_prefix_cache")
    if shared_prefix:  # prefill K/V once per image, a tail per beam row
        cache = lm.beam_prefix_cache(cache, beam_size, p_len)
        decode_fn = lm.decode_step_beam
    else:
        cache = _expand_beams(cache, beam_size)
        decode_fn = lm.decode_step

    def step_input(tok):  # tok [N*beam]
        if token_mode:
            return tok[:, None]
        return lm.embed_tokens(tok)[:, None, :].to(prompt_embeds.dtype)

    img_base = torch.arange(n_img, device=dev)[:, None] * beam_size
    # a stopped beam's row: -inf everywhere, 0 at column 0 (reference :112-113)
    frozen = torch.full((vocab,), float("-inf"), device=dev)
    frozen[0] = 0.0
    if n > 1:
        logits, cache = decode_fn(step_input(first_tokens.reshape(-1)), cache)
    tr = P.active()
    for step in range(1, n):
        if tr is not None:
            t0 = P.now_ns()
            tr.begin("beam.step", t0)
        logp = torch.log_softmax(logits.float() / temp, dim=-1).reshape(n_img, beam_size, vocab)
        logp = torch.where(has_stopped[:, :, None], frozen, logp)
        scores_sum = scores[:, :, None] + logp
        seq_lengths = seq_lengths + (~has_stopped).float()
        avg = scores_sum / seq_lengths[:, :, None]

        top_avg, flat_idx = _topk_iter(avg.reshape(n_img, beam_size * vocab), beam_size)
        source = flat_idx // vocab  # [N, beam], the beam within its image
        next_tok = flat_idx % vocab

        tokens = torch.gather(tokens, 1, source[:, :, None].expand(-1, -1, n))
        tokens[:, :, step] = next_tok
        seq_lengths = torch.gather(seq_lengths, 1, source)
        has_stopped = torch.gather(has_stopped, 1, source)
        scores = top_avg * seq_lengths

        global_source = (img_base + source).reshape(-1)  # within each image
        if shared_prefix:
            cache = lm.reorder_beam_tail(cache, global_source)
        else:
            cache = _reorder_cache_tail(cache, global_source, p_len)
        if stop_token_id is not None:
            has_stopped = has_stopped | (next_tok == stop_token_id)
        if tr is not None:
            t1 = P.now_ns()
            tr.add("beam.step.select", t0, t1)
        if step + 1 < n:  # the last step's logits would go unused
            logits, cache = decode_fn(step_input(next_tok.reshape(-1)), cache)
            if tr is not None:
                t2 = P.now_ns()
                tr.add("beam.step.lm", t1, t2)
        if tr is not None:
            tr.end(t2 if step + 1 < n else t1)

    out = {"tokens": tokens.to(torch.int32),
           "seq_lengths": seq_lengths.to(torch.int32),
           "scores": scores / seq_lengths}  # final normalisation (reference :139)
    return out if dp is None else {k: dp.gather(v) for k, v in out.items()}


def beam_search(lm, prompt_embeds: torch.Tensor, beam_size: int = 5, max_new_tokens: int = 67,
                temperature: float = 1.0, stop_token_id: Optional[int] = None,
                device="cuda", cache_constraint=None) -> dict:
    """Single-image beam search (the reference generate_beam contract):
    prompt_embeds [1, P, D] -> {tokens [beam, n], seq_lengths [beam],
    scores [beam]}; beam_search_batched at N = 1."""
    if prompt_embeds.shape[0] != 1:
        raise ValueError("beam_search expects a single prompt (batch 1); use "
                         "beam_search_batched for N images")
    out = beam_search_batched(lm, prompt_embeds, beam_size=beam_size,
                              max_new_tokens=max_new_tokens, temperature=temperature,
                              stop_token_id=stop_token_id, device=device,
                              cache_constraint=cache_constraint)
    return {k: v[0] for k, v in out.items()}


def _host(result: dict):
    return (result["tokens"].cpu().numpy(), result["seq_lengths"].cpu().numpy(),
            result["scores"].cpu().numpy())


def best_beam_text(result: dict, tokenizer) -> str:
    """Decode the highest-scoring beam of a beam_search result (reference
    :140-144), ordered by the same numpy call as the JAX package, so that
    equal scores resolve the same way."""
    tokens, lengths, scores = _host(result)
    best = int(scores.argsort()[::-1][0])
    return tokenizer.decode_tokens([int(t) for t in tokens[best][: int(lengths[best])]])


def best_beam_texts(result: dict, tokenizer) -> list:
    """The best beam of each image of a beam_search_batched result, in one
    copy to the host."""
    tokens, lengths, scores = _host(result)
    out = []
    for i in range(tokens.shape[0]):
        best = int(np.argmax(scores[i]))
        out.append(tokenizer.decode_tokens([int(t) for t in tokens[i, best][: int(lengths[i, best])]]))
    return out
