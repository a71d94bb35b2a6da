"""CLIP-guided lookahead decoding over a KV-cached tree (port of
clipcap_tpu/decode/clip_guided.py: generate_clip_guided and
generate_clip_guided_batch; reference evaluate_model.py:183-310).

Each chunk expands branching_factor^depth greedy continuations of every
image's committed caption, decodes each candidate's text, embeds it with
the CLIP text tower, and commits the candidate whose embedding is most
cosine-similar to the image's CLIP embedding: the whole lookahead, or one
token with step_by_step. Decoding ends at a special token or at
max_decode_length.

The tree is KV-cached, as in JAX. The committed prefix lives in a batch-N
decode cache carried across chunks, and each tree level is one
`decode_step` over the live rows (N, N*k, ... N*k^(depth-1)); at each
branch the cache rows replicate k-fold on the batch axis, children of row r
at rows [r*k, (r+1)*k), so rows stay image-blocked. BOS is not prefilled:
it is the first chunk's `tok_last`, which that chunk's level-0 step
decodes, so the cache handed across chunks covers positions [0, nv-1) with
`tok_last` at position nv-1. Top-k takes the lowest index first among
equal logits (`lax.top_k`'s order) through decode/beam._topk_iter, and the
repetition penalty runs over a device-side history that grows by one
column per level.

The host reads the tree once per chunk (every level's [rows, k] ids in one
copy) and the candidates' CLIP scores once; nothing in the level loop
reads a device value. Early-stopped leaves stay in the batch: their
descendants' rows are ignored on the host, and the junk they write lies
beyond the committed positions, where the next chunk overwrites it or
never attends it. The chosen candidate's level-(depth-1) parent row
(`best_row // k`) holds exactly the committed positions, so the next
chunk's cache is a device gather of those rows with the index set to
p_len + committed_len - 1 (step_by_step rewinds it below the tree's
writes; the port's decode steps, float and int8, attend positions
[0, index] only).

Batching across images: every live image commits the same number of
tokens per chunk (an image whose chosen candidate stops is finished), so
the N trees stack into one row-blocked batch, and finished images ride
along as ignored rows. Per-image results equal N single calls exactly on
the CPU in f32.

The tree decodes on `bundle.lm_decode`, so `bundle.enable_int8_decode()`
runs it on the int8 LM and its int8 cache, as in JAX.

What stays behind: JAX caches its jitted level closures on the bundle
(`_clip_guided_level_cache`); eager PyTorch has no compile cache to keep.
Cross-attention caches are refused, as in JAX.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.sampling import repetition_penalty
from .beam import _beam_slabs, _expand_beams, _topk_iter


def _replicate_rows(cache, k: int):
    """Replicate every self-attention cache slab k-fold on the batch axis:
    children of row r land at rows [r*k, (r+1)*k)."""
    if hasattr(cache, "cross_k") or hasattr(cache, "enc_hidden"):
        raise NotImplementedError(
            "clip-guided decode supports self-attention cache LMs (gpt2/gptj); cross-attention "
            "caches are per-image and do not follow the tree's row replication")
    return _expand_beams(cache, k)


def _gather_rows(cache, idx: torch.Tensor, new_index: int):
    """Select cache rows on the batch axis (k and v, and the int8 cache's
    scales ks and vs) and set the write index (step_by_step rewinds it
    below junk tree positions)."""
    return cache._replace(index=new_index, **{name: slab.index_select(1, idx)
                                              for name, slab in _beam_slabs(cache).items()})


def _expand_tree(lm, cache, tok_last: torch.Tensor, hist: torch.Tensor,
                 hist_valid: torch.Tensor, depth: int, k: int, penalty: float,
                 committed_len: int, act_dtype):
    """The greedy top-k tree of one chunk, on the device: a level-0 decode
    step on tok_last [R0], then a k-fold replication and a decode step per
    level. hist/hist_valid [R0, max_decode_length] hold the committed
    tokens for the repetition penalty; each level appends the row's own
    token at column committed_len + d. Returns (each level's top-k ids
    [R0*k^d, k], the final cache at R0*k^(depth-1) rows)."""
    tok, outs = tok_last, []
    for d in range(depth):
        rows = tok.shape[0]
        logits, cache = lm.decode_step(lm.embed_tokens(tok[:, None]).to(act_dtype), cache)
        logits = logits.float()
        if penalty != 1.0:
            logits = repetition_penalty(logits, hist, penalty, tokens_valid=hist_valid)
        _, topk = _topk_iter(logits, k)
        outs.append(topk)
        if d + 1 < depth:
            cache = _replicate_rows(cache, k)
            tok = topk.reshape(rows * k)
            # dead rows accumulate junk history too; the host ignores their ids
            hist = hist.repeat_interleave(k, dim=0)
            hist[:, committed_len + d] = tok
            hist_valid = hist_valid.repeat_interleave(k, dim=0)
            hist_valid[:, committed_len + d] = True
    return outs, cache


def _candidates(topk_levels, committed, done, k: int, depth: int, special) -> list:
    """Per image, the tree's candidates as (tokens, global final-level row,
    stopped). An early-stopped leaf at level d maps to its first
    descendant's final row (i*k^depth + row*k^(depth-1-d)), whose parent
    (row // k) holds the candidate's committed positions. Finished images
    give an empty list."""
    per_image = []
    kd = k ** depth
    for i, base in enumerate(committed):
        if done[i]:
            per_image.append([])
            continue
        candidates, tokens_list, live = [], [base], [True]
        for d in range(depth):
            rd = k ** d  # rows per image at this level
            topk = topk_levels[d][i * rd: (i + 1) * rd]
            desc = k ** (depth - 1 - d)  # a level-d child's first final row
            new_tokens, new_live, any_kept = [], [], False
            for r, toks in enumerate(tokens_list):
                for j in range(k):
                    row = r * k + j
                    if not live[r]:
                        # child of an early-stopped leaf: a dead padding row
                        new_tokens.append(toks)
                        new_live.append(False)
                        continue
                    nt = int(topk[r, j])
                    seq = toks + [nt]
                    new_tokens.append(seq)
                    if nt in special or d == depth - 1:
                        candidates.append((seq, i * kd + row * desc, nt in special))
                        new_live.append(False)
                    else:
                        new_live.append(True)
                        any_kept = True
            tokens_list, live = new_tokens, new_live
            if not any_kept:
                break
        per_image.append(candidates)
    return per_image


def _best_candidate(scores: np.ndarray) -> int:
    """The first index of the highest score (np.argmax's rule, as JAX)."""
    return int(np.argmax(scores))


@torch.no_grad()
def generate_clip_guided_tokens(
    bundle,  # models.bundle.CaptionerBundle
    clip_scoring,  # eval.clip_scoring.ClipScoring (embed_text)
    clip_image_embeddings: torch.Tensor,  # [N, D]
    prefix_embeds: torch.Tensor,  # [N, P, D] mapper output
    max_decode_length: int = 75,
    repetition_penalty_value: float = 1.2,
    look_ahead: int = 5,
    branching_factor: int = 3,
    step_by_step: bool = False,
    device="cuda",
) -> List[List[int]]:
    """N independent clip-guided decodes sharing every step: each image's
    committed token ids, special tokens included. Runs on `device`, the
    card unless asked for the CPU; the bundle and the prefix must lie
    there."""
    if max_decode_length > 77:
        raise ValueError("maximum context length for CLIP models is 77")
    if prefix_embeds.device.type != torch.device(device).type:
        raise ValueError(f"prefix on {prefix_embeds.device}, clip-guided decode asked for "
                         f"{device}")
    dev = prefix_embeds.device
    tokenizer = bundle.tokenizer
    special = set(tokenizer.all_special_ids)
    lm = bundle.lm_decode
    k = branching_factor
    n_img = prefix_embeds.shape[0]

    imgs = torch.as_tensor(clip_image_embeddings, device=dev).float().reshape(n_img, -1)
    imgs = imgs / torch.linalg.vector_norm(imgs, dim=-1, keepdim=True)

    bos_id = int(tokenizer.bos_token_id)
    # BOS follows the prefix (reference evaluate_model.py:253-257) as the
    # first chunk's tok_last
    p_len = prefix_embeds.shape[1] + 1
    act_dtype = prefix_embeds.dtype
    committed: List[List[int]] = [[] for _ in range(n_img)]
    done = [False] * n_img
    committed_len = 0  # the same for every live image
    cache = lm.init_cache(n_img, p_len + max_decode_length, dtype=act_dtype)
    _, cache = lm.prefill(prefix_embeds, cache)  # positions [0, p_len - 1)
    tok_last = np.full(n_img, bos_id, np.int64)

    while True:
        depth = max(min(look_ahead, max_decode_length - committed_len), 1)
        hist = np.zeros((n_img, max_decode_length), np.int64)
        valid = np.zeros(hist.shape, bool)
        for i, toks in enumerate(committed):
            hist[i, : len(toks)] = toks
            valid[i, : len(toks)] = True
        outs, cache_out = _expand_tree(
            lm, cache, torch.from_numpy(tok_last).to(dev), torch.from_numpy(hist).to(dev),
            torch.from_numpy(valid).to(dev), depth, k, repetition_penalty_value, committed_len,
            act_dtype)
        flat = torch.cat([o.reshape(-1) for o in outs]).cpu().numpy()  # the tree's one read
        bounds = np.cumsum([0] + [o.numel() for o in outs])
        topk_levels = [flat[a:b].reshape(-1, k) for a, b in zip(bounds[:-1], bounds[1:])]
        per_image = _candidates(topk_levels, committed, done, k, depth, special)

        # one CLIP text batch over every live image's candidates
        texts, slices = [], [None] * n_img
        for i, cands in enumerate(per_image):
            if cands:
                start = len(texts)
                texts.extend(tokenizer.decode_tokens([t for t in c[0] if t not in special])
                             for c in cands)
                slices[i] = (start, len(texts))
        feats = torch.as_tensor(clip_scoring.embed_text(texts), device=dev).float()
        # the eps guard is JAX's deliberate divergence from the reference: a
        # zero text feature (an all-special candidate) would give 0/0
        feats = feats / torch.clamp(torch.linalg.vector_norm(feats, dim=-1, keepdim=True),
                                    min=1e-8)
        scores = (feats @ imgs.T).cpu().numpy().astype(np.float32)  # [C, N]

        rows_parent = np.arange(n_img, dtype=np.int64) * k ** max(depth - 1, 0)
        for i, cands in enumerate(per_image):
            if not cands:
                continue
            lo, hi = slices[i]
            best_tokens, best_row, stopped = cands[_best_candidate(scores[lo:hi, i])]
            rows_parent[i] = best_row // k
            if step_by_step:
                committed[i] = best_tokens[: committed_len + 1]
                if committed_len + 1 >= max_decode_length or committed[i][-1] in special:
                    done[i] = True
            else:
                committed[i] = best_tokens
                if stopped or len(best_tokens) >= max_decode_length:
                    done[i] = True

        if all(done):
            break
        committed_len += 1 if step_by_step else depth
        cache = _gather_rows(cache_out, torch.from_numpy(rows_parent).to(dev),
                             p_len + committed_len - 1)
        tok_last = np.asarray([c[-1] if c else bos_id for c in committed], np.int64)
    return committed


def generate_clip_guided_batch(bundle, clip_scoring, clip_image_embeddings, prefix_embeds,
                               max_decode_length: int = 75,
                               repetition_penalty_value: float = 1.2, look_ahead: int = 5,
                               branching_factor: int = 3, step_by_step: bool = False,
                               device="cuda") -> List[str]:
    """Each of N images' clip-guided caption, special tokens stripped
    (generate_clip_guided_tokens, decoded)."""
    special = set(bundle.tokenizer.all_special_ids)
    committed = generate_clip_guided_tokens(
        bundle, clip_scoring, clip_image_embeddings, prefix_embeds,
        max_decode_length=max_decode_length, repetition_penalty_value=repetition_penalty_value,
        look_ahead=look_ahead, branching_factor=branching_factor, step_by_step=step_by_step,
        device=device)
    return [bundle.tokenizer.decode_tokens([t for t in toks if t not in special])
            for toks in committed]


def generate_clip_guided(bundle, clip_scoring, clip_image_embedding, prefix_embeds,
                         max_decode_length: int = 75, repetition_penalty_value: float = 1.2,
                         look_ahead: int = 5, branching_factor: int = 3,
                         step_by_step: bool = False, device="cuda") -> str:
    """One image's clip-guided caption: clip_image_embedding [1, D] or [D],
    prefix_embeds [1, P, D]."""
    return generate_clip_guided_batch(
        bundle, clip_scoring, torch.as_tensor(clip_image_embedding).reshape(1, -1),
        prefix_embeds, max_decode_length=max_decode_length,
        repetition_penalty_value=repetition_penalty_value, look_ahead=look_ahead,
        branching_factor=branching_factor, step_by_step=step_by_step, device=device)[0]
