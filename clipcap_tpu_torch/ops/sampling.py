"""Logit filters and penalties for decoding (port of clipcap_tpu/ops/sampling.py).

The sort-based filters (`top_k_top_p_filter` with its `prefilter_k`
candidate set, `typical_filter`), the sort-free threshold filters
(`top_k_top_p_filter_threshold`, `typical_filter_threshold`), the
repetition-penalty pieces (`token_occurrence_mask`, `repetition_penalty`),
`sentence_length_penalty` and `sample_categorical`.

All filters take logits [B, V] and return filtered logits with masked
entries set to -inf. Hyperparameters are Python scalars or per-row [B]
vectors (tensors, numpy arrays or sequences).

Sort order is the JAX package's: an ascending stable sort of -logits
(`jnp.argsort(-x)`) lists tied values lowest index first, which is also
`lax.top_k`'s order, so the prefilter's candidate set is taken from the
same stable sort (`torch.topk` promises no tie order). Cumulative sums
run in torch's order, so a kept set may differ from JAX's only where a
top-p lies within f32 rounding of a cumulative mass.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = float("-inf")


def per_row(x, batch: int, device, dtype=torch.float32) -> torch.Tensor:
    """Scalar or [B] setting -> [B] tensor on `device`."""
    t = torch.as_tensor(x, dtype=dtype).to(device) if not torch.is_tensor(x) \
        else x.to(device=device, dtype=dtype)
    if t.dim() == 0:
        t = t.expand(batch)
    return t.reshape(batch)


def is_active(x) -> bool:
    """True unless the setting is all zeros (gates a filter's full-vocab passes)."""
    if isinstance(x, (bool, int, float)):
        return x != 0
    if torch.is_tensor(x):
        return bool((x != 0).any())
    arr = np.asarray(x)
    if not np.issubdtype(arr.dtype, np.number) and arr.dtype != bool:
        raise TypeError(f"invalid sampling setting {x!r} (dtype {arr.dtype}): expected numeric")
    return bool((arr != 0).any())


def bisect_desc(pred, lo: torch.Tensor, hi: torch.Tensor, iters: int):
    """Per-row bisection: pred is monotone decreasing in t; returns the
    (lo, hi) bracket after `iters` halvings, lo the largest t seen where
    pred holds."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = pred(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo, hi


def resolve_top_k_rows(k: torch.Tensor, vocab: int) -> torch.Tensor:
    """Reference top-k resolution (sampling.py:126-148): 0 disables,
    0<k<1 keeps max(1, floor(k*V)), k>=1 keeps floor(k); clipped to [0, V]."""
    frac = (k > 0) & (k < 1)
    k_eff = torch.where(frac, torch.clamp(torch.floor(k * vocab), min=1.0), torch.floor(k))
    return torch.clamp(k_eff, 0, vocab)


def _sort_desc(x: torch.Tensor):
    """(values, indices) of each row in descending order, ties lowest index
    first (`jnp.argsort(-x)`, which is stable)."""
    idx = torch.sort(-x, dim=-1, stable=True).indices
    return torch.gather(x, -1, idx), idx


def _unsort_mask(sorted_mask: torch.Tensor, sorted_idx: torch.Tensor) -> torch.Tensor:
    """Scatter a mask computed in sorted order back to the original order."""
    return torch.empty_like(sorted_mask).scatter_(-1, sorted_idx, sorted_mask)


def _host_values(x) -> np.ndarray:
    """A setting's values on the host, as f64 (the prefilter's exactness guard)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def top_k_top_p_filter(
    logits: torch.Tensor,
    top_k=0,
    top_p=0.0,
    filter_value: float = NEG_INF,
    prefilter_k: int = 0,
    _tail_lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sort-based top-k + nucleus filtering with per-row settings
    (reference sampling.py:114-162). k <= 0 disables, 0 < k < 1 keeps
    max(1, floor(k*V)) tokens, k >= 1 keeps floor(k) (ties at the k-th
    value survive); p <= 0 disables, else the smallest top set whose mass
    exceeds p is kept, the crossing token included.

    prefilter_k > 0 runs the filter on the top prefilter_k candidates,
    with the excluded tail's mass kept in the nucleus denominator for rows
    without an active top-k. It falls back to the full sort wherever it
    could be inexact: an effective top-k above prefilter_k, or a top-p of
    0.995 or more. The port's settings are always concrete, so the guard
    always applies, as in the JAX function run eagerly."""
    batch, vocab = logits.shape
    logits = logits.float()
    dev = logits.device

    if prefilter_k and prefilter_k < vocab:
        k_host, p_host = _host_values(top_k), _host_values(top_p)
        k_abs_host = np.where((k_host > 0) & (k_host < 1),
                              np.maximum(1.0, np.floor(k_host * vocab)), k_host)
        if (k_abs_host > prefilter_k).any() or (p_host >= 0.995).any():
            prefilter_k = 0

    if prefilter_k and prefilter_k < vocab:
        # resolve fractional top-k against the whole vocabulary first
        k_in = per_row(top_k, batch, dev)
        k_abs = torch.where((k_in > 0) & (k_in < 1),
                            torch.clamp(torch.floor(k_in * vocab), min=1.0), k_in)
        vals, idx = _sort_desc(logits)
        vals, idx = vals[:, :prefilter_k], idx[:, :prefilter_k]
        lse_full = torch.logsumexp(logits, dim=-1)
        lse_top = torch.logsumexp(vals, dim=-1)
        delta = torch.clamp(lse_top - lse_full, max=-1e-9)
        tail_lse = lse_full + torch.log1p(-torch.exp(delta))
        tail_lse = torch.where(k_abs > 0, torch.full_like(tail_lse, NEG_INF), tail_lse)
        filtered = top_k_top_p_filter(vals, k_abs, top_p, filter_value, prefilter_k=0,
                                      _tail_lse=tail_lse)
        full = torch.full((batch, vocab), filter_value, dtype=torch.float32, device=dev)
        return full.scatter_(1, idx, filtered)

    k = per_row(top_k, batch, dev)
    p = per_row(top_p, batch, dev)
    neg = torch.full((), filter_value, dtype=torch.float32, device=dev)

    # top-k: cutoff at the k-th largest value; values below it go, ties stay
    sorted_logits, _ = _sort_desc(logits)
    k_eff = resolve_top_k_rows(k, vocab).to(torch.int64)
    gather_at = torch.clamp(k_eff - 1, 0, vocab - 1)[:, None]
    cutoff = torch.gather(sorted_logits, -1, gather_at)
    logits = torch.where((k_eff > 0)[:, None] & (logits < cutoff), neg, logits)

    # top-p over the (top-k-filtered) row
    sorted_logits, sorted_idx = _sort_desc(logits)
    if _tail_lse is None:
        probs = torch.softmax(sorted_logits, dim=-1)
    else:
        denom = torch.logaddexp(torch.logsumexp(sorted_logits, dim=-1), _tail_lse)
        probs = torch.exp(sorted_logits - denom[:, None])
    remove = torch.cumsum(probs, dim=-1) > p[:, None]
    # shift right so the token that crosses p is kept
    remove = torch.cat([torch.zeros_like(remove[:, :1]), remove[:, :-1]], dim=-1)
    remove = _unsort_mask(remove & (p > 0.0)[:, None], sorted_idx)
    return torch.where(remove, neg, logits)


def typical_filter(
    logits: torch.Tensor,
    typ_p=0.0,
    min_tokens_to_keep: int = 1,
    filter_value: float = NEG_INF,
) -> torch.Tensor:
    """Typical decoding (reference sampling.py:72-102): keep the tokens
    whose -log p lies closest to the entropy, in that order, until their
    mass reaches typ_p (the boundary token included). typ_p <= 0 disables."""
    batch, vocab = logits.shape
    logits = logits.float()
    dev = logits.device
    tp = per_row(typ_p, batch, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    log_probs = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(log_probs)
    entropy = -torch.where(probs > 0, log_probs * probs, zero).sum(dim=-1, keepdim=True)
    shifted = torch.abs(log_probs + entropy)  # distance from typicality

    sorted_scores, order = torch.sort(shifted, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    last_ind = torch.clamp((cum < tp[:, None]).sum(dim=-1, keepdim=True), 0, vocab - 1)
    cutoff_score = torch.gather(sorted_scores, -1, last_ind)
    sorted_remove = sorted_scores > cutoff_score
    if min_tokens_to_keep > 1:
        sorted_remove &= torch.arange(vocab, device=dev)[None, :] >= min_tokens_to_keep
    remove = _unsort_mask(sorted_remove, order) & (tp > 0.0)[:, None]
    return torch.where(remove, torch.full((), filter_value, device=dev), logits)


def top_k_top_p_filter_threshold(
    logits: torch.Tensor,
    top_k=0,
    top_p=0.0,
    filter_value: float = NEG_INF,
    iters: int = 40,
) -> torch.Tensor:
    """Sort-free top-k + nucleus filtering by per-row threshold bisection
    (same semantics as the JAX function: ties at the boundary all survive)."""
    batch, vocab = logits.shape
    logits = logits.float()
    dev = logits.device
    k = per_row(top_k, batch, dev)
    p = per_row(top_p, batch, dev)
    neg = torch.full((), filter_value, dtype=torch.float32, device=dev)

    finite = torch.isfinite(logits)
    finite_min = torch.where(finite, logits, torch.full_like(logits, float("inf"))
                             ).amin(dim=-1, keepdim=True)
    hi0 = logits.amax(dim=-1, keepdim=True)

    if is_active(top_k):
        k_eff = resolve_top_k_rows(k, vocab)[:, None]

        def count_pred(mid):
            return (logits >= mid).float().sum(dim=-1, keepdim=True) >= k_eff

        lo, _ = bisect_desc(count_pred, finite_min, hi0, iters)
        logits = torch.where((k_eff > 0) & (logits < lo), neg, logits)

    if is_active(top_p):
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(logits - lse)
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def mass_pred(mid):
            return torch.where(logits >= mid, probs, zero).sum(dim=-1, keepdim=True) > p[:, None]

        lo, _ = bisect_desc(mass_pred, hi0 - 100.0, hi0, iters)
        keep = (logits >= lo) | (p[:, None] <= 0.0)
        logits = torch.where(keep, logits, neg)
    return logits


def typical_filter_threshold(
    logits: torch.Tensor,
    typ_p=0.0,
    filter_value: float = NEG_INF,
    iters: int = 40,
) -> torch.Tensor:
    """Sort-free typical filter: keep the tokens whose surprise |-log p - H|
    is smallest until their mass reaches typ_p (boundary token included)."""
    batch, _ = logits.shape
    logits = logits.float()
    dev = logits.device
    t = per_row(typ_p, batch, dev)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    entropy = -torch.where(probs > 0, probs * logp, zero).sum(dim=-1, keepdim=True)
    score = torch.abs(-logp - entropy)  # ascending = more typical

    lo = torch.zeros_like(entropy)
    hi = torch.where(torch.isfinite(score), score, zero).amax(dim=-1, keepdim=True)

    def pred(mid):
        return torch.where(score <= mid, probs, zero).sum(dim=-1, keepdim=True) < t

    _, hi_f = bisect_desc(pred, lo, hi, iters)
    keep = (score <= hi_f) | (t <= 0.0)
    return torch.where(keep, logits, torch.full((), filter_value, device=dev))


def token_occurrence_mask(
    tokens: torch.Tensor,  # [B, T] token ids
    vocab: int,
    tokens_valid: Optional[torch.Tensor] = None,  # [B, T] bool
) -> torch.Tensor:
    """[B, V] bool: which vocab ids appear in each row's valid tokens."""
    batch = tokens.shape[0]
    if tokens_valid is None:
        tokens_valid = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    appears = torch.zeros((batch, vocab), dtype=torch.int8, device=tokens.device)
    safe = tokens.long().clamp(0, vocab - 1)
    appears.scatter_reduce_(1, safe, tokens_valid.to(torch.int8), reduce="amax")
    return appears.bool()


def repetition_penalty(
    logits: torch.Tensor,  # [B, V]
    tokens: torch.Tensor,  # [B, T] already-generated token ids
    penalty,
    tokens_valid: Optional[torch.Tensor] = None,  # [B, T] bool
) -> torch.Tensor:
    """CTRL-style repetition penalty (reference sampling.py:65-69): logits
    of seen tokens are multiplied by `penalty` when negative and divided
    when positive."""
    batch, vocab = logits.shape
    logits = logits.float()
    appears = token_occurrence_mask(tokens, vocab, tokens_valid)
    # a Python scalar is filled on the device: a tensor made on the host
    # would cost a host-to-device copy (and a sync) every decode step
    pen = (torch.full((batch, 1), float(penalty), device=logits.device)
           if isinstance(penalty, (int, float)) else per_row(penalty, batch, logits.device)[:, None])
    penalized = torch.where(logits < 0, logits * pen, logits / pen)
    return torch.where(appears, penalized, logits)


def sentence_length_penalty(
    logits: torch.Tensor,  # [B, V]
    stop_token: int,
    current_length,
    desired_length: int,
    length_factor: float = 1.0,
) -> torch.Tensor:
    """Scale the stop token's logit by (current_length/desired_length)*factor
    (the documented intent of reference inference.py:59-68)."""
    batch, _ = logits.shape
    logits = logits.float().clone()
    scale = (per_row(current_length, batch, logits.device) / desired_length) * length_factor
    logits[:, stop_token] = logits[:, stop_token] * scale
    return logits


def first_index_of_max(values: torch.Tensor):
    """Row-wise (argmax, max) with first-index tie semantics (the rule of
    `lax.top_k`): max-reduce, then min-reduce the matching indices."""
    vocab = values.shape[-1]
    m = values.amax(dim=-1, keepdim=True)
    iota = torch.arange(vocab, device=values.device)
    idx = torch.where(values == m, iota, vocab).amin(dim=-1, keepdim=True)
    return idx, m


def gumbel_like(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise of logits' shape from `generator` (f32)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_categorical(
    logits: torch.Tensor,
    num_samples: int = 1,
    *,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sampling without replacement by the Gumbel-top-k trick
    (torch.multinomial(p, n, replacement=False) in distribution).

    `gumbel` injects the perturbation (tests feed JAX's draws); otherwise
    it is drawn from `generator`. Ties go to the first index, as
    `lax.top_k` breaks them. Returns [B, num_samples] int32."""
    if gumbel is None:
        gumbel = gumbel_like(logits, generator)
    pert = logits.float() + gumbel.float()
    vocab = pert.shape[-1]
    iota = torch.arange(vocab, device=pert.device)
    taken = torch.zeros(pert.shape, dtype=torch.bool, device=pert.device)
    out = []
    for _ in range(num_samples):
        # a taken index never comes back, even when every value left is -inf
        vals = pert.masked_fill(taken, float("-inf"))
        m = vals.amax(dim=-1, keepdim=True)
        idx = torch.where((vals == m) & ~taken, iota, vocab).amin(dim=-1, keepdim=True)
        out.append(idx)
        taken = taken | (iota == idx)
    return torch.cat(out, dim=1).to(torch.int32)
