"""Judging served tokens against the plain reference.

A served token is judged at its position by the reference's logits there,
after the traffic's repetition penalty over the request's earlier tokens.
The top-p sampler may emit any token of the nucleus: the tokens above
which the probability mass is at most top_p. A token outside it is legal
for logits that differ from the reference's by some amount, and the number
compared is the least such amount: twice the smallest eps such that, with
the token's logit raised by eps and every other lowered by eps, the token
enters the nucleus (0 where it lies inside). It moves continuously with
the logits, where the distance to the nucleus' lowest logit jumps by a
whole gap between neighbouring logits when a small error moves the
nucleus' edge. With top_p 0 (greedy) it is the gap below the best logit.
"""

from __future__ import annotations

from typing import Optional

import torch

# A gap above this many logits is seldom the int8 decode's rounding at the
# nucleus' edge: sound runs of the serving cells put 0.1-0.4 % of their
# tokens above it, a sampler without the penalty or at top-p 0.95 5-11 %.
FAR_GAP = 0.5


def penalized(z: torch.Tensor, tokens: torch.Tensor, penalty: float) -> torch.Tensor:
    """z [L, V]: position k's logits after the CTRL penalty over tokens[:k]
    (divided where positive, multiplied where negative)."""
    n, v = z.shape
    onehot = torch.zeros(n, v, device=z.device)
    onehot[torch.arange(n, device=z.device), tokens] = 1.0
    seen = torch.cat([torch.zeros(1, v, device=z.device), onehot.cumsum(0)[:-1]]) > 0
    if penalty == 1.0:
        return z
    return torch.where(seen, torch.where(z < 0, z * penalty, z / penalty), z)


def nucleus_edge(zp: torch.Tensor, top_p: float) -> torch.Tensor:
    """[L] the lowest logit that top-p keeps in each row of zp [L, V]."""
    zs, _ = zp.sort(-1, descending=True)
    if top_p <= 0:
        return zs[:, 0]
    p = torch.softmax(zs, -1)
    before = p.cumsum(-1) - p
    return torch.where(before <= top_p, zs, torch.full_like(zs, float("inf"))).amin(-1)


def legal_gaps(zp: torch.Tensor, tokens: torch.Tensor, top_p: float,
               iters: int = 40) -> torch.Tensor:
    """[L] twice the least eps that puts tokens[k] in the nucleus of row k of
    the penalized logits zp [L, V] when its logit rises by eps and every
    other falls by eps (bisection; the mass above the token falls as eps
    grows)."""
    n, v = zp.shape
    rows = torch.arange(n, device=zp.device)
    zt = zp[rows, tokens]
    other = torch.ones_like(zp, dtype=torch.bool)
    other[rows, tokens] = False
    m = zp.amax(-1)
    lo = torch.zeros(n, device=zp.device)
    hi = torch.clamp_min((m - zt) / 2, 0.0) + 1e-6
    rel = zp - zt[:, None]

    def mass_above(eps):
        e = torch.exp(zp - eps[:, None] - m[:, None])
        den = torch.where(other, e, torch.zeros_like(e)).sum(-1) + torch.exp(zt + eps - m)
        num = torch.where(other & (rel > 2 * eps[:, None]), e, torch.zeros_like(e)).sum(-1)
        return num / den

    inside = mass_above(lo) <= top_p
    for _ in range(iters):
        mid = (lo + hi) / 2
        ok = mass_above(mid) <= top_p
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid)
    return torch.where(inside, torch.zeros_like(hi), 2 * hi)


def served_gaps(z: torch.Tensor, tokens: torch.Tensor, penalty: float,
                top_p: float) -> torch.Tensor:
    """[L] the gaps of tokens [L] served at the positions of z [L, V]; inf for
    an id outside the vocabulary."""
    if bool(((tokens < 0) | (tokens >= z.shape[1])).any()):
        return torch.full(tokens.shape, float("inf"))
    return legal_gaps(penalized(z, tokens, penalty), tokens, top_p)


def summary(gaps: torch.Tensor) -> dict:
    """The numbers judged over the gaps of a run's sampled tokens: the
    widest gap, and `far_share`, the share of tokens whose gap exceeds
    FAR_GAP. The widest gap alone misses a sampler that draws from the
    wrong set now and then (one without the repetition penalty, or with a
    wider top-p): its tokens lie a few logits off, as a rare rounding at the
    nucleus' edge can. With the share of tokens outside the nucleus, for
    the record."""
    n = max(len(gaps), 1)
    return {"served_gap": float(gaps.max()) if len(gaps) else 0.0,
            "far_share": float((gaps > FAR_GAP).sum()) / n,
            "outside_share": float((gaps > 0).sum()) / n}


def control_gaps(z: torch.Tensor, zc: torch.Tensor, tokens: torch.Tensor, penalty: float,
                 top_p: float, gen: Optional[torch.Generator] = None) -> dict:
    """The control's tokens at the positions of the served tokens: zc [L, V]
    are its logits, fed the same prompts and tokens. At each position it
    would emit a token of its own nucleus: `sampled` draws one (from its
    renormalized nucleus, with `gen`) and `first` is its best token. Each is
    judged as served_gaps judges a served token: {kind: gaps [L]}."""
    zp = penalized(z, tokens, penalty)
    zcp = penalized(zc, tokens, penalty)
    kept = zcp >= nucleus_edge(zcp, top_p)[:, None]
    probs = torch.where(kept, torch.softmax(zcp, -1), torch.zeros_like(zcp))
    sampled = torch.multinomial(probs.cpu(), 1, generator=gen)[:, 0].to(z.device)
    return {"sampled": legal_gaps(zp, sampled, top_p).cpu(),
            "first": legal_gaps(zp, zcp.argmax(-1), top_p).cpu()}
