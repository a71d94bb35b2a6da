"""Dropless routed experts: DeepSeek-V3's sigmoid router and the experts'
SwiGLU products over tokens sorted by expert.

The JAX package has no such layer (its only mixture of experts, the
mapper's models/moe.py, routes top-1/top-2 with a capacity and drops what
overflows), so nothing here replaces a TPU kernel. Every token reaches
each of its k experts whatever the load: the sort and the group offsets
are computed on the device, and no count is read on the host, so a decode
step never waits for the card inside the layer.

On the card the two products (gate+up, then down) are grouped GEMMs over
the experts' stacked weights (`torch._grouped_mm`, bf16 on sm90): one
launch each, every expert's weights read once, each expert's rows a
contiguous block of the sorted tokens. At a decode step of 512 slots
these products stream the 553 M routed weights of a layer and are bound
by memory bandwidth. On the CPU the same products are a plain loop over
the experts (`grouped_mm_plain`), the version the tests run. The groups
need no alignment: torch._grouped_mm at unaligned group ends matched the
plain loop on the card.

Given an `ExpertLog`, each call appends its experts' token counts to it
on the device: no copy to the host until the log is read, and the same
launches at every call, so a CUDA graph that replays the layer writes the
log too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class ExpertLog:
    """The routed experts' token counts of every MoE call, kept on the
    device: `counts` [capacity, E] int32, a ring written at `cursor` (a
    [1] int64 device counter of the calls so far). A reader clones the
    cursor where it wants a mark, which waits for nothing, and reads the
    calls between two marks after the card has run them (`read`)."""

    def __init__(self, capacity: int, n_experts: int, device):
        self.counts = torch.zeros(capacity, n_experts, dtype=torch.int32, device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)

    def record(self, counts: torch.Tensor) -> None:
        at = torch.remainder(self.cursor, self.counts.shape[0])
        self.counts.index_copy_(0, at, counts[None].to(torch.int32))
        self.cursor += 1

    def mark(self) -> torch.Tensor:
        """The cursor as the card will have it once the work issued so far
        has run (a device copy: read it later)."""
        return self.cursor.clone()

    def read(self, start: int, end: int) -> np.ndarray:
        """[end - start, E] counts of the calls [start, end); needs the
        card to have run them and end - start <= capacity."""
        cap = self.counts.shape[0]
        if not 0 <= end - start <= cap:
            raise ValueError(f"{end - start} calls do not fit a log of {cap}")
        rows = torch.arange(start, end, device=self.counts.device) % cap
        return self.counts.index_select(0, rows).cpu().numpy()


def route(x: torch.Tensor, gate_w: torch.Tensor, bias: torch.Tensor, k: int,
          scale: float, norm_topk: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router ("noaux_tc" with one group): sigmoid scores in
    f32 over the experts, the top k of score + bias chosen, and the chosen
    scores WITHOUT the bias as weights, normalized to sum 1 (norm_topk),
    times `scale`. x [N, D], gate_w [E, D], bias [E] -> (experts [N, k]
    int64, weights [N, k] f32)."""
    scores = torch.sigmoid(F.linear(x.float(), gate_w.float()))
    experts = torch.topk(scores + bias.float(), k, dim=-1, sorted=False).indices
    weights = scores.gather(-1, experts)
    if norm_topk:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return experts, weights * scale


def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """x [M, K] sorted by group, w [E, N, K] (each group's [out, in]), offs
    [E] int32 cumulative row ends -> [M, N]: rows offs[e-1]:offs[e] times
    w[e].T, one product per expert."""
    out = x.new_zeros(x.shape[0], w.shape[1])
    ends = offs.tolist()
    lo = 0
    for e, hi in enumerate(ends):
        if hi > lo:
            out[lo:hi] = x[lo:hi] @ w[e].T
        lo = hi
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """grouped_mm_plain's product: on the card one grouped GEMM
    (`torch._grouped_mm` over w's [E, K, N] view, which is column-major per
    expert), on the CPU the plain loop."""
    if x.device.type != "cuda":
        return grouped_mm_plain(x, w, offs)
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up over the halves [gate | up] of the last axis."""
    g, u = gate_up.chunk(2, dim=-1)
    return F.silu(g) * u


def routed_experts(x: torch.Tensor, experts: torch.Tensor, weights: torch.Tensor,
                   w_gate_up: torch.Tensor, w_down: torch.Tensor,
                   log: Optional[ExpertLog] = None) -> torch.Tensor:
    """The routed experts' weighted sum for each token, dropless.

    x [N, D] in the experts' dtype, experts/weights [N, k] from `route`,
    w_gate_up [E, 2F, D] ([gate | up] rows), w_down [E, D, F]. The N*k
    (token, expert) pairs are sorted by expert (stable), gathered, run
    through the two grouped products (each expert's rows one contiguous
    group, the groups' ends counted on the device), put back in pair order
    and summed over each token's k pairs in f32 with their weights. With
    `log`, the call's tokens per expert are appended to it. Returns [N, D]
    f32."""
    n, k = experts.shape
    grouped, order = torch.sort(experts.reshape(-1), stable=True)
    # each group's end by a search of the sorted ids: torch.bincount on the
    # card reads the largest id back to the host, a sync in every layer
    ends = torch.searchsorted(grouped, torch.arange(1, w_gate_up.shape[0] + 1,
                                                    device=grouped.device))
    offs = ends.to(torch.int32)
    h = swiglu(grouped_mm(x[order // k], w_gate_up, offs))
    ys = grouped_mm(h, w_down, offs)
    if log is not None:
        log.record(torch.diff(ends, prepend=ends.new_zeros(1)))
    y = torch.empty_like(ys).index_copy_(0, order, ys)  # back to pair order, no atomics
    return (y.float().view(n, k, -1) * weights[..., None]).sum(1)
