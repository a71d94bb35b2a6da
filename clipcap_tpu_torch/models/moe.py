"""Mixture-of-experts mapper (port of clipcap_tpu/models/moe.py).

An MoE variant of the prefix mapper whose per-layer MLP is a bank of E
expert FFNs with top-1/top-2 token routing, GShard/Switch-style, computing
what the JAX module computes:

- routing has static shapes: tokens are placed into a fixed [E, C, D]
  expert buffer (C = capacity per expert, max(1, int(cf * k * S / E))) by
  one-hot dispatch/combine einsums, first come first served, choice k
  queued behind every token of choice k-1;
- tokens beyond capacity are dropped from the MoE branch and pass through
  the residual unchanged;
- the load-balancing auxiliary loss is Switch's
  E * sum_e(fraction of first choices_e * mean gate prob_e), returned with
  the output for the train loss to weight;
- the gate runs in f32 (a softmax and argmax on bf16 activations are
  tie-unstable).

Expert weights keep JAX's layout, a leading [E] axis: w1 [E, D, H],
b1 [E, H], w2 [E, H, D], b2 [E, D], and the gate [D, E]. Under expert
parallelism (parallel/ep.py) a rank runs a block of E/M experts and the
partial outputs are summed over `model`. `init` is the MoEMapper
constructor and `apply` its forward.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..core.config import MapperConfig
from ..core.mesh import all_reduce, replicated_in
from ..ops.attention import multi_head_attention
from .common import make_generator
from .mapper import Mapper


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """MoE settings layered on top of a MapperConfig."""

    n_experts: int = 8
    n_top: int = 2  # 1 = Switch, 2 = GShard
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2


class MoEFFN(nn.Module):
    """A bank of expert FFNs and its gate, JAX's init: U(+-dim^-0.5) gate
    and w1, U(+-hidden^-0.5) w2, zero biases."""

    def __init__(self, dim: int, hidden: int, n_experts: int, gen, device, dtype):
        super().__init__()

        def uniform(shape, bound):
            w = torch.empty(shape, device=device, dtype=torch.float32)
            return nn.Parameter(w.uniform_(-bound, bound, generator=gen).to(dtype))

        self.gate = uniform((dim, n_experts), dim**-0.5)
        self.w1 = uniform((n_experts, dim, hidden), dim**-0.5)
        self.b1 = nn.Parameter(torch.zeros((n_experts, hidden), device=device, dtype=dtype))
        self.w2 = uniform((n_experts, hidden, dim), hidden**-0.5)
        self.b2 = nn.Parameter(torch.zeros((n_experts, dim), device=device, dtype=dtype))


def moe_ffn_init(dim: int, hidden: int, n_experts: int, *, seed: int = 0, device="cuda",
                 dtype=torch.float32) -> MoEFFN:
    return MoEFFN(dim, hidden, n_experts, make_generator(seed, device), device, dtype)


def _top_choice(probs: torch.Tensor, used_mask: torch.Tensor):
    """Highest-prob expert not already used: returns (one_hot [S, E], gate [S])."""
    masked = torch.where(used_mask, float("-inf"), probs)
    idx = torch.argmax(masked, dim=-1)  # ties go to the first, as jnp.argmax
    one_hot = nn.functional.one_hot(idx, probs.shape[-1]).to(probs.dtype)
    return one_hot, (probs * one_hot).sum(dim=-1)


def moe_ffn_apply(x: torch.Tensor, ffn: MoEFFN, moe_cfg: MoEConfig, act,
                  expert_constraint=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (y [B, T, D], aux_loss scalar f32). With an
    `expert_constraint` (parallel/ep.expert_constraint) the expert-parallel
    path: this rank builds dispatch and combine for its own experts, runs
    them and all-reduces its partial y over `model` (how XLA partitions the
    combine einsum's reduction over E); the gate and the aux loss are
    computed replicated, once."""
    b, t, d = x.shape
    s = b * t
    e = moe_cfg.n_experts
    cap = max(1, int(moe_cfg.capacity_factor * moe_cfg.n_top * s / e))

    xf = x.reshape(s, d)
    logits = xf.float() @ ffn.gate.float()
    probs = torch.softmax(logits, dim=-1)  # [S, E] f32

    used = torch.zeros_like(probs, dtype=torch.bool)
    masks, gates = [], []
    for _ in range(moe_cfg.n_top):
        m, g = _top_choice(probs, used)
        used = used | (m > 0)
        masks.append(m)
        gates.append(g)
    denom = sum(gates) + 1e-9
    gates = [g / denom for g in gates]

    ep = expert_constraint
    lo, hi = (0, e) if ep is None else ep.experts(e)
    w1, b1, w2, b2 = ffn.w1, ffn.b1, ffn.w2, ffn.b2
    if ep is not None:
        xf = replicated_in(xf, ep.group)
        gates = [replicated_in(g, ep.group) for g in gates]
        if w1.shape[0] == e:  # a replicated bank: this rank's block of it
            w1, b1, w2, b2 = (replicated_in(w, ep.group)[lo:hi] for w in (w1, b1, w2, b2))

    # first-come-first-serve capacity assignment; choice k queues behind
    # all of choice k-1's tokens (GShard's second-expert offset)
    slots = torch.arange(cap, device=x.device)
    offset = torch.zeros((1, e), dtype=torch.float32, device=x.device)
    dispatch = combine = 0.0
    for m, g in zip(masks, gates):
        pos = torch.cumsum(m, dim=0) - 1 + offset  # [S, E]
        offset = offset + m.sum(dim=0, keepdim=True)
        m, pos = m[:, lo:hi], pos[:, lo:hi]
        keep = (pos < cap) & (m > 0)
        # jax.nn.one_hot: an index outside [0, cap) is a row of zeros
        pos_oh = (pos.long()[..., None] == slots).float()
        sel = torch.where(keep[..., None], pos_oh, 0.0) * m[..., None]
        dispatch = dispatch + sel
        combine = combine + sel * g[:, None, None]

    expert_in = torch.einsum("sec,sd->ecd", dispatch.to(x.dtype), xf)
    h = torch.einsum("ecd,edh->ech", expert_in, w1) + b1[:, None]
    out_e = torch.einsum("ech,ehd->ecd", act(h), w2) + b2[:, None]
    y = torch.einsum("sec,ecd->sd", combine.to(x.dtype), out_e)
    if ep is not None:
        y = all_reduce(y, ep.group)

    # Switch aux loss: E * sum_e f_e * p_e, f = token fraction routed (1st
    # choice), p = mean gate prob
    f = masks[0].mean(dim=0)
    p = probs.mean(dim=0)
    aux = e * (f * p).sum()
    return y.reshape(b, t, d), aux


class MoEMapper(Mapper):
    """The dense mapper with each layer's MLP replaced by a bank of expert
    FFNs (`mlp`); its forward returns (prefix embeddings, aux loss)."""

    def __init__(self, cfg: MapperConfig, moe_cfg: MoEConfig, *, device="cuda",
                 dtype=torch.float32, seed: int = 0):
        super().__init__(cfg, device=device, dtype=dtype, seed=seed)
        self.moe_cfg = moe_cfg
        d = cfg.dim_embedding
        gen = make_generator(seed + 0x30E, device)
        for layer in self.layers:
            del layer.fc1, layer.fc2
            layer.mlp = MoEFFN(d, int(d * cfg.mlp_ratio), moe_cfg.n_experts, gen, device, dtype)

    def forward(self, prefix: torch.Tensor,
                expert_constraint=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Same contract as Mapper.forward plus the aux loss: returns
        ([B, prefix_length, dim_embedding], aux_loss averaged over layers)."""
        x, visual_len = self.sequence(prefix)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            h = layer.ln1(x)
            attn, _ = multi_head_attention(h, None, wq=layer.wq.weight, wkv=layer.wkv.weight,
                                           wo=layer.wo.weight, bo=layer.wo.bias,
                                           num_heads=layer.num_heads)
            x = x + attn
            y, layer_aux = moe_ffn_apply(layer.ln2(x), layer.mlp, self.moe_cfg, layer.act,
                                         expert_constraint=expert_constraint)
            x = x + y
            aux = aux + layer_aux
        return x[:, visual_len:], aux / self.cfg.num_layers


def init(cfg: MapperConfig, moe_cfg: MoEConfig, *, device="cuda", dtype=torch.float32,
         seed: int = 0) -> MoEMapper:
    """MoE mapper weights drawn from `seed` (JAX's `init`)."""
    return MoEMapper(cfg, moe_cfg, device=device, dtype=dtype, seed=seed)


def apply(mapper: MoEMapper, prefix: torch.Tensor,
          expert_constraint=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE mapper forward (JAX's `apply`): ([B, prefix_length, D], aux_loss)."""
    return mapper(prefix, expert_constraint=expert_constraint)
