"""Expert parallelism for the MoE mapper (port of clipcap_tpu/parallel/ep.py).

The expert axis [E] of every expert FFN weight is sharded over the mesh's
`model` axis: rank r holds and runs experts [r*E/M, (r+1)*E/M). Tokens are
replicated, as in JAX; each rank builds dispatch and combine for its own
experts only, runs them, and sums its partial output over `model`
(models/moe.moe_ffn_apply), which is how XLA partitions the combine
einsum's reduction over E. The gate and the attention and layernorm halves
of the layer stay replicated (they are tiny next to the expert bank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..core.mesh import MODEL_AXIS, axis_group, axis_rank, axis_size, shard_rows
from .sharding import P

# leaf names under layers.{i}.mlp that carry the [E, ...] expert axis
_EXPERT_LEAVES = {"w1", "b1", "w2", "b2"}


def _is_expert(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 3 and parts[-2] == "mlp" and parts[-1] in _EXPERT_LEAVES


def moe_param_shardings(mapper, mesh) -> dict:
    """{parameter name: spec}: the expert banks split their E axis (axis 0
    of a layer's tensor; JAX's [L, E, ...] leaf has it at axis 1) over
    `model`, everything else replicated."""
    return {name: (P(MODEL_AXIS, *([None] * (p.dim() - 1))) if _is_expert(name) else P())
            for name, p in mapper.named_parameters()}


def shard_experts(mapper, mesh):
    """Keep this model rank's block of every expert bank, in place."""
    m, r = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    with torch.no_grad():
        for name, p in mapper.named_parameters():
            if _is_expert(name):
                lo, hi = shard_rows(p.shape[0], m, r, f"{name}'s experts")
                p.data = p.data[lo:hi].contiguous()
    return mapper


@dataclasses.dataclass
class ExpertParallel:
    """The EP path's handle: the model group and this rank's place in it."""

    mesh: Any

    @property
    def group(self):
        return axis_group(self.mesh, MODEL_AXIS)

    def experts(self, n_experts: int) -> Tuple[int, int]:
        """This rank's experts [lo, hi)."""
        return shard_rows(n_experts, axis_size(self.mesh, MODEL_AXIS),
                          axis_rank(self.mesh, MODEL_AXIS), "experts")


def expert_constraint(mesh) -> ExpertParallel:
    """The hook moe.apply / moe_ffn_apply take as `expert_constraint`: the
    expert-parallel path over the mesh's `model` axis."""
    return ExpertParallel(mesh=mesh)
