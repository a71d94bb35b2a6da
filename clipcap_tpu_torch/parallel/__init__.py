"""Parallelism on torch.distributed (port of clipcap_tpu/parallel/): one
process per device over the (data, pipe, model) mesh of core/mesh.py.

sharding.py  replicated or ZeRO layouts of parameters and optimizer state
dp.py        data-parallel decode (batch and KV cache over `data`)
tp.py        tensor-parallel GPT-J decode (heads and MLP width over `model`)
pp.py        GPipe pipeline over `pipe` for GPT-2 training
sp.py        ring-attention sequence parallelism for the ViT over `model`
ep.py        expert parallelism for the MoE mapper over `model`
"""

from .ep import expert_constraint, moe_param_shardings
from .pp import PIPE_AXIS, make_gpt2_pp_apply, pp_param_shardings
from .sharding import batch_shardings, param_shardings, shard_params
from .sp import make_vit_sp_apply, ring_attention_shard

__all__ = ["PIPE_AXIS", "batch_shardings", "expert_constraint", "make_gpt2_pp_apply",
           "make_vit_sp_apply", "moe_param_shardings", "param_shardings", "pp_param_shardings",
           "ring_attention_shard", "shard_params"]
