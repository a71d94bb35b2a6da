"""Tensor-parallel layouts for big-LM decode, GPT-J-6B class (port of
clipcap_tpu/parallel/tp.py).

Attention heads and the MLP width are sharded over the mesh's `model` axis,
so each rank holds 1/M of every layer and 1/M of the KV cache; the two
all-reduces of a layer follow the attention-out and MLP-out projections
(models/gptj.GPTJBlock.finish). The cache stays local across steps: no
gather in the loop but the logits' (GPTJ.head), so every rank samples the
same token.

The rules are looked up BY PARAMETER NAME over the actual module, so a
renamed or new parameter fails loudly with its name instead of taking a
silent layout. They are JAX's `_GPTJ_RULES` in the port's layout: JAX
keeps a linear's weight [in, out] (stacked [L, in, out]), the port's
nn.Linear holds [out, in] per layer, so JAX's P(None, None, "model") on
[L, in, out] ("column-parallel": the outputs split) is P("model", None) on
[out, in] here, and P(None, "model", None) ("row-parallel": the inputs
split) is P(None, "model").

Usage (or pass --tensor_parallel to cli/infer.py under torchrun):
    sh = gptj_decode_shardings(mesh, model)
    model.shard_heads(mesh.get_group("model"))
    out = engine.generate(model, prompt, settings, cache_constraint=sh.constrain_cache)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..core.mesh import MODEL_AXIS, axis_group
from .dp import DPDecodeShardings
from .sharding import P

# spec per (module, leaf) name pair of a GPTJ block or the model, in the
# port's per-layer [out, in] layout; JAX's spec on [L, in, out] beside it
_GPTJ_RULES = {
    ("wq", "weight"): P(MODEL_AXIS, None),  # attn/wq P(None, None, model): heads split
    ("wk", "weight"): P(MODEL_AXIS, None),  # attn/wk P(None, None, model)
    ("wv", "weight"): P(MODEL_AXIS, None),  # attn/wv P(None, None, model)
    ("wo", "weight"): P(None, MODEL_AXIS),  # attn/wo P(None, model, None): row-parallel
    ("w_in", "weight"): P(MODEL_AXIS, None),  # mlp/w_in P(None, None, model)
    ("w_in", "bias"): P(MODEL_AXIS),  # mlp/b_in P(None, model)
    ("w_out", "weight"): P(None, MODEL_AXIS),  # mlp/w_out P(None, model, None)
    ("w_out", "bias"): P(None),  # mlp/b_out P(None, None): added once
    # vocab-parallel head: logits come out sharded over the vocabulary
    ("lm_head", "weight"): P(MODEL_AXIS, None),  # lm_head/w [D, V] P(None, model)
    ("lm_head", "bias"): P(MODEL_AXIS),  # lm_head/b P(model)
}
# replicated leaves (embeddings are lookup-cheap; layernorms are tiny)
_GPTJ_REPLICATED_PARENTS = {"ln1", "ln2", "ln_f"}
_GPTJ_REPLICATED_LEAVES = {"wte"}


def _rule(name: str, p: torch.Tensor) -> tuple:
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else None
    if leaf in _GPTJ_REPLICATED_LEAVES or parent in _GPTJ_REPLICATED_PARENTS:
        return P()
    spec = _GPTJ_RULES.get((parent, leaf))
    if spec is None:
        raise ValueError(f"no tensor-parallel rule for gptj param {name} (shape "
                         f"{tuple(p.shape)}) — update parallel/tp.py:_GPTJ_RULES for new "
                         "parameters")
    if len(spec) != p.dim():
        raise ValueError(f"rank mismatch for {name}: spec {spec} vs shape {tuple(p.shape)}")
    return spec


def tp_axes(model) -> Dict[str, Optional[int]]:
    """{parameter name: the axis split over `model`, or None}."""
    out = {}
    for name, p in model.named_parameters():
        spec = _rule(name, p)
        out[name] = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
    return out


def local_shard(t: torch.Tensor, axis: int, m: int, r: int, name: str = "") -> torch.Tensor:
    """Block r of m of t along `axis` (a contiguous copy); raises where m
    does not divide that axis."""
    if t.shape[axis] % m:
        raise ValueError(f"{name} axis {axis} of {tuple(t.shape)} does not split over "
                         f"model={m}")
    return t.chunk(m, dim=axis)[r].contiguous()


@dataclasses.dataclass
class GPTJDecodeShardings(DPDecodeShardings):
    """The decode layout of a (data, model) mesh: batch over `data` (the
    inherited constrain_cache takes this rank's rows, and generate gathers
    them), heads over `model` (the sharded GPTJ makes its cache of local
    heads)."""

    params: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    @property
    def model_group(self):
        return axis_group(self.mesh, MODEL_AXIS)


def gptj_decode_shardings(mesh, model) -> GPTJDecodeShardings:
    """Specs for a GPTJ's parameters, derived from their names; raises
    ValueError naming an unknown parameter or a spec of the wrong rank."""
    if MODEL_AXIS not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no '{MODEL_AXIS}' axis")
    return GPTJDecodeShardings(mesh=mesh, params={name: _rule(name, p)
                                                  for name, p in model.named_parameters()})


def apply_gptj_decode_shardings(model, cache, mesh):
    """Shard `model` over the mesh's model axis (in place) and keep this
    rank's rows and heads of a full-size `cache` (or None). Returns
    (model, cache, shardings)."""
    sh = gptj_decode_shardings(mesh, model)
    model.shard_heads(sh.model_group)
    if cache is not None:
        m = torch.distributed.get_world_size(sh.model_group)
        r = torch.distributed.get_rank(sh.model_group)
        cache = sh.constrain_cache(cache)
        cache = cache._replace(k=local_shard(cache.k, 3, m, r, "cache.k"),
                               v=local_shard(cache.v, 3, m, r, "cache.v"))
    return model, cache, sh
