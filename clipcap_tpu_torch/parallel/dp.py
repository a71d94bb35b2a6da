"""Data-parallel KV-cached decode: batch sharded, weights replicated (port
of clipcap_tpu/parallel/dp.py).

Every rank holds the whole model and decodes its rows of the caption
batch; its KV cache holds those rows only, so no collective touches the
cache. This is the multi-card scale-out for GPT-2 (whose 25 heads do not
split tensor-parallel) and composes with the int8 caches (their scale
slabs shard like k/v).

The decode entry points take `cache_constraint=sh.constrain_cache`, as in
JAX. They apply it once to the fresh cache, which keeps this rank's rows,
and read the layout behind it (`layout_of`) to run those rows and gather
the results over `data`: every rank receives the whole batch and returns
the whole result, as JAX's global arrays do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..core.mesh import DATA_AXIS, all_gather, axis_group, axis_rank, axis_size, shard_rows

# batch-carrying cache fields across every cache type -> the axis their
# batch dimension lives on: the stacked [L, B, ...] slabs (gpt2/gptj/t5/blip
# KVCache, the int8 caches' scale slabs, blip's precomputed cross K/V) and
# t5/blip's [B, ...] encoder-side tensors. NOTE decode/beam.py keeps its
# own narrower list on purpose: beam reorder gathers only the
# SELF-attention slabs (cross/encoder tensors are shared by all beams of
# one prompt and must not be gathered).
_BATCH_AXIS_BY_FIELD = {
    "k": 1, "v": 1, "ks": 1, "vs": 1,
    "cross_k": 1, "cross_v": 1,
    "enc_hidden": 0, "enc_bias": 0, "cross_bias": 0,
}


@dataclasses.dataclass
class DPDecodeShardings:
    mesh: Any  # a DeviceMesh with a `data` dim

    @property
    def size(self) -> int:
        return axis_size(self.mesh, DATA_AXIS)

    @property
    def index(self) -> int:
        return axis_rank(self.mesh, DATA_AXIS)

    @property
    def group(self):
        return axis_group(self.mesh, DATA_AXIS)

    def rows(self, n_rows: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch of n_rows."""
        return shard_rows(n_rows, self.size, self.index)

    def gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The ranks' rows joined along `axis` in rank order."""
        return all_gather(x, self.group, dim=axis)

    def constrain_cache(self, cache):
        """This rank's rows of every batch-carrying field of a cache built
        for the global batch (copies, so the global storage is freed).

        BLIP's grouped cross K/V (decoder_lm repeat > 1) carry batch =
        rows / repeat: that image batch must divide the data axis too."""
        upd = {}
        for name, axis in _BATCH_AXIS_BY_FIELD.items():
            val = getattr(cache, name, None)
            if torch.is_tensor(val) and val.dim() > axis:
                lo, hi = shard_rows(val.shape[axis], self.size, self.index, f"cache {name}")
                upd[name] = val.narrow(axis, lo, hi - lo).clone()
        return cache._replace(**upd)


def dp_decode_shardings(mesh) -> DPDecodeShardings:
    if DATA_AXIS not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no '{DATA_AXIS}' axis")
    return DPDecodeShardings(mesh=mesh)


def layout_of(cache_constraint) -> Optional[DPDecodeShardings]:
    """The data-parallel layout behind a cache_constraint hook (its
    `constrain_cache`), or None for no hook or another kind of hook."""
    owner = getattr(cache_constraint, "__self__", None)
    return owner if isinstance(owner, DPDecodeShardings) else None
