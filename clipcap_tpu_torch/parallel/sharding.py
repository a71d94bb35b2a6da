"""Parameter / optimizer-state sharding rules (port of
clipcap_tpu/parallel/sharding.py).

- plain data parallelism: the batch sharded over `data`, parameters
  replicated, the gradients summed over `data` by the train step;
- ZeRO-style sharding (`zero=True`): each tensor of at least
  `min_size_to_shard` elements keeps one shard per data rank, on the
  largest axis that `data` divides; smaller tensors are replicated.

A spec is JAX's PartitionSpec as a tuple: one entry per axis, the mesh
axis name it is split over or None (`()` is replicated). `_zero_spec` is
JAX's, line for line, and runs on the shape a tensor has in the JAX
package's layout: the port's per-layer modules (`blocks.{i}`, `layers.{i}`)
stack into one [L, ...] leaf there, and an nn.Linear weight [out, in] is
[in, out]. So the same tensors shard on the same axes, and rank r's shard
is, transposed where the layout is, device r's shard of the JAX leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.mesh import COLLECTIVES, DATA_AXIS, all_reduce_, axis_rank, axis_size


def P(*axes) -> tuple:
    """JAX's PartitionSpec(*axes), as a tuple."""
    return tuple(axes)


def _zero_spec(shape, data_size: int, min_size: int) -> tuple:
    """Shard the largest divisible axis over `data`; replicate otherwise."""
    if int(np.prod(shape)) < min_size:
        return P()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for axis in order:
        if shape[axis] % data_size == 0 and shape[axis] >= data_size:
            spec = [None] * len(shape)
            spec[axis] = DATA_AXIS
            return P(*spec)
    return P()


def jax_layout(module: nn.Module) -> Dict[str, Tuple[tuple, bool, bool]]:
    """{parameter name: (its leaf's shape in the JAX layout, stacked over
    layers, transposed)}: a parameter under a ModuleList index is one layer
    of a stacked [L, ...] leaf; an nn.Linear weight is transposed."""
    owners = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        owner = owners[".".join(parts[:-1])]
        transposed = isinstance(owner, nn.Linear) and parts[-1] == "weight"
        shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
        stacked = False
        for i, part in enumerate(parts[:-1]):
            if part.isdigit():
                stack = owners[".".join(parts[:i])]
                shape = (len(stack),) + shape
                stacked = True
                break
        out[name] = (shape, stacked, transposed)
    return out


def param_shardings(module: nn.Module, mesh, zero: bool = False,
                    min_size_to_shard: int = 2**16) -> Dict[str, Optional[int]]:
    """{parameter name: the axis of the port's tensor that is split over
    `data`, or None (replicated)}. zero=False replicates everything (plain
    data parallelism); zero=True takes `_zero_spec` of the JAX-layout
    shape. A stacked leaf that JAX would split on its layer axis would
    give whole layers to ranks, which this layout does not do: it raises."""
    data_size = axis_size(mesh, DATA_AXIS)
    out = {}
    for name, (shape, stacked, transposed) in jax_layout(module).items():
        spec = _zero_spec(shape, data_size, min_size_to_shard) if zero else P()
        if DATA_AXIS not in spec:
            out[name] = None
            continue
        axis = spec.index(DATA_AXIS)
        if stacked:
            if axis == 0:
                raise ValueError(f"ZeRO would split {name}'s stacked leaf {shape} on its "
                                 "layer axis")
            axis -= 1
        out[name] = (1 - axis) if transposed else axis
    return out


def shard_of(t: torch.Tensor, axis: Optional[int], mesh) -> torch.Tensor:
    """This data rank's shard of `t` on `axis` (a contiguous copy), or t
    itself when replicated."""
    if axis is None:
        return t
    n, r = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
    return t.detach().chunk(n, dim=axis)[r].contiguous()


def shard_params(module: nn.Module, mesh, zero: bool = False) -> Dict[str, torch.Tensor]:
    """{name: this rank's tensor} of the chosen layout: the rank's ZeRO
    shards (copies) and the replicated parameters themselves."""
    axes = param_shardings(module, mesh, zero=zero)
    return {name: shard_of(p, axes[name], mesh) for name, p in module.named_parameters()}


def batch_shardings(mesh, batch_example) -> dict:
    """Leading-axis `data` specs for every array of the batch."""
    return {k: P(DATA_AXIS, *([None] * (np.ndim(v) - 1))) for k, v in batch_example.items()}


class ZeroShards:
    """ZeRO for the train step (`--zero_shard_params`): this data rank's
    shard of the f32 masters of the trainable parameters `names`, on the
    axes of param_shardings(zero=True). AdamW's moments are made of these
    shapes, so they shard alike. The model keeps the whole parameters for
    the forward: after each update they are all-gathered from the masters.
    Gradients are reduce-scattered (summed over `data`, this rank's shard
    kept); replicated ones are all-reduced. Elementwise AdamW on a shard
    is the whole update's shard, so a ZeRO run is the plain run."""

    def __init__(self, model: nn.Module, names, mesh, min_size_to_shard: int = 2**16):
        from ..core.mesh import axis_group

        params = dict(model.named_parameters())
        axes = param_shardings(model, mesh, zero=True, min_size_to_shard=min_size_to_shard)
        self.names = list(names)
        self.axes = [axes[n] for n in self.names]
        self.mesh = mesh
        self.group = axis_group(mesh, DATA_AXIS)
        self.n, self.rank = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)
        self.masters = [shard_of(params[n], a, mesh).clone() if a is not None
                        else params[n].detach() for n, a in zip(self.names, self.axes)]

    def shard(self, tensors):
        """This rank's shards of whole tensors in `names` order (copies)."""
        return [shard_of(t, a, self.mesh).clone() if a is not None else t
                for t, a in zip(tensors, self.axes)]

    def _gather(self, shard: torch.Tensor, axis: int) -> torch.Tensor:
        moved = shard.movedim(axis, 0).contiguous()
        full = moved.new_empty((self.n * moved.shape[0],) + tuple(moved.shape[1:]))
        dist.all_gather_into_tensor(full, moved, group=self.group)
        COLLECTIVES["all_gather"] += 1
        return full.movedim(0, axis)

    def gather(self, shards):
        """Whole tensors from this rank's shards (a collective)."""
        return [self._gather(s, a) if a is not None else s for s, a in zip(shards, self.axes)]

    def gather_into(self, params) -> None:
        """Copy the all-gathered masters into the model's parameters."""
        with torch.no_grad():
            for p, full in zip(params, self.gather(self.masters)):
                if full.data_ptr() != p.data_ptr():  # a replicated master is the parameter
                    p.copy_(full)

    def reduce(self, grads):
        """Sum the ranks' gradients over `data`: this rank's shard of each
        sharded one (reduce-scatter), the whole of each replicated one."""
        out = []
        for g, a in zip(grads, self.axes):
            if a is None:
                out.append(all_reduce_(g.clone(), self.group))
                continue
            moved = g.movedim(a, 0).contiguous()
            part = moved.new_empty((moved.shape[0] // self.n,) + tuple(moved.shape[1:]))
            dist.reduce_scatter_tensor(part, moved, group=self.group)
            COLLECTIVES["reduce_scatter"] += 1
            out.append(part.movedim(0, a))
        return out

    def global_norm(self, grad_shards) -> torch.Tensor:
        """The L2 norm of the whole gradient from its shards: the squares of
        the shards, replicated tensors counted on rank 0 only, all-reduced."""
        sq = [g.float().square().sum() for g, a in zip(grad_shards, self.axes)
              if a is not None or self.rank == 0]
        total = torch.stack(sq).sum() if sq else torch.zeros((), device=grad_shards[0].device)
        return all_reduce_(total, self.group).sqrt()
