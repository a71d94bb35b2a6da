"""Device mesh, process groups and the collectives of the parallel paths
(port of clipcap_tpu/core/mesh.py).

JAX runs one controller over global arrays and lets XLA insert the
collectives that `NamedSharding` annotations imply. The port runs one
process per device (torchrun on GPUs, spawned gloo processes on the CPU),
every process running the same program, with explicit local shards and
explicit collectives. The mesh keeps JAX's named axes:

    data   — data parallelism: each rank holds its rows of the batch
    pipe   — pipeline parallelism: each stage holds a chunk of the layers
    model  — tensor / sequence / expert parallelism

`make_mesh` lays ranks out as JAX lays devices out, `reshape(data, pipe,
model)` in rank order, so rank r sits at (r // (pipe*model),
(r // model) % pipe, r % model).

The collectives that carry gradients are autograd Functions of the
port's own, Megatron's conjugate pair and JAX's ppermute:
- `all_reduce`: a sum over the group in the forward. What follows it is
  replicated on every rank, so each rank's cotangent is already the whole
  one and the backward passes it through. (JAX's shard_map gets the same
  total by scaling the cotangent of a replicated output by 1/n before
  psum's transpose, itself a psum.)
- `replicated_in`: the identity in the forward, where a replicated value
  enters computations that each rank runs on its own part; the backward
  sums the ranks' partial cotangents.
- `ppermute`: each rank sends to rank + shift of the group and receives
  from rank - shift; the backward sends the cotangent back the other way.
  With one rank it is the identity and nothing is sent, as JAX's ppermute
  over [(0, 0)].
The reductions and gathers are issued at one rank too (a copy there), so
a one-card run carries the collectives of its path. `COLLECTIVES` counts
the calls issued, by kind.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. `data * pipe * model` must equal the world size.
    `model` is the innermost axis, so a model group is ranks r..r+model-1
    (on one host, the NVLink-nearest cards)."""

    data: int = 1
    model: int = 1
    pipe: int = 1

    @property
    def axis_names(self) -> tuple:
        return (DATA_AXIS, PIPE_AXIS, MODEL_AXIS)


def init_distributed(device: str = "cuda", init_method: Optional[str] = None) -> Tuple[int, int]:
    """Join the default process group once: NCCL for `cuda`, gloo for
    `cpu`. Reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK (and its
    MASTER_ADDR / MASTER_PORT through `env://`); with none set this process
    is the whole world (size 1, an in-process store unless `init_method`
    names a rendezvous). On `cuda` it selects card LOCAL_RANK. A `cuda`
    mesh without NCCL raises: there is no fallback to gloo or the CPU.
    Returns (rank, world size)."""
    dev = torch.device(device).type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r} (expected cuda or cpu)")
    if dev == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, which this PyTorch build lacks")
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; none is visible")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "nccl" if dev == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    elif init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=0, world_size=1)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()


@contextlib.contextmanager
def process_group_scope():
    """Leave the default process group on exit if it was joined inside (an
    entry point's run), and keep a caller's group otherwise."""
    joined = dist.is_initialized()
    try:
        yield
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the one rank that prints results and writes files (global
    rank 0), and in a process outside any group."""
    return global_rank() == 0


def launched_world_size() -> int:
    """The world size torchrun launched this process into (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", 1))


def check_mesh(spec: MeshSpec, n: int) -> None:
    """JAX's ValueError when the mesh does not take exactly n devices."""
    need = spec.data * spec.pipe * spec.model
    if need != n:
        raise ValueError(f"mesh {spec.data}x{spec.pipe}x{spec.model} needs {need} devices, "
                         f"have {n}")


def make_mesh(spec: Optional[MeshSpec] = None, device_type: str = "cuda"):
    """A DeviceMesh of shape (data, pipe, model) over the world, dims named
    ("data", "pipe", "model"). Defaults to pure data parallelism over every
    rank. Joins the default group first (init_distributed) if needed.
    Raises JAX's ValueError when data * pipe * model is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if spec is not None:
        check_mesh(spec, launched_world_size() if not dist.is_initialized() else world_size())
    init_distributed(device_type)
    n = dist.get_world_size()
    if spec is None:
        spec = MeshSpec(data=n, model=1)
    check_mesh(spec, n)
    return init_device_mesh(device_type, (spec.data, spec.pipe, spec.model),
                            mesh_dim_names=spec.axis_names)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def mesh_shape(mesh) -> dict:
    """{"data": n, "pipe": n, "model": n}, as JAX's `mesh.shape`."""
    return {name: axis_size(mesh, name) for name in mesh.mesh_dim_names}


def shard_rows(n_rows: int, n_shards: int, index: int, what: str = "batch") -> Tuple[int, int]:
    """[lo, hi) of shard `index` when n_rows split evenly into n_shards
    (NamedSharding's block layout); raises when they do not divide."""
    if n_rows % n_shards:
        raise ValueError(f"{what} {n_rows} not divisible by {n_shards} shards")
    per = n_rows // n_shards
    return index * per, (index + 1) * per


def data_rows(mesh, n_rows: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a global batch sharded over `data`."""
    return shard_rows(n_rows, axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS))


def shard_batch(mesh, batch):
    """This rank's rows of every array of a host batch (dict, list or one
    array), the batch axis first: what `NamedSharding(P("data"))` places on
    this rank's device. Tensors are sliced, numpy arrays too."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    lo, hi = data_rows(mesh, batch.shape[0])
    return batch[lo:hi]


# --- collectives ------------------------------------------------------------------------

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0, "ppermute": 0}


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.rank, ctx.size, ctx.dim = dist.get_rank(group), x.shape[dim], dim
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        COLLECTIVES["all_gather"] += 1
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in group-rank order; x
    itself with no group. Differentiable: the result is taken as
    replicated, so the backward keeps this rank's part of the cotangent."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim % x.dim())


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over the group in place (no gradient); returns x."""
    dist.all_reduce(x, group=group)
    COLLECTIVES["all_reduce"] += 1
    return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; differentiable, the result taken as replicated
    (the backward passes the cotangent through)."""
    return x if group is None else _AllReduce.apply(x, group)


def replicated_in(x: torch.Tensor, group) -> torch.Tensor:
    """The identity where a replicated value enters per-rank partial work;
    the backward sums the ranks' cotangents."""
    return x if group is None else _ReplicatedIn.apply(x, group)


def shift_ring(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send x to group rank + shift and return what rank - shift sent (no
    gradient; ppermute is the differentiable form)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    send_to = dist.get_global_rank(group, (me + shift) % n)
    recv_from = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, send_to, group),
                                   dist.P2POp(dist.irecv, out, recv_from, group)])
    for r in reqs:
        r.wait()
    COLLECTIVES["ppermute"] += 1
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, after, group, shift):
        ctx.group, ctx.shift, ctx.has_after = group, shift, after is not None
        return shift_ring(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        after_grad = torch.zeros((), device=g.device, dtype=g.dtype) if ctx.has_after else None
        return shift_ring(g, ctx.group, -ctx.shift), after_grad, None, None


def ppermute(x: torch.Tensor, group, shift: int = 1,
             after: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's ppermute over the ring [(i, (i + shift) % n)]: rank i's x goes
    to rank i + shift. Differentiable (the backward is the reverse
    permutation); with one rank the identity, with no send or receive.

    The backward's sends pair up across ranks only if every rank runs them
    in the same order. Where the ranks' graphs differ (pipeline stages),
    pass the previous ppermute's result as `after`: a 0-d dependency that
    makes each backward wait for the next one's, so every rank runs them in
    reverse program order."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    if after is not None:
        after = after.reshape(-1)[:1].sum()
    return _Ppermute.apply(x, after, group, shift)
