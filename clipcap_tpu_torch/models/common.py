"""Parameter construction shared by the port's models.

Weights are drawn from an explicit `torch.Generator` made from a seed on
the model's device, never from PyTorch's global generator. The draws
follow the JAX package's init distributions but are not its numbers; to
hold the port against JAX, load converted JAX parameters (convert.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def normal(shape, std: float, gen: torch.Generator, device, dtype) -> nn.Parameter:
    """N(0, std^2) parameter, drawn in f32 then cast (as jax.random.normal * std)."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std
    return nn.Parameter(w.to(dtype))


def linear(fan_in: int, fan_out: int, *, bias: bool, gen: torch.Generator, device, dtype,
           std: Optional[float] = None) -> nn.Linear:
    """nn.Linear ([out, in] weight) initialised from `gen`: N(0, std^2)
    weights and zero bias when `std` is given, else torch's default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=bias, device=device, dtype=dtype)
    with torch.no_grad():
        if std is not None:
            lin.weight.copy_(torch.randn(fan_out, fan_in, generator=gen, device=device) * std)
            if bias:
                lin.bias.zero_()
        else:
            bound = fan_in**-0.5
            lin.weight.uniform_(-bound, bound, generator=gen)
            if bias:
                lin.bias.uniform_(-bound, bound, generator=gen)
    return lin


def gather_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens] with JAX's indexing of a gather, on the device: a
    negative id first wraps once by the row count (numpy's table[-1] is the
    last row), then every id is clamped to [0, rows - 1], as JAX clamps an
    out-of-range index (a GPT-2 draft embeds a wider GPT-J target's ids in
    speculative decoding; token shards are padded with -1)."""
    rows = table.shape[0]
    ids = tokens.long()
    return table[torch.where(ids < 0, ids + rows, ids).clamp(0, rows - 1)]


def remat_call(module: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    """module(*args) under activation checkpointing (jax.checkpoint of a
    scanned layer body): non-reentrant torch.utils.checkpoint, which keeps
    only the inputs and recomputes the module's forward in the backward.
    The module's parameters are passed to the checkpoint as inputs, so the
    recompute sees the very tensors the forward saw, also where the caller
    substituted them with torch.func.functional_call (the train step's bf16
    casts), whose substitution has ended by the time the backward runs."""
    names, tensors = zip(*module.named_parameters())
    n = len(args)

    def run(*xs):
        return torch.func.functional_call(module, dict(zip(names, xs[n:])), xs[:n])

    return checkpoint(run, *args, *tensors, use_reentrant=False)
