"""Pipeline parallelism for the GPT-2 layer stack, GPipe schedule (port of
clipcap_tpu/parallel/pp.py).

A stage is a contiguous chunk of L/S of the LM's blocks, stage s on pipe
rank s. With S stages and M micro-batches the loop runs M + S - 1 ticks:
stage 0 feeds micro-batch t at tick t, stage s runs micro-batch t - s, the
last stage emits micro-batch t - (S - 1), and activations move one stage
on with `ppermute` after every tick (its backward carries the cotangents
back, so autograd of a loss over the pipelined forward is the reverse
schedule). A stage computes only on the ticks that hold one of its
micro-batches; every stage sends on every tick, as JAX's scan does.

The embeddings, the final LayerNorm and the tied head run on every stage
(O(vocab * d) against the stack's O(L * 12 d^2); no embedding stage idles
the pipe). The last stage's outputs reach every stage through a masked
all-reduce over `pipe`, and the input enters through `replicated_in`, so
the head's and the embeddings' gradients are whole on every stage. Each
stage has the gradients of its own blocks only; the train step sums those
over `pipe` (train/train_step.py), so every rank applies the same update.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.mesh import (PIPE_AXIS, all_reduce, axis_group, axis_rank, axis_size, ppermute,
                         replicated_in)
from ..models.common import remat_call
from ..ops.attention import causal_bias, padding_bias

__all__ = ["PIPE_AXIS", "make_gpt2_pp_apply", "pp_param_shardings"]


def make_gpt2_pp_apply(cfg, mesh, n_micro: int, remat: bool = False):
    """A drop-in for the port's GPT2.forward with the block stack pipelined
    over the mesh's `pipe` axis: `apply(lm, inputs_embeds, attention_mask=
    None, logits_slice=None)` -> logits, on every stage. The batch is this
    rank's rows (the data axis shards it before). Bind the LM for the train
    step's `lm_apply`: functools.partial(apply, model.lm). Raises JAX's
    ValueErrors: layers not divisible by `pipe`, a batch not divisible by
    n_micro."""
    n_stages = axis_size(mesh, PIPE_AXIS)
    if cfg.n_layer % n_stages != 0:
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by pipe={n_stages}")
    stage = axis_rank(mesh, PIPE_AXIS)
    group = axis_group(mesh, PIPE_AXIS)
    per = cfg.n_layer // n_stages
    last = n_stages - 1

    def chunk_apply(lm, x, bias):
        for block in lm.blocks[stage * per:(stage + 1) * per]:
            x = remat_call(block, x, bias) if remat else block(x, bias)
        return x

    def apply(lm, inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
              logits_slice: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        b, t, _ = inputs_embeds.shape
        if b % n_micro != 0:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        x = replicated_in(inputs_embeds + lm.wpe[:t][None], group)
        bias = causal_bias(t, t, device=x.device)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        mb = b // n_micro
        xs = x.split(mb)
        biases = bias.split(mb) if bias.shape[0] == b else [bias] * n_micro

        # Every stage sends on every tick, and every send must be a node of
        # the backward on every stage, run in the same order: an idle tick
        # sends zeros made from the input (so they carry its gradient
        # requirement), each ppermute waits for the previous one (`after`),
        # and the last received buffer reaches the output times zero.
        idle = xs[0] * 0
        buf = idle
        ys = [idle for _ in range(n_micro)]
        for tick in range(n_micro + n_stages - 1):
            m = tick - stage  # the micro-batch this stage holds at this tick
            if 0 <= m < n_micro:
                out = chunk_apply(lm, xs[m] if stage == 0 else buf, biases[m])
                if stage == last:
                    ys[m] = out
            else:  # warm-up or drain: nothing to run, the ring still turns
                out = idle
            buf = ppermute(out, group, 1, after=buf if tick else None)
        # only the last stage holds real outputs: broadcast them
        y = torch.cat(ys) if stage == last else torch.zeros_like(x)
        x = all_reduce(y + buf.sum() * 0 if n_stages > 1 else y, group)

        if logits_slice is not None:
            x = x[:, logits_slice[0]: logits_slice[1]]
        return lm.head(x)

    return apply


def pp_param_shardings(lm, mesh) -> dict:
    """{parameter name: the pipe stage holding it, or None (replicated on
    every stage)}: `blocks.{i}.*` belongs to stage i // (L / S), as JAX's
    P("pipe") on the stacked [L] axis chunks it."""
    n_stages = axis_size(mesh, PIPE_AXIS)
    per = len(lm.blocks) // n_stages
    out = {}
    for name, _ in lm.named_parameters():
        parts = name.split(".")
        out[name] = int(parts[1]) // per if parts[0] == "blocks" else None
    return out
