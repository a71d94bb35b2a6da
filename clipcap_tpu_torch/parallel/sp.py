"""Sequence parallelism: ring attention for the long-sequence encoders
(port of clipcap_tpu/parallel/sp.py).

The BLIP visual encoder runs at T=577 (24x24 patches + CLS at 384 px); at
larger grids the [B, H, T, T] scores and the per-token activations outgrow
one card. Sequence parallelism shards the TOKEN axis over the mesh's
`model` axis (the batch over `data`, so an encode is 2-D parallel):
layernorm, MLP and projections are per token, and attention runs as a
RING: each rank keeps flash-style online-softmax partials (running max,
running denominator, running output, all f32) for its own queries while
the K/V blocks rotate around the ring with `ppermute`. The [T, T] scores
never exist whole on any rank.

The blocks use plain torch attention, not the fused kernel K1, as JAX's
use XLA's and not Pallas: a shard's sequence is T/N long, and the fused
kernel's gain at T=577 does not carry to T=577/N.

Every replicated value that enters the sharded region (the tokens, the
blocks' weights) passes `replicated_in` and every result leaves through a
differentiable all-gather, so a gradient through `apply` is the
one-card gradient on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import ViTConfig
from ..core.mesh import (DATA_AXIS, MODEL_AXIS, all_gather, axis_group, axis_rank,
                         axis_size, ppermute, replicated_in, shift_ring)
from ..ops import quant
from ..ops.activations import gelu_exact, quick_gelu
from ..ops.attention import NEG_INF
from ..ops.layernorm import layer_norm


def ring_attention_shard(
    q: torch.Tensor,  # [B, Tl, H, Dh] local queries
    k: torch.Tensor,  # [B, Tl, H, Dh] local keys (will rotate)
    v: torch.Tensor,  # [B, Tl, H, Dh] local values (will rotate)
    kv_valid: torch.Tensor,  # [Tl] bool, key validity of the LOCAL block
    *,
    group,
    n_shards: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """This rank's ring-attention body: full (non-causal) attention of the
    local queries over the global key set, accumulated one rotating block
    at a time with the online-softmax recurrence, in f32. Matches
    ops.attention.dot_product_attention with a key-padding bias up to f32
    accumulation order. K/V (one stacked buffer) and validity rotate
    n_shards times; with one shard nothing is sent. Returns [B, Tl, H, Dh]
    in q's dtype."""
    b, tl, h, dh = q.shape
    if scale is None:
        scale = dh**-0.5
    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, tl, dh), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    valid = kv_valid
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    for _ in range(n_shards):
        k_blk, v_blk = kv[0], kv[1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
        ok = valid[None, None, None, :]
        logits = torch.where(ok, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # exp() of masked entries is forced to 0 (not exp(NEG_INF - m)):
        # on a fully-masked block with m still at NEG_INF that difference
        # would be exp(0) = 1 and corrupt the denominator.
        p = torch.where(ok, torch.exp(logits - m_new[..., None]), zero)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
        if n_shards > 1:
            kv = ppermute(kv, group, 1)
            valid = shift_ring(valid.to(torch.uint8), group, 1).bool()
    out = o / l[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _sp_block(x, block, valid, act, *, group, n_shards, data_group=None):
    """A ViTBlock's forward with ring attention over the sharded tokens;
    its weights enter through replicated_in (over `model`, and `data`)."""
    b, tl, d = x.shape
    heads = block.heads
    w = {name: replicated_in(replicated_in(p, data_group), group)
         for name, p in block.named_parameters()}

    h = layer_norm(x, w["ln1.weight"], w["ln1.bias"], eps=block.ln1.eps)
    qkv = quant.linear(h, w["qkv.weight"], w["qkv.bias"])
    q, k, v = (y.reshape(b, tl, heads, d // heads) for y in qkv.chunk(3, dim=-1))
    attn = ring_attention_shard(q, k, v, valid, group=group, n_shards=n_shards).reshape(b, tl, d)
    x = x + quant.linear(attn, w["out.weight"], w["out.bias"])

    h = layer_norm(x, w["ln2.weight"], w["ln2.bias"], eps=block.ln2.eps)
    h = act(quant.linear(h, w["fc1.weight"], w["fc1.bias"]))
    return x + quant.linear(h, w["fc2.weight"], w["fc2.bias"])


def make_vit_sp_apply(cfg: ViTConfig, mesh, remat: bool = False):
    """A drop-in for the port's ViT.forward with the token axis sharded
    over the mesh's `model` axis and the batch over `data`:
    `apply(vit, pixels, output=None)` takes the whole batch and returns
    the whole result on every rank.

    The token axis (grid² + 1, e.g. 577) is zero-padded to a multiple of
    the shard count; padded KEYS are masked out of every softmax, padded
    QUERY rows are dropped before the output heads."""
    from ..models.vit import patchify

    n_shards = axis_size(mesh, MODEL_AXIS)
    n_data = axis_size(mesh, DATA_AXIS)
    mgroup, dgroup = axis_group(mesh, MODEL_AXIS), axis_group(mesh, DATA_AXIS)
    shard, drank = axis_rank(mesh, MODEL_AXIS), axis_rank(mesh, DATA_AXIS)
    act = quick_gelu if cfg.style == "clip" else gelu_exact

    def block_fn(x, block, valid):
        return _sp_block(x, block, valid, act, group=mgroup, n_shards=n_shards,
                         data_group=dgroup)

    if remat:
        import torch.utils.checkpoint as ckpt

        def block_fn(x, block, valid, _plain=block_fn):  # noqa: F811
            return ckpt.checkpoint(_plain, x, block, valid, use_reentrant=False)

    def apply(vit, pixels: torch.Tensor, output: Optional[str] = None) -> torch.Tensor:
        if output is None:
            output = "pooled" if cfg.style == "clip" else "tokens"
        b = pixels.shape[0]
        if b % n_data != 0:
            raise ValueError(f"batch {b} not divisible by data={n_data}")
        per = b // n_data
        pixels = replicated_in(pixels, dgroup)[drank * per:(drank + 1) * per]
        params = {n: replicated_in(p, dgroup) for n, p in vit.named_parameters()
                  if not n.startswith("blocks.")}
        x = quant.linear(patchify(pixels, cfg.patch_size), params["patch.weight"],
                         params.get("patch.bias"))
        cls = params["cls"].to(x.dtype).expand(per, 1, -1)
        x = torch.cat([cls, x], dim=1)
        t = x.shape[1]
        x = x + params["pos"][None, :t]
        if cfg.style == "clip":
            x = layer_norm(x, params["ln_pre.weight"], params["ln_pre.bias"],
                           eps=cfg.layer_norm_epsilon)

        t_pad = -(-t // n_shards) * n_shards
        tl = t_pad // n_shards
        x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
        valid = torch.arange(t_pad, device=x.device) < t
        x = replicated_in(x, mgroup)[:, shard * tl:(shard + 1) * tl]
        valid = valid[shard * tl:(shard + 1) * tl]
        for block in vit.blocks:
            x = block_fn(x, block, valid)
        x = all_gather(x, mgroup, dim=1)[:, :t]

        def ln_post(y):
            return layer_norm(y, params["ln_post.weight"], params["ln_post.bias"],
                              eps=cfg.layer_norm_epsilon)

        if output == "pooled":
            out = ln_post(x[:, 0])
            if "proj" in params:
                out = out @ params["proj"]
        elif output == "tokens_proj":
            if "proj" not in params:
                raise ValueError("tokens_proj needs a projection (CLIP-style ViT)")
            out = x @ params["proj"]
        elif output == "tokens":
            out = ln_post(x)
        else:
            raise ValueError(f"unknown ViT output mode {output!r}")
        return all_gather(out, dgroup, dim=0)

    return apply
