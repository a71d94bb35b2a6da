"""GPT-J decoder stack with a KV cache (port of clipcap_tpu/models/gptj.py).

Numerics follow HF's GPTJForCausalLM: interleaved ("rotate-every-two")
rotary positions on the first `rotary_dim` dims of q and k, one LayerNorm
feeding both the attention and the MLP (the parallel residual
x + attn + mlp), biasless q/k/v/out projections, a gelu_new MLP and a
biased, untied lm_head. Linear weights are nn.Linear's [out, in]
(convert.py transposes the JAX package's [in, out]).

The JAX module's `init` is the `GPTJ` constructor and its `apply` is
`GPTJ.forward`. The cache is gpt2.KVCache (k, v [L, B, maxT, H, Dh] and a
host-int index); `prefill` and `decode_step` write it IN PLACE. K is
cached after rotary, at its writer's logical position, so the ring step
(`decode_step_ring`: rotary at each row's own position) needs no
re-rotation when windows shift per row.

Dtypes follow JAX's promotion. The sin/cos table is f32, so in a bf16
model the rotary turns q and k into f32 (bf16 * f32 -> f32, the
pass-through dims widened exactly). The full forward attends those f32
keys; the cached path writes k into the cache (rounded to the cache's
dtype) and attends what it reads back, in prefill too, as JAX's
`_forward_cached` does. v stays in the model's dtype and the softmax
weights are cast to it. The logits divide by sqrt(f32(Dh)) held as a
tensor: CUDA turns a division by a Python scalar into a multiplication by
its reciprocal, which rounds differently where sqrt(Dh) is not a power
of two.

Attention is plain torch ops (JAX's is XLA einsums, not a Pallas kernel);
at GPT-J-6B's head width of 256 it never takes the fused kernel K1, which
serves the ViT's heads of 64.

`GPTJInt8` (below, with `quantize_params`) is the int8 decode module, as
JAX's `gptj_int8`: int8 weights and KV cache, bf16 activations. It has
no multi-token continuation, no shared-prefix beam cache and no full
forward, as JAX's adapter has none: int8 beam search runs on the
replicated int8 cache, and speculative verification with an int8 target
runs one decode step per chunk token. `apply_q8` is JAX's W8A16 full
forward over the int8 weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import GPTJConfig
from ..ops.activations import gelu_new
from ..ops.attention import NEG_INF, causal_bias, padding_bias
from ..ops.layernorm import LayerNorm, layer_norm
from ..ops.quant import Int8Linear, quantize_rows, quantize_weight
from ..ops.ring import paste_rows, refill_positions, ring_layout
from .common import gather_rows, linear, make_generator, normal, remat_call
from .gpt2 import GPT2Int8, Int8KVCache, KVCache, _int_dot


def rotary_sincos(positions: torch.Tensor, rotary_dim: int):
    """GPT-J's sinusoid table in f32: inv_freq over pairs, each angle's sin
    and cos duplicated interleaved. positions [T] -> sin, cos [T, rd]."""
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=positions.device) / rotary_dim
    inv_freq = 1.0 / (10000.0 ** exponent)
    angles = positions.float()[:, None] * inv_freq[None, :]
    return (torch.sin(angles).repeat_interleave(2, dim=-1),
            torch.cos(angles).repeat_interleave(2, dim=-1))


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                 per_row: bool = False) -> torch.Tensor:
    """Rotary on the first rd dims of x [B, T, H, Dh], the rest passed
    through. sin/cos are [T, rd], or [B, rd] with per_row (ring decode: each
    serving slot at its own logical position). The result takes the
    promoted dtype (f32 for a bf16 x), the pass-through dims widened."""
    rd = sin.shape[-1]
    if per_row:
        sin, cos = sin[:, None, None, :], cos[:, None, None, :]
    else:
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    rot = x[..., :rd]
    rot = rot * cos + rotate_every_two(rot) * sin
    return torch.cat([rot, x[..., rd:].to(rot.dtype)], dim=-1)


def _attend(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """GPT-J attention: f32 logits divided by sqrt(f32(Dh)), the softmax
    weights cast to v's dtype. q [B, Tq, H, Dh], keys/vals [B, Tk, H, Dh]
    -> [B, Tq, H*Dh] in v's dtype."""
    b, t, h, dh = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float())
    logits = logits / torch.sqrt(torch.tensor(float(dh), device=q.device))
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1).to(vals.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vals).reshape(b, t, h * dh)


class GPTJBlock(nn.Module):
    tp_group = None  # the model-axis group once tensor-parallel (see GPTJ.shard_heads)

    def __init__(self, cfg: GPTJConfig, gen, device, dtype):
        super().__init__()
        d = cfg.n_embd
        kw = dict(gen=gen, device=device, dtype=dtype, std=0.02)
        self.n_head = cfg.n_head
        self.ln1 = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.wq = linear(d, d, bias=False, **kw)
        self.wk = linear(d, d, bias=False, **kw)
        self.wv = linear(d, d, bias=False, **kw)
        self.wo = linear(d, d, bias=False, **kw)
        self.w_in = linear(d, 4 * d, bias=True, **kw)
        self.w_out = linear(4 * d, d, bias=True, **kw)

    def qkv(self, h: torch.Tensor, sin, cos, per_row: bool = False):
        """q and k after rotary (f32 in a bf16 model), v in h's dtype."""
        b, t, _ = h.shape
        shape = (b, t, self.n_head, -1)
        q = apply_rotary(self.wq(h).reshape(shape), sin, cos, per_row)
        k = apply_rotary(self.wk(h).reshape(shape), sin, cos, per_row)
        return q, k, self.wv(h).reshape(shape)

    def finish(self, x: torch.Tensor, h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """The parallel residual: x + attn_out + mlp_out, both off h.
        Tensor-parallel, each projection's partial sum over this rank's
        heads (wo) or width (w_out) is all-reduced, JAX's two psums; b_out
        rides rank 0's partial, so it enters the sum once and one rank
        computes the unsharded block bit for bit."""
        if self.tp_group is None:
            return x + self.wo(attn) + self.w_out(gelu_new(self.w_in(h)))
        from ..core.mesh import all_reduce

        bias = self.w_out.bias if torch.distributed.get_rank(self.tp_group) == 0 else None
        mlp = nn.functional.linear(gelu_new(self.w_in(h)), self.w_out.weight, bias)
        return x + all_reduce(self.wo(attn), self.tp_group) + all_reduce(mlp, self.tp_group)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
        """The whole block without a cache (JAX's `_block`)."""
        h = self.ln1(x)
        q, k, v = self.qkv(h, sin, cos)
        return self.finish(x, h, _attend(q, k, v, bias))


class GPTJ(nn.Module):
    """GPT-J with the JAX package's init: N(0, 0.02) weights (the embedding
    and the lm_head too), zero biases, unit LayerNorms.

    `tp_group`, a model-axis process group, makes it tensor-parallel
    (shard_heads): rank r keeps heads [r*H/M, (r+1)*H/M) of wq/wk/wv and
    their rows of wo (as [out, in]: wo's columns), w_in/b_in's rows r of M
    and w_out's matching columns, and rows r of M of the lm_head (a
    vocabulary slice). Two all-reduces a layer (GPTJBlock.finish), a KV
    cache of the local heads, and the logits all-gathered over the group
    before they leave `head`, so every rank samples the same token from the
    same row. Without a group the code path is the one-card one."""

    chunked_forward = True  # forward_cached continues a cache by several positions
    tp_group = None

    def __init__(self, cfg: GPTJConfig, *, device="cuda", dtype=torch.float32, seed: int = 0,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(seed, device)
        self.blocks = nn.ModuleList(GPTJBlock(cfg, gen, device, dtype) for _ in range(cfg.n_layer))
        self.wte = normal((cfg.vocab_size, cfg.n_embd), 0.02, gen, device, dtype)
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.lm_head = linear(cfg.n_embd, cfg.vocab_size, bias=True, gen=gen, device=device,
                              dtype=dtype, std=0.02)
        if tp_group is not None:
            self.shard_heads(tp_group)

    def shard_heads(self, group) -> "GPTJ":
        """Keep this rank's tensor-parallel shard of every weight, in place,
        by the rules of parallel/tp.py (`_GPTJ_RULES`), and run
        tensor-parallel over `group` from now on. Raises ValueError where
        the heads, the MLP width or the vocabulary do not divide."""
        from ..parallel.tp import local_shard, tp_axes

        m = torch.distributed.get_world_size(group)
        r = torch.distributed.get_rank(group)
        axes = tp_axes(self)
        with torch.no_grad():
            for name, p in list(self.named_parameters()):
                if axes[name] is not None:
                    p.data = local_shard(p.data, axes[name], m, r, name)
        for block in self.blocks:
            block.n_head = self.cfg.n_head // m
            block.tp_group = group
        self.tp_group = group
        return self

    # --- the lm/registry protocol -------------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.wte, tokens)

    def embedding_size(self) -> int:
        return self.wte.shape[1]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.lm_head(self.ln_f(x))
        if self.tp_group is None:
            return logits
        from ..core.mesh import all_gather

        return all_gather(logits, self.tp_group, dim=-1)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # [B, T, D]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1 = attend
        logits_slice: Optional[Tuple[int, int]] = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """Full forward -> logits [B, T, V] (JAX's `apply`); logits_slice
        and remat as GPT2.forward's."""
        _, t, _ = inputs_embeds.shape
        x = inputs_embeds
        sin, cos = rotary_sincos(torch.arange(t, device=x.device), self.cfg.rotary_dim)
        bias = causal_bias(t, t, device=x.device)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        for block in self.blocks:
            x = remat_call(block, x, bias, sin, cos) if remat else block(x, bias, sin, cos)
        if logits_slice is not None:
            x = x[:, logits_slice[0]: logits_slice[1]]
        return self.head(x)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """A fresh cache: zeros [L, batch, max_len, H, Dh] (H this rank's
        heads when tensor-parallel), index 0."""
        cfg = self.cfg
        shape = (cfg.n_layer, batch, max_len, self.blocks[0].n_head, cfg.n_embd // cfg.n_head)
        kw = dict(dtype=dtype or self.wte.dtype, device=self.wte.device)
        return KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw), index=0)

    def _forward_cached(self, inputs_embeds: torch.Tensor, cache: KVCache, full_logits: bool,
                        ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, KVCache]:
        """t positions after the cache's index (a fresh prefill, a decode
        step, or a multi-token continuation), or one ring step."""
        _, t, _ = inputs_embeds.shape
        idx, a_len = cache.index, cache.k.shape[2]
        rd = self.cfg.rotary_dim
        dev = inputs_embeds.device
        if ring is not None:
            if t != 1:
                raise ValueError("ring mode is decode-only (t == 1)")
            pos, start = ring
            wslot, ring_bias = ring_layout(idx, a_len, start)
            bias = ring_bias[:, None, None, :]  # [B, 1, 1, maxT]
            sin, cos = rotary_sincos(pos, rd)  # [B, rd]: each row at its own position
            end = a_len
        else:
            if idx + t > a_len:
                raise ValueError(f"cache of {a_len} positions cannot take {idx + t}")
            wslot, end = idx, idx + t
            sin, cos = rotary_sincos(torch.arange(idx, idx + t, device=dev), rd)
            # query idx+i attends keys <= idx+i
            bias = causal_bias(t, idx + t, device=dev) if t > 1 else None
        x = inputs_embeds
        for layer, block in enumerate(self.blocks):
            h = block.ln1(x)
            q, k, v = block.qkv(h, sin, cos, per_row=ring is not None)
            cache.k[layer, :, wslot: wslot + t] = k.to(cache.k.dtype)
            cache.v[layer, :, wslot: wslot + t] = v.to(cache.v.dtype)
            attn = _attend(q, cache.k[layer, :, :end], cache.v[layer, :, :end], bias)
            x = block.finish(x, h, attn.to(x.dtype))
        if not full_logits:
            x = x[:, -1:]
        return self.head(x), KVCache(cache.k, cache.v, idx + t)

    def prefill(self, inputs_embeds: torch.Tensor, cache: KVCache,
                full_logits: bool = False) -> Tuple[torch.Tensor, KVCache]:
        """Encode the prompt into a FRESH cache (index 0): logits [B, 1, V]
        (every position with full_logits) and the cache."""
        if cache.index != 0:
            raise ValueError("prefill needs a fresh cache (index 0)")
        return self._forward_cached(inputs_embeds, cache, full_logits=full_logits)

    def forward_cached(self, inputs_embeds: torch.Tensor,
                       cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """Continue the cache by T positions: logits [B, T, V] (JAX's
        `_forward_cached`, which speculative verification drives)."""
        return self._forward_cached(inputs_embeds, cache, full_logits=True)

    def decode_step(self, token_embed: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        logits, cache = self._forward_cached(token_embed, cache, full_logits=False)
        return logits[:, -1], cache

    def decode_step_ring(self, token_embed: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                         start: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """Ring-cache decode step (GPT2.decode_step_ring's contract), rotary
        at each row's logical position pos[b]."""
        logits, cache = self._forward_cached(token_embed, cache, full_logits=False,
                                             ring=(pos, start))
        return logits[:, -1], cache

    @staticmethod
    def scatter_refill(cache: KVCache, small: KVCache, q: int) -> KVCache:
        """GPT2.scatter_refill: a freshly prefilled R-row cache written IN
        PLACE into the ring rows [q, q+R) at the window's ring slots."""
        rp = refill_positions(cache.index, small.k.shape[2], cache.k.shape[2], cache.k.device)
        paste_rows(cache.k, small.k, q, rp, time_axis=2)
        paste_rows(cache.v, small.v, q, rp, time_axis=2)
        return KVCache(cache.k, cache.v, cache.index)


# --- int8 decode (port of gptj.py:358-606) --------------------------------------------
#
# GPT-2's int8 design (models/gpt2.py): per-output-channel int8 weights,
# dynamic per-row activation scales, and a head-major int8 KV cache
# [L, B, H, maxT, Dh] with per-position f32 scales. The cache holds K
# after rotary. A fresh prefill attends in f32 on this call's own q/k/v; a
# decode step quantizes q (f32 after rotary) and scores the full maxT width
# under a bias, the V scales folded into the probabilities before they are
# row-quantized. The f32 matmuls on int8 values are exact at GPT-J's
# widths: q.k sums at most 256 * 127^2 ~ 4.1e6 and p.v at most
# 127^2 * maxT, both below 2^24 for maxT <= 1040.

INT8_LINEARS = ("wq", "wk", "wv", "wo", "w_in", "w_out", "lm_head")


class _Int8Block(GPTJBlock):
    """GPTJBlock's computation over int8 linears. Allocated as zeros;
    quantize_params or convert.load fills it. The LayerNorm and the MLP
    biases keep the float model's dtype, as JAX's quantize_params keeps
    those leaves."""

    def __init__(self, cfg: GPTJConfig, device, dtype):
        nn.Module.__init__(self)  # not GPTJBlock's: it would draw float weights
        d = cfg.n_embd
        self.n_head = cfg.n_head
        self.ln1 = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, Int8Linear.empty(d, d, device=device))
        self.w_in = Int8Linear.empty(d, 4 * d, bias_dtype=dtype, device=device)
        self.w_out = Int8Linear.empty(4 * d, d, bias_dtype=dtype, device=device)

    def finish(self, x: torch.Tensor, h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """GPTJBlock.finish, the MLP's int8 input quantized from gelu_new's
        unrounded f32 product, as compiled JAX quantizes it."""
        m = gelu_new(self.w_in(h), f32_product=True)
        return x + self.wo(attn) + self.w_out(m, out_dtype=x.dtype)


class GPTJInt8(nn.Module):
    """The int8 decode LM (JAX's `gptj_int8` over `quantize_params` output):
    the six linears of each block and the lm_head int8 (GPT-J's vocabulary
    of 50400 is a multiple of 8, so no channel is padded), wte, the
    LayerNorms and the biases in `dtype`. Activations are bf16 and the
    logits f32. Build it with `quantize_params(gptj)`, or allocate it and
    fill it with convert.load(GPTJInt8(cfg, dtype=...),
    convert.gptj_state_dict(jax_int8_tree))."""

    chunked_forward = False  # one position per row: verification steps token by token

    def __init__(self, cfg: GPTJConfig, *, device="cuda", dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_embd
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, d, dtype=dtype, device=device),
                                requires_grad=False)
        self.blocks = nn.ModuleList(_Int8Block(cfg, device, dtype) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.lm_head = Int8Linear.empty(d, cfg.vocab_size, bias_dtype=dtype, device=device)
        self.requires_grad_(False)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.wte, tokens)

    def embedding_size(self) -> int:
        return self.wte.shape[1]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(x), out_dtype=torch.float32)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> Int8KVCache:
        """A fresh int8 cache, index 0 (`dtype` is taken for the protocol and
        ignored, as in JAX)."""
        cfg, dev = self.cfg, self.wte.device
        shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.n_embd // cfg.n_head)
        return Int8KVCache(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                           v=torch.zeros(shape, dtype=torch.int8, device=dev),
                           ks=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                           vs=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                           index=0)

    def _forward_cached(self, inputs_embeds: torch.Tensor, cache: Int8KVCache, fresh: bool,
                        full_logits: bool,
                        ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, Int8KVCache]:
        b, t, d = inputs_embeds.shape
        idx, a_len = cache.index, cache.k.shape[3]
        dh = d // self.cfg.n_head
        rd = self.cfg.rotary_dim
        dev = inputs_embeds.device
        if ring is not None:
            if t != 1:
                raise ValueError("ring mode is decode-only (t == 1)")
            pos, start = ring
            wslot, bias = ring_layout(idx, a_len, start)  # [B, maxT]
            sin, cos = rotary_sincos(pos, rd)
        else:
            if idx + t > a_len:
                raise ValueError(f"cache of {a_len} positions cannot take {idx + t}")
            wslot = idx
            sin, cos = rotary_sincos(torch.arange(idx, idx + t, device=dev), rd)
            kpos = torch.arange(a_len, device=dev)[None, :]
            bias = torch.where(kpos <= idx + t - 1, 0.0, NEG_INF)  # [1, maxT]
        prefill = fresh and t > 1
        if not prefill and t != 1:
            raise ValueError("the int8 decode step takes one position per row")
        x = inputs_embeds.to(torch.bfloat16)
        for layer, block in enumerate(self.blocks):
            h = block.ln1(x)
            q, k, v = block.qkv(h, sin, cos, per_row=ring is not None)
            GPT2Int8._write_kv(cache, layer, wslot, k, v)  # K after rotary
            if prefill:
                # f32 attention on this call's own q/k/v; the cache holds the int8 copy
                attn = _attend(q, k, v, causal_bias(t, t, device=dev))
            else:
                q8, sq = quantize_rows(q[:, 0])  # [B, H, Dh], sq [B, H, 1]
                scores = _int_dot(q8[:, :, None], cache.k[layer])[:, :, 0]  # [B, H, maxT]
                scores = scores * sq * cache.ks[layer] * (dh**-0.5) + bias[:, None, :]
                p = torch.softmax(scores, dim=-1)
                pv8, sp = quantize_rows(p * cache.vs[layer])  # V scales folded into p
                attn = _int_dot(pv8[:, :, None], cache.v[layer].transpose(-1, -2))[:, :, 0] * sp
                attn = attn.reshape(b, 1, d)
            x = block.finish(x, h, attn.to(x.dtype))
        if not full_logits:
            x = x[:, -1:]
        return self.head(x), cache._replace(index=idx + t)

    def prefill(self, inputs_embeds: torch.Tensor, cache: Int8KVCache,
                full_logits: bool = False) -> Tuple[torch.Tensor, Int8KVCache]:
        """int8 prefill into a FRESH cache (index 0): logits [B, 1, V] f32
        (every position with full_logits) and the cache."""
        if cache.index != 0:
            raise ValueError("prefill needs a fresh cache (index 0)")
        return self._forward_cached(inputs_embeds, cache, fresh=True, full_logits=full_logits)

    def decode_step(self, token_embed: torch.Tensor,
                    cache: Int8KVCache) -> Tuple[torch.Tensor, Int8KVCache]:
        logits, cache = self._forward_cached(token_embed, cache, fresh=False, full_logits=False)
        return logits[:, -1], cache

    def decode_step_ring(self, token_embed: torch.Tensor, cache: Int8KVCache, pos: torch.Tensor,
                         start: torch.Tensor) -> Tuple[torch.Tensor, Int8KVCache]:
        logits, cache = self._forward_cached(token_embed, cache, fresh=False, full_logits=False,
                                             ring=(pos, start))
        return logits[:, -1], cache

    @staticmethod
    def scatter_refill(cache: Int8KVCache, small: Int8KVCache, q: int) -> Int8KVCache:
        """scatter_refill for the int8 cache: time is axis 3 of every slab."""
        rp = refill_positions(cache.index, small.k.shape[3], cache.k.shape[3], cache.k.device)
        for big, sm in zip(cache[:4], small[:4]):
            paste_rows(big, sm, q, rp, time_axis=3)
        return cache

    def apply_q8(self, inputs_embeds: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None,
                 logits_slice: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """JAX's `apply_q8`: the full-sequence W8A16 forward. Each layer's
        int8 weights are dequantized to bf16 (q * s, both rounded to bf16
        first) and the float block runs on them in bf16, the LayerNorms and
        biases cast to bf16 as well. Logits [B, T, V]: bf16, or f32 where
        the head's bias is f32."""
        bf16 = torch.bfloat16
        _, t, _ = inputs_embeds.shape
        x = inputs_embeds.to(bf16)
        sin, cos = rotary_sincos(torch.arange(t, device=x.device), self.cfg.rotary_dim)
        bias = causal_bias(t, t, device=x.device)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)

        def deq(lin: Int8Linear) -> torch.Tensor:
            return lin.q.to(bf16) * lin.s.to(bf16)[:, None]

        def lin(y, m: Int8Linear):
            out = torch.matmul(y, deq(m).t())
            return out if m.bias is None else out + m.bias.to(bf16)

        for block in self.blocks:
            h = layer_norm(x, block.ln1.weight.to(bf16), block.ln1.bias.to(bf16),
                           block.ln1.eps)
            shape = (*h.shape[:2], block.n_head, -1)
            q = apply_rotary(lin(h, block.wq).reshape(shape), sin, cos)
            k = apply_rotary(lin(h, block.wk).reshape(shape), sin, cos)
            v = lin(h, block.wv).reshape(shape)
            attn = _attend(q, k, v, bias)
            x = x + lin(attn, block.wo) + lin(gelu_new(lin(h, block.w_in)), block.w_out)
        if logits_slice is not None:
            x = x[:, logits_slice[0]: logits_slice[1]]
        # ln_f and the head's bias as stored (JAX dequantizes only the blocks
        # and the head's weight): an f32 bias gives f32 logits
        x = layer_norm(x, self.ln_f.weight, self.ln_f.bias, self.ln_f.eps)
        return torch.matmul(x, deq(self.lm_head).t()) + self.lm_head.bias


@torch.no_grad()
def quantize_params(lm: GPTJ) -> GPTJInt8:
    """The int8 decode LM of a float GPT-J (JAX gptj.quantize_params): the
    six linears of each block and the lm_head quantized per output channel
    from their stored weights; wte, the LayerNorms and the biases kept as
    they are, in the model's dtype. On the LM's device."""
    state = {}
    for name, t in lm.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        if leaf == "weight" and mod.rpartition(".")[2] in INT8_LINEARS:
            wq = quantize_weight(t)
            state[f"{mod}.q"], state[f"{mod}.s"] = wq["q"], wq["s"]
        else:
            state[name] = t
    out = GPTJInt8(lm.cfg, device=lm.wte.device, dtype=lm.wte.dtype)
    out.load_state_dict(state)
    return out
