"""GPT-2 decoder stack with a KV cache (port of clipcap_tpu/models/gpt2.py).

Numerics follow HF's GPT2LMHeadModel (gelu_new MLP, pre-LN, causal plus
additive padding mask, tied lm_head). Activations are [B, T, D]; linear
weights are nn.Linear's [out, in] (convert.py transposes the JAX package's
[in, out]); the KV cache is `KVCache(k, v, index)` with k and v
[L, B, maxT, H, Dh] and `index` the number of valid positions, a Python
int. `prefill` and `decode_step` write the cache IN PLACE and return a
KVCache holding the same tensors with the index advanced.

The JAX module's `init` is the `GPT2` constructor (seeded weights) and
its `apply` is `GPT2.forward`; `embed_tokens`, `init_cache`, `prefill`
and `decode_step` are methods. Ported from `_forward_cached` are its semantics, not its TPU layout: the
cache does not ride in a scan carry, and a decode step attends the first
index+1 cached positions instead of the full maxT width under a mask.
The ring branch (`decode_step_ring`, `scatter_refill`) serves continuous
batching: the time axis is a ring written at index % maxT, and each row
attends the full ring under its own window bias (ops/ring.py). Decode
attention is plain torch ops, as the JAX package's is a plain einsum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import GPT2Config
from ..ops.activations import gelu_new
from ..ops.attention import causal_bias, dot_product_attention, padding_bias
from ..ops.layernorm import LayerNorm
from ..ops.ring import paste_rows, refill_positions, ring_layout
from .common import linear, make_generator, normal, remat_call


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, maxT, H, Dh]
    v: torch.Tensor  # [L, B, maxT, H, Dh]
    index: int  # number of valid positions


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, gen, device, dtype):
        super().__init__()
        d = cfg.n_embd
        resid_std = 0.02 / (2 * cfg.n_layer) ** 0.5  # GPT-2 paper residual-proj scaling
        kw = dict(bias=True, gen=gen, device=device, dtype=dtype)
        self.n_head = cfg.n_head
        self.ln1 = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.c_attn = linear(d, 3 * d, std=0.02, **kw)
        self.c_proj = linear(d, d, std=resid_std, **kw)
        self.ln2 = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.c_fc = linear(d, 4 * d, std=0.02, **kw)
        self.mlp_proj = linear(4 * d, d, std=resid_std, **kw)

    def qkv(self, x: torch.Tensor):
        b, t, d = x.shape
        qkv = self.c_attn(self.ln1(x))
        return (y.reshape(b, t, self.n_head, d // self.n_head) for y in qkv.chunk(3, dim=-1))

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """Residual attention output, then the MLP half of the block."""
        x = x + self.c_proj(attn.reshape(x.shape).to(x.dtype))
        return x + self.mlp_proj(gelu_new(self.c_fc(self.ln2(x))))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The whole block without a cache (JAX's `_block`)."""
        q, k, v = self.qkv(x)
        return self.finish(x, dot_product_attention(q, k, v, bias=bias))


class GPT2(nn.Module):
    """GPT-2 with the JAX package's init: N(0, 0.02) weights, zero biases,
    residual projections at 0.02/sqrt(2L)."""

    def __init__(self, cfg: GPT2Config, *, device="cuda", dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(seed, device)
        self.blocks = nn.ModuleList(GPT2Block(cfg, gen, device, dtype) for _ in range(cfg.n_layer))
        self.wte = normal((cfg.vocab_size, cfg.n_embd), 0.02, gen, device, dtype)
        self.wpe = normal((cfg.n_positions, cfg.n_embd), 0.02, gen, device, dtype)
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, device=device, dtype=dtype)

    # --- the lm/registry protocol -------------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """wte lookup: the reference's get_embedding_text (lms/GPT2.py:14)."""
        return self.wte[tokens.long()]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and the tied lm_head."""
        return F.linear(self.ln_f(x), self.wte)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # [B, T, D]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1 = attend
        logits_slice: Optional[Tuple[int, int]] = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """Full forward -> logits [B, T, V]; logits_slice=(start, stop)
        runs the head on those positions only ([B, stop-start, V]); remat
        checkpoints each block (JAX's jax.checkpoint of the scan body)."""
        _, t, _ = inputs_embeds.shape
        x = inputs_embeds + self.wpe[:t][None]
        bias = causal_bias(t, t, device=x.device)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        for block in self.blocks:
            x = remat_call(block, x, bias) if remat else block(x, bias)
        if logits_slice is not None:
            x = x[:, logits_slice[0]: logits_slice[1]]
        return self.head(x)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """A fresh cache: zeros [L, batch, max_len, H, Dh], index 0."""
        cfg = self.cfg
        shape = (cfg.n_layer, batch, max_len, cfg.n_head, cfg.n_embd // cfg.n_head)
        kw = dict(dtype=dtype or self.wte.dtype, device=self.wte.device)
        return KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw), index=0)

    def _forward_cached(self, inputs_embeds: torch.Tensor, cache: KVCache, fresh: bool,
                        full_logits: bool, ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, KVCache]:
        _, t, _ = inputs_embeds.shape
        idx = cache.index
        a_len = cache.k.shape[2]
        if ring is not None:
            if t != 1:
                raise ValueError("ring mode is decode-only (t == 1); refills prefill a fresh "
                                 "small cache and scatter_refill it in")
            pos, start = ring
            wslot, ring_bias = ring_layout(idx, a_len, start)
            # each serving slot is at its own logical position
            x = inputs_embeds + self.wpe[pos.long()][:, None].to(inputs_embeds.dtype)
            bias = ring_bias[:, None, None, :]  # [B, 1, 1, T]
        else:
            if idx + t > a_len:
                raise ValueError(f"cache of {a_len} positions cannot take {idx + t}")
            wslot = idx
            x = inputs_embeds + self.wpe[idx: idx + t][None].to(inputs_embeds.dtype)
            # query idx+i attends keys <= idx+i; a fresh prefill attends only its own keys
            bias = causal_bias(t, idx + t, device=x.device) if t > 1 else None
        for layer, block in enumerate(self.blocks):
            q, k, v = block.qkv(x)
            cache.k[layer, :, wslot: wslot + t] = k.to(cache.k.dtype)
            cache.v[layer, :, wslot: wslot + t] = v.to(cache.v.dtype)
            if fresh:
                attn = dot_product_attention(q, k, v, bias=bias)
            else:
                # the ring attends its whole width under the window bias
                end = a_len if ring is not None else idx + t
                keys = cache.k[layer, :, :end]
                vals = cache.v[layer, :, :end]
                attn = dot_product_attention(q.to(keys.dtype), keys, vals, bias=bias)
            x = block.finish(x, attn)
        if not full_logits:
            x = x[:, -1:]
        return self.head(x), KVCache(cache.k, cache.v, idx + t)

    def prefill(self, inputs_embeds: torch.Tensor, cache: KVCache,
                full_logits: bool = False) -> Tuple[torch.Tensor, KVCache]:
        """Encode the prompt into a FRESH cache (index 0). Returns logits
        [B, 1, V] (last position) unless full_logits, and the cache."""
        if cache.index != 0:
            raise ValueError("prefill needs a fresh cache (index 0)")
        return self._forward_cached(inputs_embeds, cache, fresh=True, full_logits=full_logits)

    def decode_step(self, token_embed: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """One autoregressive step: token_embed [B, 1, D] -> logits [B, V]."""
        logits, cache = self._forward_cached(token_embed, cache, fresh=False, full_logits=False)
        return logits[:, -1], cache

    def decode_step_ring(self, token_embed: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                         start: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """Ring-cache decode step for continuous batching (decode/serving.py).

        cache.index is the GLOBAL step counter: the slab write lands at
        index % maxT, the token's position embedding is wpe[pos[b]], and row
        b attends exactly its own request's window [start[b], index]
        (ops/ring.ring_layout). Requires maxT >= prompt + lifetime + 1: the
        write at `index` overwrites timestep index - maxT, which the
        longest-lived row still needs at equality."""
        logits, cache = self._forward_cached(token_embed, cache, fresh=False, full_logits=False,
                                             ring=(pos, start))
        return logits[:, -1], cache

    @staticmethod
    def scatter_refill(cache: KVCache, small: KVCache, q: int) -> KVCache:
        """Write a freshly prefilled R-row cache (init_cache(R, P) + prefill)
        IN PLACE into the contiguous ring-cache row block [q, q+R). Its P
        entries claim global timesteps [index - P, index - 1], the ring slots
        (index - P + i) % maxT: the window ring_layout grants a row with
        start = index - P. The index is unchanged."""
        rp = refill_positions(cache.index, small.k.shape[2], cache.k.shape[2], cache.k.device)
        paste_rows(cache.k, small.k, q, rp, time_axis=2)
        paste_rows(cache.v, small.v, q, rp, time_axis=2)
        return KVCache(cache.k, cache.v, cache.index)

