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
`GPT2Int8` (below, with `quantize_params`) is the int8 decode module: int8
weights and KV cache, bf16 activations, and a decode step over the full
cache width under a bias, as JAX's int8 path attends.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import GPT2Config
from ..ops.activations import gelu_new
from ..ops.attention import NEG_INF, causal_bias, dot_product_attention, padding_bias
from ..ops.layernorm import LayerNorm
from ..ops.quant import (Int8Linear, absmax_scale, pad_channels, quantize_rows,
                         quantize_weight)
from ..ops.ring import paste_rows, refill_positions, ring_layout
from .common import gather_rows, linear, make_generator, normal, remat_call


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

    chunked_forward = True  # forward_cached continues a cache by several positions

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
        """wte lookup: the reference's get_embedding_text (lms/GPT2.py:14),
        out-of-range ids clamped as JAX's gather clamps them."""
        return gather_rows(self.wte, tokens)

    def embedding_size(self) -> int:
        return self.wte.shape[1]

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

    def forward_cached(self, inputs_embeds: torch.Tensor,
                       cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """Continue the cache by T positions: logits [B, T, V] (JAX's
        `_forward_cached` with full logits, which speculative verification
        drives)."""
        return self._forward_cached(inputs_embeds, cache, fresh=False, full_logits=True)

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



# --- int8 decode (port of gpt2.py:384-858) -------------------------------------------
#
# Weights are per-output-channel int8 (ops/quant.py), activations bf16, and
# the KV cache int8 with per-(row, head, position) f32 scales, head-major
# [L, B, H, maxT, Dh], so both attention contractions batch over (B, H).
# The per-position K scales factor out of the scores after the q.K^T dot
# (score_t *= s_q * s_k[t]); the V scales fold into the softmax
# probabilities before the p.V dot (p'_t = p_t * s_v[t], then p' is itself
# row-quantized). A decode step attends the full maxT width under a bias,
# as JAX's int8 path does (its softmax reduces over the same shape).
#
# The int8 x int8 attention dots run as f32 matmuls on int8-valued
# tensors, which is exact: every product is an integer of at most
# 127^2 = 16129, and every partial sum stays below 2^24 (q.k over Dh = 64:
# at most 64 * 16129 ~ 1.03e6; p.v over maxT: at most 16129 * maxT, below
# 2^24 for maxT <= 1040). The linears' sums (up to 6400 * 16129 at GPT2-XL)
# are not, so they go through torch._int_mm (ops/quant.int8_linear).

INT8_LINEARS = ("c_attn", "c_proj", "c_fc", "mlp_proj")


class Int8KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, H, maxT, Dh] int8
    v: torch.Tensor  # [L, B, H, maxT, Dh] int8
    ks: torch.Tensor  # [L, B, H, maxT] f32 per-position K scales
    vs: torch.Tensor  # [L, B, H, maxT] f32 per-position V scales
    index: int  # number of valid positions (ring: the global step counter)


class Int8BeamCache(NamedTuple):
    """Shared-prefix beam cache: the prefill K/V held ONCE PER IMAGE, each
    beam row holding only its generated tail (JAX's Int8BeamCache). Image
    i's beams are rows [i*beam, (i+1)*beam). JAX keeps the tails flat and
    time-major for XLA's tiling and reorders them by a one-hot matmul; here
    they are [L, R, H, NT, Dh] and reorder with index_select."""

    pk: torch.Tensor  # [L, N, H, P, Dh] int8 prefix keys (per image)
    pv: torch.Tensor  # [L, N, H, P, Dh] int8
    pks: torch.Tensor  # [L, N, H, P] f32
    pvs: torch.Tensor  # [L, N, H, P] f32
    k: torch.Tensor  # [L, R, H, NT, Dh] int8 tail keys (per beam row)
    v: torch.Tensor  # [L, R, H, NT, Dh] int8
    ks: torch.Tensor  # [L, R, H, NT] f32
    vs: torch.Tensor  # [L, R, H, NT] f32
    index: int  # GLOBAL position, the prefix included


def _int_dot(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Exact int8 dot of a8 [..., M, K] and b8 [..., N, K] -> [..., M, N]
    f32 (integers below 2^24, see above)."""
    return torch.matmul(a8.float(), b8.float().transpose(-1, -2))


def _quantize_probs(*segments: torch.Tensor):
    """Quantize the rows of several segments of one probability row with ONE
    shared scale: quantize_rows over their concatenation, bit for bit."""
    sp = absmax_scale(torch.stack([s.abs().amax(dim=-1, keepdim=True)
                                   for s in segments]).amax(dim=0))
    return [torch.clamp(torch.round(s / sp), -127, 127) for s in segments], sp


class _Int8Block(GPT2Block):
    """GPT2Block's computation (`qkv`, `finish`) over int8 linears and bf16
    LayerNorms. Allocated as zeros; quantize_params or convert.load fills it."""

    def __init__(self, cfg: GPT2Config, device):
        nn.Module.__init__(self)  # not GPT2Block's: it would draw float weights
        d, bf16 = cfg.n_embd, torch.bfloat16
        self.n_head = cfg.n_head
        self.ln1 = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=bf16)
        self.c_attn = Int8Linear.empty(d, 3 * d, bias_dtype=bf16, device=device)
        self.c_proj = Int8Linear.empty(d, d, bias_dtype=bf16, device=device)
        self.ln2 = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=bf16)
        self.c_fc = Int8Linear.empty(d, 4 * d, bias_dtype=bf16, device=device)
        self.mlp_proj = Int8Linear.empty(4 * d, d, bias_dtype=bf16, device=device)

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """GPT2Block.finish as compiled JAX computes it: ln2 normalizes the
        attention residual's unrounded f32 sum (XLA keeps a bf16 add that
        feeds a norm in f32; the residual stream goes on rounded), and the
        MLP's int8 input is quantized from gelu_new's unrounded f32 product.
        With both, the logits equal jax.jit's bit for bit
        (tests/test_torch_gpt2_int8.py)."""
        y = self.c_proj(attn.reshape(x.shape).to(x.dtype))
        s = x.float() + y  # y widens exactly; rounded, s is the bf16 x + y
        m = gelu_new(self.c_fc(self.ln2(s).to(x.dtype)), f32_product=True)
        return s.to(x.dtype) + self.mlp_proj(m, out_dtype=x.dtype)


class GPT2Int8(nn.Module):
    """The int8 decode LM (JAX's `gpt2_int8` module over `quantize_params`
    output): wte, wpe and the LayerNorms in bf16, the four linears of each
    block int8, and `lm_head` the int8 quantization of wte (its output
    channels zero-padded to a multiple of 8 for torch._int_mm, the logits
    sliced back to the vocabulary). It has the lm/registry decode protocol
    (init_cache, prefill, decode_step, decode_step_ring, scatter_refill,
    embed_tokens) and the shared-prefix beam protocol (beam_prefix_cache,
    decode_step_beam, reorder_beam_tail); like JAX's it has no full forward.
    Build it with `quantize_params(gpt2)`, or allocate it here and fill it
    with convert.load(GPT2Int8(cfg), convert.gpt2_state_dict(jax_int8_tree))."""

    # one position per row (its _forward_cached takes t == 1 outside a fresh
    # prefill): speculative verification steps token by token, as JAX's
    # gpt2_int8 has no _forward_cached
    chunked_forward = False
    # decode_step_ring takes the ring index as a device tensor and reads no
    # value on the host: the serving engine captures it as a CUDA graph
    graph_safe_ring_step = True

    def __init__(self, cfg: GPT2Config, *, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, bf16 = cfg.n_embd, torch.bfloat16
        self.wte = nn.Parameter(torch.zeros(cfg.vocab_size, d, dtype=bf16, device=device),
                                requires_grad=False)
        self.wpe = nn.Parameter(torch.zeros(cfg.n_positions, d, dtype=bf16, device=device),
                                requires_grad=False)
        self.blocks = nn.ModuleList(_Int8Block(cfg, device) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=bf16)
        self.lm_head = Int8Linear.empty(d, pad_channels(self.wte).shape[0], device=device)
        self.requires_grad_(False)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.wte, tokens)

    def embedding_size(self) -> int:
        return self.wte.shape[1]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and the int8 lm_head -> f32 logits over the vocabulary."""
        logits = self.lm_head(self.ln_f(x), out_dtype=torch.float32)
        return logits[..., : self.cfg.vocab_size].contiguous()

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

    @staticmethod
    def _write_kv(cache, layer: int, slot, k: torch.Tensor, v: torch.Tensor):
        """Quantize k/v [B, T, H, Dh] per (row, position, head) and write them
        head-major at time positions [slot, slot + T) of `layer`, in place.
        `slot` is a host int, or for one position a 0-d tensor on the device
        (the ring step's device index)."""
        t = k.shape[1]
        for slab, scales, y in ((cache.k, cache.ks, k), (cache.v, cache.vs, v)):
            y8, s = quantize_rows(y)
            if isinstance(slot, torch.Tensor):
                at = slot.reshape(1)
                slab[layer].index_copy_(2, at, y8.transpose(1, 2))
                scales[layer].index_copy_(2, at, s[..., 0].transpose(1, 2))
            else:
                slab[layer, :, :, slot: slot + t] = y8.transpose(1, 2)
                scales[layer, :, :, slot: slot + t] = s[..., 0].transpose(1, 2)

    def _forward_cached(self, inputs_embeds: torch.Tensor, cache: Int8KVCache, fresh: bool,
                        full_logits: bool, ring: Optional[tuple] = None
                        ) -> Tuple[torch.Tensor, Int8KVCache]:
        b, t, d = inputs_embeds.shape
        idx, a_len = cache.index, cache.k.shape[3]
        dh = d // self.cfg.n_head
        x = inputs_embeds.to(torch.bfloat16)
        if ring is not None:
            if t != 1:
                raise ValueError("ring mode is decode-only (t == 1)")
            pos, start, index = ring
            # [B, maxT]; a device index places the write and the window on the card
            wslot, bias = ring_layout(idx if index is None else index, a_len, start)
            x = x + self.wpe[pos.long()][:, None]
        else:
            if idx + t > a_len:
                raise ValueError(f"cache of {a_len} positions cannot take {idx + t}")
            wslot = idx
            x = x + self.wpe[idx: idx + t][None]
            kpos = torch.arange(a_len, device=x.device)[None, :]
            bias = torch.where(kpos <= idx + t - 1, 0.0, NEG_INF)  # [1, maxT]
        prefill = fresh and t > 1
        if not prefill and t != 1:
            raise ValueError("the int8 decode step takes one position per row")
        for layer, block in enumerate(self.blocks):
            q, k, v = block.qkv(x)
            self._write_kv(cache, layer, wslot, k, v)
            if prefill:
                # bf16 attention on this call's own q/k/v; the cache holds the int8 copy
                attn = dot_product_attention(q, k, v, bias=causal_bias(t, t, device=x.device))
            else:
                q8, sq = quantize_rows(q[:, 0])  # [B, H, Dh], sq [B, H, 1]
                scores = _int_dot(q8[:, :, None], cache.k[layer])[:, :, 0]  # [B, H, maxT]
                scores = scores * sq * cache.ks[layer] * (dh**-0.5) + bias[:, None, :]
                p = torch.softmax(scores, dim=-1)
                pv8, sp = quantize_rows(p * cache.vs[layer])  # V scales folded into p
                attn = _int_dot(pv8[:, :, None], cache.v[layer].transpose(-1, -2))[:, :, 0] * sp
            x = block.finish(x, attn.to(x.dtype))
        if not full_logits:
            x = x[:, -1:]
        return self.head(x), cache._replace(index=idx + t)

    def prefill(self, inputs_embeds: torch.Tensor, cache: Int8KVCache,
                full_logits: bool = False) -> Tuple[torch.Tensor, Int8KVCache]:
        """int8 prefill into a FRESH cache (index 0): logits [B, 1, V] (all
        positions with full_logits) and the cache."""
        if cache.index != 0:
            raise ValueError("prefill needs a fresh cache (index 0)")
        return self._forward_cached(inputs_embeds, cache, fresh=True, full_logits=full_logits)

    def decode_step(self, token_embed: torch.Tensor,
                    cache: Int8KVCache) -> Tuple[torch.Tensor, Int8KVCache]:
        """One step: token_embed [B, 1, D] -> logits [B, V], over the full
        cache width under the causal bias."""
        logits, cache = self._forward_cached(token_embed, cache, fresh=False, full_logits=False)
        return logits[:, -1], cache

    def decode_step_ring(self, token_embed: torch.Tensor, cache: Int8KVCache, pos: torch.Tensor,
                         start: torch.Tensor, index: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Int8KVCache]:
        """int8 ring-cache decode step (GPT2.decode_step_ring's contract).
        `index`, a 0-d int64 tensor on the cache's device equal to
        cache.index, gives the step its write slot and window bias from the
        device instead of the host int: the same logits and cache bit for
        bit, from a step whose launches do not change with the index, so a
        CUDA graph captured once replays it at every step. The returned
        cache's host index advances either way."""
        logits, cache = self._forward_cached(token_embed, cache, fresh=False, full_logits=False,
                                             ring=(pos, start, index))
        return logits[:, -1], cache

    @staticmethod
    def scatter_refill(cache: Int8KVCache, small: Int8KVCache, q: int) -> Int8KVCache:
        """GPT2.scatter_refill for the int8 cache: time is axis 3 of every slab."""
        rp = refill_positions(cache.index, small.k.shape[3], cache.k.shape[3], cache.k.device)
        for big, sm in zip(cache[:4], small[:4]):
            paste_rows(big, sm, q, rp, time_axis=3)
        return cache

    # --- the shared-prefix beam cache (JAX gpt2.py:600-835) ---------------------------

    @staticmethod
    def beam_prefix_cache(cache: Int8KVCache, beam: int, p_len: int) -> Int8BeamCache:
        """Split a batch-N prefilled cache (index == p_len) into the
        shared-prefix beam cache: the prefix slabs are the prefill's own
        bytes; the tails start empty at N*beam rows."""
        l, n, h, maxt, dh = cache.k.shape
        nt, dev = maxt - p_len, cache.k.device

        def tail(*shape, dtype):
            return torch.zeros((l, n * beam, h, nt) + shape, dtype=dtype, device=dev)

        return Int8BeamCache(
            pk=cache.k[:, :, :, :p_len].contiguous(), pv=cache.v[:, :, :, :p_len].contiguous(),
            pks=cache.ks[:, :, :, :p_len].contiguous(),
            pvs=cache.vs[:, :, :, :p_len].contiguous(),
            k=tail(dh, dtype=torch.int8), v=tail(dh, dtype=torch.int8),
            ks=tail(dtype=torch.float32), vs=tail(dtype=torch.float32), index=cache.index)

    def decode_step_beam(self, token_embed: torch.Tensor,
                         bc: Int8BeamCache) -> Tuple[torch.Tensor, Int8BeamCache]:
        """One beam step over the shared-prefix cache: logits [N*beam, V],
        bit-equal to decode_step on the beam-replicated int8 cache. The
        scores over [prefix | tail] concatenate to the row the full step
        softmaxes, and the p.V dot quantizes both segments with one shared
        scale, so splitting the exact integer dot at the segment boundary
        changes no bit. The prefix dot is grouped per image: [N, H, beam,
        Dh] against [N, H, P, Dh]."""
        b, _, d = token_embed.shape
        h = self.cfg.n_head
        dh = d // h
        n_img, p_len = bc.pk.shape[1], bc.pk.shape[3]
        beam, nt = b // n_img, bc.k.shape[3]
        idx = bc.index
        wslot = idx - p_len
        x = token_embed.to(torch.bfloat16) + self.wpe[idx: idx + 1][None]
        tpos = torch.arange(nt, device=x.device)[None, :]
        tail_bias = torch.where(tpos <= wslot, 0.0, NEG_INF)  # [1, NT]

        def group(a):  # [N*beam, H, X] -> [N, H, beam, X]
            return a.reshape(n_img, beam, h, -1).transpose(1, 2)

        def ungroup(a):  # [N, H, beam, X] -> [N*beam, H, X]
            return a.transpose(1, 2).reshape(b, h, -1)

        for layer, block in enumerate(self.blocks):
            q, k, v = block.qkv(x)
            self._write_kv(bc, layer, wslot, k, v)
            q8, sq = quantize_rows(q[:, 0])  # [R, H, Dh], sq [R, H, 1]
            s_pre = _int_dot(group(q8), bc.pk[layer])  # [N, H, beam, P]
            s_pre = s_pre * group(sq) * bc.pks[layer][:, :, None, :] * (dh**-0.5)
            s_tail = _int_dot(q8[:, :, None], bc.k[layer])[:, :, 0]  # [R, H, NT]
            s_tail = s_tail * sq * bc.ks[layer] * (dh**-0.5) + tail_bias[:, None, :]
            p = torch.softmax(torch.cat([ungroup(s_pre), s_tail], dim=-1), dim=-1)
            pre = p[..., :p_len] * ungroup(bc.pvs[layer][:, :, None, :].expand(-1, -1, beam, -1))
            (p8_pre, p8_tail), sp = _quantize_probs(pre, p[..., p_len:] * bc.vs[layer])
            a_pre = torch.matmul(group(p8_pre), bc.pv[layer].float())  # [N, H, beam, Dh]
            a_tail = torch.matmul(p8_tail[:, :, None], bc.v[layer].float())[:, :, 0]
            attn = (ungroup(a_pre) + a_tail) * sp  # exact integer sums, then the scale
            x = block.finish(x, attn.to(x.dtype))
        return self.head(x)[:, -1], bc._replace(index=idx + 1)

    @staticmethod
    def reorder_beam_tail(bc: Int8BeamCache, global_source: torch.Tensor) -> Int8BeamCache:
        """Beam-reorder the tail slabs' rows, over the written positions only
        (the prefix slabs are per image; unwritten positions are zeros in
        every row). The gather reads into a new tensor before the write-back."""
        w = bc.index - bc.pk.shape[3]
        for slab in (bc.k, bc.v, bc.ks, bc.vs):
            slab[:, :, :, :w] = slab[:, :, :, :w].index_select(1, global_source)
        return bc


@torch.no_grad()
def quantize_params(lm: GPT2) -> GPT2Int8:
    """The int8 decode LM of a float GPT-2 (JAX gpt2.quantize_params): the
    four linears of each block quantized per output channel from their
    stored weights, their biases, wte, wpe and the LayerNorms cast to bf16,
    and lm_head quantized from wte (in f32, padded to a multiple of 8
    channels). On the LM's device."""
    bf16, state = torch.bfloat16, {}
    for name, t in lm.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        if mod.rpartition(".")[2] in INT8_LINEARS and leaf == "weight":
            wq = quantize_weight(t)
            state[f"{mod}.q"], state[f"{mod}.s"] = wq["q"], wq["s"]
        else:
            state[name] = t.to(bf16)
    head = quantize_weight(pad_channels(lm.wte.float()))
    state["lm_head.q"], state["lm_head.s"] = head["q"], head["s"]
    out = GPT2Int8(lm.cfg, device=lm.wte.device)
    out.load_state_dict(state)
    return out
