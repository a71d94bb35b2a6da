"""T5 / T0 encoder-decoder with a decoder KV cache (port of
clipcap_tpu/models/t5.py).

The reference's T0 wrapper (lms/T0.py:6-20) feeds the projected prefix
embeddings to BOTH the encoder and the decoder; `T5.forward` keeps that
contract. The cached path encodes the prompt once (`prefill`), runs it as
the decoder's prefix, and then extends the decoder alone, with its
self-attention K/V cached.

Numerics follow HF T5ForConditionalGeneration in f32, op by op as the JAX
module computes them: unscaled attention (T5 folds the scale into its
init) whose logits go to f32 before the bias is added, with the softmax in
f32 cast to v's dtype; a relative-position bias from layer 0's table only,
shared by every layer of a stack (buckets from an f32 log, truncated to
int32); RMSNorm that casts the normalised value before the gain; a relu
or gated-gelu MLP; and the d_model**-0.5 rescale of the logits when the
embeddings are tied (the factor rounded to the activations' dtype first,
as JAX's weakly typed constant is). Linear weights are nn.Linear's
[out, in] (convert.py transposes the JAX package's [in, out]).

Cross-attention recomputes its K/V from the cached encoder output at every
step, as JAX's does. Attention is plain torch ops, as it is plain XLA in
JAX: no kernel runs here. T5 has no multi-token continuation of a cache
(no `chunked_forward` attribute), as JAX's module has no
`_forward_cached`: a speculative chunk verifies token by token.

`T5Int8` (below, with `quantize_params`) is the int8 decode module: the
same computation with every attention and MLP linear, and the untied
lm_head, in int8 through ops/quant, as JAX runs its T5 over quantized
leaves. The embedding table, the relative-bias tables and the norms stay
dense in the float model's dtype, and the cache stays float.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import T5Config
from ..ops.activations import gelu_new
from ..ops.attention import causal_bias, padding_bias
from ..ops.layernorm import rms_norm
from ..ops.quant import Int8Linear, quantize_weight
from ..ops.ring import paste_rows, paste_rows_axis0, refill_positions, ring_layout, ring_timesteps
from .common import gather_rows, linear, make_generator, normal, remat_call


def relative_position_bucket(rel_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5Attention._relative_position_bucket as JAX computes it: the
    log-spaced buckets from an f32 log, truncated to int32. Every divisor
    is an f32 tensor (CUDA turns a division by a Python scalar into a
    multiplication by its reciprocal)."""
    dev = rel_pos.device
    ret = torch.zeros_like(rel_pos)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel_pos > 0).to(rel_pos.dtype) * num_buckets
        rel_pos = rel_pos.abs()
    else:
        rel_pos = -torch.clamp(rel_pos, max=0)
    max_exact = num_buckets // 2
    is_small = rel_pos < max_exact
    f32 = dict(dtype=torch.float32, device=dev)
    # log(0) guarded for the small distances, which the where below discards
    safe = torch.clamp(rel_pos, min=1).float()
    large = max_exact + (torch.log(safe / torch.tensor(float(max_exact), **f32))
                         / torch.log(torch.tensor(max_distance / max_exact, **f32))
                         * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(is_small, rel_pos, large.to(rel_pos.dtype))


def position_bias(table: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor,
                  bidirectional: bool, cfg: T5Config) -> torch.Tensor:
    """table [num_buckets, H]; qpos [Tq], kpos [Tk] -> bias [1, H, Tq, Tk]
    in the table's dtype."""
    buckets = relative_position_bucket(kpos[None, :] - qpos[:, None], bidirectional,
                                       cfg.relative_attention_num_buckets,
                                       cfg.relative_attention_max_distance)
    return table[buckets].permute(2, 0, 1)[None]


def _attend(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Unscaled T5 attention: f32 logits plus the f32 bias, the softmax
    weights cast to v's dtype. q [B, Tq, H, Dkv], keys/vals [B, Tk, H, Dkv]
    -> [B, Tq, H*Dkv] in v's dtype."""
    b, t, h, dkv = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float())
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1).to(vals.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vals).reshape(b, t, h * dkv)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, device, dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class T5Attention(nn.Module):
    """q/k/v/o projections without biases; `make(fan_in, fan_out, std)`
    builds each linear (a float nn.Linear, or an empty Int8Linear)."""

    def __init__(self, cfg: T5Config, make):
        super().__init__()
        d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
        self.n_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.wq = make(d, inner, (d * inner) ** -0.25)
        self.wk = make(d, inner, d**-0.5)
        self.wv = make(d, inner, d**-0.5)
        self.wo = make(inner, d, inner**-0.5)

    def heads(self, lin: nn.Module, h: torch.Tensor) -> torch.Tensor:
        b, t, _ = h.shape
        return lin(h).reshape(b, t, self.n_heads, self.d_kv)

    def forward(self, h_q: torch.Tensor, h_kv: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        q, k, v = self.heads(self.wq, h_q), self.heads(self.wk, h_kv), self.heads(self.wv, h_kv)
        return self.wo(_attend(q, k, v, bias))


class T5MLP(nn.Module):
    """relu(x wi_0) wo, or gelu_new(x wi_0) * (x wi_1) wo for gated-gelu,
    each op rounded to the activations' dtype. Compiled JAX keeps a bf16
    model's gated chain in f32 up to the int8 `wo`'s quantization, with
    XLA's own f32 tanh, which no torch op reproduces bit for bit; the port
    rounds as JAX's eager ops do (its int8 MLP equals eager JAX's)."""

    def __init__(self, cfg: T5Config, make):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        self.wi_0 = make(d, f, d**-0.5)
        if self.gated:
            self.wi_1 = make(d, f, d**-0.5)
        self.wo = make(f, d, f**-0.5)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if not self.gated:
            return self.wo(torch.relu(self.wi_0(h)))
        return self.wo(gelu_new(self.wi_0(h)) * self.wi_1(h))


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, make, norm):
        super().__init__()
        self.ln1, self.attn = norm(), T5Attention(cfg, make)
        self.ln2, self.mlp = norm(), T5MLP(cfg, make)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x)
        x = x + self.attn(h, h, bias)
        return x + self.mlp(self.ln2(x))


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, make, norm):
        super().__init__()
        self.ln1, self.self_attn = norm(), T5Attention(cfg, make)
        self.ln2, self.cross_attn = norm(), T5Attention(cfg, make)
        self.ln3, self.mlp = norm(), T5MLP(cfg, make)

    def forward(self, x: torch.Tensor, enc_hidden: torch.Tensor, self_bias: torch.Tensor,
                cross_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The whole block without a cache (JAX's `_decode_stack` body)."""
        h = self.ln1(x)
        x = x + self.self_attn(h, h, self_bias)
        x = x + self.cross_attn(self.ln2(x), enc_hidden, cross_bias)
        return x + self.mlp(self.ln3(x))


class T5Stack(nn.Module):
    """One stack's blocks, its relative-bias table [num_buckets, H] (layer
    0's, serving every layer) and its final norm."""

    def __init__(self, block, n_layer: int, rel_bias: nn.Parameter, norm):
        super().__init__()
        self.blocks = nn.ModuleList(block() for _ in range(n_layer))
        self.rel_bias = rel_bias
        self.ln_f = norm()


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, maxT, H, Dkv] decoder self-attention keys
    v: torch.Tensor
    enc_hidden: torch.Tensor  # [B, Te, D]; init_cache's [B, 1, D] placeholder until prefill
    enc_bias: Optional[torch.Tensor]  # [B, 1, 1, Te] cross-attention mask bias, or None
    index: int


class T5(nn.Module):
    """T5 with the JAX package's init: N(0, 1) `shared`, attention weights
    N(0, (d*inner)^-1/2) for q and N(0, d^-1) / N(0, inner^-1) for k, v / o,
    MLP weights N(0, fan_in^-1), relative-bias tables N(0, (d/H)^-1), unit
    norms, an N(0, d^-1) lm_head when the embeddings are untied.

    The cache protocol of lm/registry, with the cross-attention state in
    the cache: `init_cache` allocates the decoder's self-attention K/V and
    a placeholder encoder output, `prefill` encodes the prompt once and
    writes the decoder's K/V IN PLACE, and the decode steps extend the
    decoder alone."""

    def __init__(self, cfg: T5Config, *, device="cuda", dtype=torch.float32, seed: int = 0):
        super().__init__()
        gen = make_generator(seed, device)

        def make(fan_in, fan_out, std):
            return linear(fan_in, fan_out, bias=False, gen=gen, device=device, dtype=dtype,
                          std=std)

        self._build(cfg, make, lambda shape, std: normal(shape, std, gen, device, dtype),
                    device, dtype)

    def _build(self, cfg: T5Config, make, draw, device, dtype):
        self.cfg = cfg
        d = cfg.d_model

        def norm():
            return RMSNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)

        bias_std = (d // cfg.num_heads) ** -0.5
        table = (cfg.relative_attention_num_buckets, cfg.num_heads)
        self.shared = draw((cfg.vocab_size, d), 1.0)
        self.encoder = T5Stack(lambda: T5EncoderBlock(cfg, make, norm),
                               cfg.num_layers, draw(table, bias_std), norm)
        self.decoder = T5Stack(lambda: T5DecoderBlock(cfg, make, norm),
                               cfg.num_decoder_layers, draw(table, bias_std), norm)
        self.lm_head = None if cfg.tie_word_embeddings else make(d, cfg.vocab_size, d**-0.5)

    # --- the lm/registry protocol -------------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.shared, tokens)

    def embedding_size(self) -> int:
        return self.shared.shape[1]

    def _lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.lm_head is not None:
            return self.lm_head(x)
        # JAX multiplies by a weakly typed constant, rounded to x's dtype first
        scale = torch.tensor(self.cfg.d_model**-0.5, dtype=x.dtype, device=x.device)
        return torch.nn.functional.linear(x * scale, self.shared)

    def _encode(self, embeds: torch.Tensor, attention_mask: Optional[torch.Tensor],
                remat: bool = False) -> torch.Tensor:
        t = embeds.shape[1]
        pos = torch.arange(t, device=embeds.device)
        bias = position_bias(self.encoder.rel_bias, pos, pos, True, self.cfg)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        x = embeds
        for block in self.encoder.blocks:
            x = remat_call(block, x, bias) if remat else block(x, bias)
        return self.encoder.ln_f(x)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # [B, T, D]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1 = attend
        decoder_inputs_embeds: Optional[torch.Tensor] = None,
        logits_slice: Optional[Tuple[int, int]] = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """Full forward -> logits [B, T, V] (JAX's `apply`, the reference T0
        `call`): the same embeds go to the encoder and the decoder unless
        `decoder_inputs_embeds` is given; the mask masks the encoder's keys
        in both attentions that read them, not the decoder's own. remat
        checkpoints the blocks (JAX's T5 takes the flag and ignores it: the
        values are the same either way)."""
        if decoder_inputs_embeds is None:
            decoder_inputs_embeds = inputs_embeds
        enc_hidden = self._encode(inputs_embeds, attention_mask, remat)
        t = decoder_inputs_embeds.shape[1]
        dev = decoder_inputs_embeds.device
        pos = torch.arange(t, device=dev)
        self_bias = (position_bias(self.decoder.rel_bias, pos, pos, False, self.cfg)
                     + causal_bias(t, t, device=dev))
        cross_bias = None if attention_mask is None else padding_bias(attention_mask)
        x = decoder_inputs_embeds
        for block in self.decoder.blocks:
            args = (x, enc_hidden, self_bias, cross_bias)
            x = remat_call(block, *args) if remat else block(*args)
        x = self.decoder.ln_f(x)
        if logits_slice is not None:
            x = x[:, logits_slice[0]: logits_slice[1]]
        return self._lm_logits(x)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        """A fresh cache, index 0: zeros [L, batch, max_len, H, Dkv] and the
        [batch, 1, D] encoder-output placeholder that prefill replaces."""
        cfg = self.cfg
        shape = (cfg.num_decoder_layers, batch, max_len, cfg.num_heads, cfg.d_kv)
        kw = dict(dtype=dtype or self.shared.dtype, device=self.shared.device)
        return KVCache(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw),
                       enc_hidden=torch.zeros((batch, 1, cfg.d_model), **kw), enc_bias=None,
                       index=0)

    def _decoder_cached(self, embeds: torch.Tensor, cache: KVCache, full_logits: bool,
                        ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, KVCache]:
        """t decoder positions after the cache's index, or one ring step. The
        self-attention bias is the relative-position bias of each query
        against the keys written so far (JAX scores the whole cache width
        under a causal mask; the masked keys weigh exactly 0 there)."""
        _, t, _ = embeds.shape
        idx, a_len = cache.index, cache.k.shape[2]
        cfg, dev = self.cfg, embeds.device
        table = self.decoder.rel_bias
        if ring is not None:
            if t != 1:
                raise ValueError("ring mode is decode-only (t == 1)")
            pos, start = ring
            wslot, window = ring_layout(idx, a_len, start)  # window [B, maxT]
            # ring position p holds the key of the row's logical position
            # gp[p] - start[b]; the query sits at pos[b]. Out-of-window
            # positions get meaningless distances, and the window masks them.
            rel = (ring_timesteps(idx, a_len, dev)[None, :] - start[:, None]) - pos[:, None]
            buckets = relative_position_bucket(rel, False, cfg.relative_attention_num_buckets,
                                               cfg.relative_attention_max_distance)
            self_bias = table[buckets].permute(0, 2, 1)[:, :, None, :] + window[:, None, None, :]
            end = a_len
        else:
            if idx + t > a_len:
                raise ValueError(f"cache of {a_len} positions cannot take {idx + t}")
            wslot, end = idx, idx + t
            qpos = torch.arange(idx, end, device=dev)
            self_bias = (position_bias(table, qpos, torch.arange(end, device=dev), False, cfg)
                         + causal_bias(t, end, device=dev))
        x = embeds
        for layer, block in enumerate(self.decoder.blocks):
            sa = block.self_attn
            h = block.ln1(x)
            q = sa.heads(sa.wq, h)
            cache.k[layer, :, wslot: wslot + t] = sa.heads(sa.wk, h).to(cache.k.dtype)
            cache.v[layer, :, wslot: wslot + t] = sa.heads(sa.wv, h).to(cache.v.dtype)
            x = x + sa.wo(_attend(q, cache.k[layer, :, :end], cache.v[layer, :, :end], self_bias))
            x = x + block.cross_attn(block.ln2(x), cache.enc_hidden, cache.enc_bias)
            x = x + block.mlp(block.ln3(x))
        x = self.decoder.ln_f(x)
        if not full_logits:
            x = x[:, -1:]
        return self._lm_logits(x), cache._replace(index=idx + t)

    def prefill(self, inputs_embeds: torch.Tensor, cache: KVCache,
                attention_mask: Optional[torch.Tensor] = None,
                full_logits: bool = False) -> Tuple[torch.Tensor, KVCache]:
        """Encode the prompt once and run it as the decoder's prefix (the
        reference's both-sides contract) into a FRESH cache (index 0):
        logits [B, 1, V] (every position with full_logits) and the cache,
        which now holds the encoder output and its mask bias."""
        if cache.index != 0:
            raise ValueError("prefill needs a fresh cache (index 0)")
        enc_hidden = self._encode(inputs_embeds, attention_mask)
        enc_bias = None if attention_mask is None else padding_bias(attention_mask)
        cache = cache._replace(enc_hidden=enc_hidden, enc_bias=enc_bias)
        return self._decoder_cached(inputs_embeds, cache, full_logits)

    def decode_step(self, token_embed: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        logits, cache = self._decoder_cached(token_embed, cache, full_logits=False)
        return logits[:, -1], cache

    def decode_step_ring(self, token_embed: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                         start: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """Ring-cache decode step for continuous batching (GPT2's contract):
        the relative-position bias per row, from the ring's timesteps."""
        logits, cache = self._decoder_cached(token_embed, cache, full_logits=False,
                                             ring=(pos, start))
        return logits[:, -1], cache

    @staticmethod
    def scatter_refill(cache: KVCache, small: KVCache, q: int) -> KVCache:
        """A freshly prefilled R-row cache written IN PLACE into the ring rows
        [q, q+R): the self-attention K/V at the window's ring slots, and each
        request's encoder output by a row paste (cross-attention reads
        enc_hidden[b] directly; nothing of it rides the ring). Serving
        prefixes carry no mask, so an enc_bias is refused."""
        if cache.enc_bias is not None or small.enc_bias is not None:
            raise ValueError("serving refill does not support enc_bias (masked encoder prompts)")
        rp = refill_positions(cache.index, small.k.shape[2], cache.k.shape[2], cache.k.device)
        paste_rows(cache.k, small.k, q, rp, time_axis=2)
        paste_rows(cache.v, small.v, q, rp, time_axis=2)
        paste_rows_axis0(cache.enc_hidden, small.enc_hidden, q)
        return cache


# --- int8 decode (port of t5.py:411-458) ----------------------------------------------

INT8_LINEARS = ("wq", "wk", "wv", "wo", "wi_0", "wi_1", "lm_head")


class T5Int8(T5):
    """The int8 decode LM (JAX's t5 module over `quantize_params` output):
    every attention and MLP linear of both stacks, and the untied lm_head,
    an Int8Linear; `shared`, the relative-bias tables and the norms in
    `dtype` (the float model's); the cache float, in that dtype. An int8
    linear returns its input's dtype, so a bf16 model's logits are bf16,
    as in JAX. T0's vocabulary (32128) is a multiple of 8, so
    no lm_head channel is padded. Build it with `quantize_params(t5)`, or
    allocate it and fill it with convert.load(T5Int8(cfg, dtype=...),
    convert.t5_state_dict(jax_int8_tree))."""

    def __init__(self, cfg: T5Config, *, device="cuda", dtype=torch.bfloat16):
        nn.Module.__init__(self)  # not T5's: it would draw float weights

        def make(fan_in, fan_out, std):
            return Int8Linear.empty(fan_in, fan_out, device=device)

        def draw(shape, std):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))

        self._build(cfg, make, draw, device, dtype)
        self.requires_grad_(False)


@torch.no_grad()
def quantize_params(lm: T5) -> T5Int8:
    """The int8 decode LM of a float T5 (JAX t5.quantize_params): the
    attention and MLP linears of both stacks and the untied lm_head
    quantized per output channel from their stored weights; `shared`, the
    relative-bias tables and the norms kept as they are. With tied
    embeddings the head stays the dense `shared` table. On the LM's device."""
    state = {}
    for name, t in lm.state_dict().items():
        mod, _, leaf = name.rpartition(".")
        if leaf == "weight" and mod.rpartition(".")[2] in INT8_LINEARS:
            wq = quantize_weight(t)
            state[f"{mod}.q"], state[f"{mod}.s"] = wq["q"], wq["s"]
        else:
            state[name] = t
    out = T5Int8(lm.cfg, device=lm.shared.device, dtype=lm.shared.dtype)
    out.load_state_dict(state)
    return out
