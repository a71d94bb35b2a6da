"""BLIP's BERT-style text model with cross-attention to image features
(port of clipcap_tpu/models/blip_text.py).

The decoder samples Gen-B captions (reference sampling.py:166-279,
:283-326); the encoder scores ITM/ITC (reference sampling.py:40-62).
Post-LN BERT blocks (LayerNorm after each residual, eps 1e-12), learned
absolute positions applied at the embedding layer with their LayerNorm,
an exact-gelu MLP, per-layer cross-attention whose K/V come from the ViT
tokens, and an MLM-style LM head. Numerics follow the JAX module op by op
(and HF's BlipTextLMHeadModel in f32): attention logits in f32, scaled
after the q·k product, the softmax cast to v's dtype. Linear weights are
nn.Linear's [out, in] (convert.py transposes the JAX package's [in, out]);
every linear goes through ops/quant.linear, so the int8 module
(`quantize_params`) is this module with its linears swapped for
Int8Linear.

KV-cached generation: `decoder_lm(text, image_feats, repeat=)` closes over
one batch of image features and gives the engine's token-id LM protocol
(`takes_token_ids`: BERT owns positions and LayerNorm inside its embedding
layer, so the engine feeds ids, not embeddings). The cross-attention K/V
are computed once per image when the adapter is made, not once per step.
With repeat > 1 each image serves `repeat` consecutive decode rows (Gen-B's
candidates): the rows share one image's cross K/V by a reshape of the query
axis, so the K/V are stored and read once per image, never repeated.
Self-attention in a cached step scores the positions written so far; JAX
scores the whole cache width under a causal mask, where the masked keys
weigh exactly 0. Attention is plain torch, as it is plain XLA in JAX: no
kernel runs here.

Continuous batching: `serving_decoder_lm(text, prompt_ids, num_image_tokens)`
gives decode/serving.py's ring protocol. Each request's prefix is its image
features, which its prefill turns into cross K/V rows; the fixed decoder
prompt occupies the self-attention ring. A ring step writes one slab at the
global index and attends the whole ring width under ops/ring.ring_layout's
[B, T] window bias, each row at its own position (JAX's
`_forward_cached(..., ring=(pos, start))`).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import BlipTextConfig
from ..ops import quant
from ..ops.activations import gelu_exact
from ..ops.attention import causal_bias, padding_bias
from ..ops.layernorm import LayerNorm
from ..ops.ring import paste_rows, refill_positions, ring_layout
from .common import gather_rows, linear, make_generator, normal


def attend(h_q: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           attn: "BlipAttention", bias: Optional[torch.Tensor], repeat: int = 1) -> torch.Tensor:
    """JAX's `_finish_attention(_grouped)`: attention, the output linear,
    the residual and the post-LN. q [B, Tq, H, Dh]; k, v [B / repeat, Tk,
    H, Dh]: `repeat` consecutive query rows share one K/V row (rows are
    image-major, the repeat_interleave layout), folded into the query axis
    by a reshape, so the K/V are read once per image."""
    b, tq, heads, dh = q.shape
    qg = q.reshape(b // repeat, repeat * tq, heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qg.float(), k.float()) * dh**-0.5
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, tq, heads * dh)
    out = quant.linear(out, attn.wo.weight, attn.wo.bias)
    return attn.ln(h_q + out)


class BlipAttention(nn.Module):
    """A BERT attention sublayer: q/k/v/o linears (K/V from `kv_width`
    inputs) and the LayerNorm after the residual."""

    def __init__(self, cfg: BlipTextConfig, kv_width: int, gen, device, dtype):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(bias=True, gen=gen, device=device, dtype=dtype, std=0.02)
        self.heads = cfg.num_heads
        self.wq, self.wk = linear(d, d, **kw), linear(kv_width, d, **kw)
        self.wv, self.wo = linear(kv_width, d, **kw), linear(d, d, **kw)
        self.ln = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)

    def project(self, lin: nn.Module, h: torch.Tensor) -> torch.Tensor:
        b, t, _ = h.shape
        y = quant.linear(h, lin.weight, lin.bias)
        return y.reshape(b, t, self.heads, y.shape[-1] // self.heads)

    def forward(self, h_q: torch.Tensor, kv: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        q, k, v = self.project(self.wq, h_q), self.project(self.wk, kv), self.project(self.wv, kv)
        return attend(h_q, q, k, v, self, bias)


class BlipMLP(nn.Module):
    def __init__(self, cfg: BlipTextConfig, gen, device, dtype):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias=True, gen=gen, device=device, dtype=dtype, std=0.02)
        self.fc1, self.fc2 = linear(d, f, **kw), linear(f, d, **kw)
        self.ln = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu_exact(quant.linear(x, self.fc1.weight, self.fc1.bias))
        return self.ln(x + quant.linear(h, self.fc2.weight, self.fc2.bias))


class BlipLayer(nn.Module):
    def __init__(self, cfg: BlipTextConfig, gen, device, dtype):
        super().__init__()
        self.self_attn = BlipAttention(cfg, cfg.hidden_size, gen, device, dtype)
        self.cross_attn = BlipAttention(cfg, cfg.encoder_width, gen, device, dtype)
        self.mlp = BlipMLP(cfg, gen, device, dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, maxT, H, Dh] self-attention keys
    v: torch.Tensor
    cross_k: torch.Tensor  # [L, B / repeat, Tv, H, Dh], from the image tokens once
    cross_v: torch.Tensor
    cross_bias: Optional[torch.Tensor]  # [B / repeat, 1, 1, Tv] or None
    index: int  # number of valid self-attention positions


class BlipText(nn.Module):
    """The BLIP text model with the JAX package's init: N(0, 0.02) weights
    and embeddings, zero biases, unit LayerNorms. `lm_head=False` leaves
    out the MLM head (the retrieval model's text encoder has none)."""

    def __init__(self, cfg: BlipTextConfig, *, lm_head: bool = True, device="cuda",
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(seed, device)
        d, eps = cfg.hidden_size, cfg.layer_norm_epsilon
        self.blocks = nn.ModuleList(BlipLayer(cfg, gen, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.word_embeddings = normal((cfg.vocab_size, d), 0.02, gen, device, dtype)
        self.position_embeddings = normal((cfg.max_position_embeddings, d), 0.02, gen, device,
                                          dtype)
        self.emb_ln = LayerNorm(d, eps, device=device, dtype=dtype)
        self.has_lm_head = lm_head
        if lm_head:
            kw = dict(bias=True, gen=gen, device=device, dtype=dtype, std=0.02)
            self.cls_transform = linear(d, d, **kw)
            self.cls_ln = LayerNorm(d, eps, device=device, dtype=dtype)
            self.cls_decoder = linear(d, cfg.vocab_size, **kw)

    def embeddings(self, tokens: torch.Tensor, position_offset=0) -> torch.Tensor:
        """Word plus position embeddings, then the embedding LayerNorm.
        position_offset: an int, or a [B] tensor of per-row positions (ring
        decode: every serving slot sits at its own logical position)."""
        t = tokens.shape[1]
        steps = torch.arange(t, device=tokens.device)
        if torch.is_tensor(position_offset) and position_offset.dim() == 1:
            pos_emb = self.position_embeddings[position_offset[:, None] + steps[None]]
        else:
            pos_emb = self.position_embeddings[position_offset + steps][None]
        return self.emb_ln(gather_rows(self.word_embeddings, tokens) + pos_emb)

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The MLM head: dense -> gelu -> LayerNorm -> decoder (an int8
        decoder's zero channels past the vocabulary sliced off)."""
        h = gelu_exact(quant.linear(hidden, self.cls_transform.weight, self.cls_transform.bias))
        h = self.cls_ln(h)
        return quant.linear(h, self.cls_decoder.weight,
                            self.cls_decoder.bias)[..., : self.cfg.vocab_size]

    def forward(self, tokens: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None, causal: bool = False,
                with_lm_head: bool = False) -> torch.Tensor:
        """JAX's `apply`: [B, T] ids -> hidden states [B, T, D] (logits with
        with_lm_head). encoder_hidden_states None: text only (ITC);
        causal: decoder mode (teacher forcing)."""
        t = tokens.shape[1]
        dev = tokens.device
        x = self.embeddings(tokens)
        # JAX adds the two masks: a key both mask out gets -inf
        bias = torch.zeros((1, 1, t, t), dtype=torch.float32, device=dev)
        if causal:
            bias = bias + causal_bias(t, t, device=dev)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        cross_bias = (None if encoder_attention_mask is None
                      else padding_bias(encoder_attention_mask))
        for blk in self.blocks:
            x = blk.self_attn(x, x, bias)
            if encoder_hidden_states is not None:
                x = blk.cross_attn(x, encoder_hidden_states, cross_bias)
            x = blk.mlp(x)
        return self.lm_logits(x) if with_lm_head else x

    # --- KV-cached decoding (the Gen-B sampler's hot path) ---------------------------------

    def precompute_cross(self, encoder_hidden_states: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every layer's cross-attention K and V of the image tokens, each
        [L, B, Tv, H, Dh] (JAX's `_precompute_cross`)."""
        ks, vs = [], []
        for blk in self.blocks:
            ca = blk.cross_attn
            ks.append(ca.project(ca.wk, encoder_hidden_states))
            vs.append(ca.project(ca.wv, encoder_hidden_states))
        return torch.stack(ks), torch.stack(vs)

    def forward_cached(self, tokens: torch.Tensor, cache: KVCache, cross_repeat: int = 1,
                       full_logits: bool = False, ring=None) -> Tuple[torch.Tensor, KVCache]:
        """JAX's `_forward_cached`: t positions after the cache's index,
        written into the cache IN PLACE. Logits [B, t, V] with
        full_logits, else [B, 1, V] of the last position.

        ring=(pos [B], start [B]): a continuous-batching step (t == 1,
        no grouped rows). cache.index is the global step counter, the slab
        lands at index % T, row b embeds position pos[b] and attends the
        whole ring under the window bias of ops/ring.ring_layout."""
        t = tokens.shape[1]
        idx, a_len = cache.index, cache.k.shape[2]
        if ring is not None:
            if t != 1:
                raise ValueError("ring mode is decode-only (t == 1)")
            if cross_repeat != 1:
                raise ValueError("grouped cross-attention (repeat > 1) is a Gen-B candidate "
                                 "layout, not a serving one")
            pos, start = ring
            wslot, ring_bias = ring_layout(idx, a_len, start)
            bias = ring_bias[:, None, None, :]  # [B, 1, 1, T]
            x = self.embeddings(tokens, position_offset=pos)
            end = a_len
        else:
            wslot, end = idx, idx + t
            if end > a_len:
                raise ValueError(f"cache of {a_len} positions cannot take {end}")
            x = self.embeddings(tokens, position_offset=idx)
            bias = causal_bias(t, end, device=tokens.device)
        for layer, blk in enumerate(self.blocks):
            sa, ca = blk.self_attn, blk.cross_attn
            q = sa.project(sa.wq, x)
            cache.k[layer, :, wslot:wslot + t] = sa.project(sa.wk, x).to(cache.k.dtype)
            cache.v[layer, :, wslot:wslot + t] = sa.project(sa.wv, x).to(cache.v.dtype)
            x = attend(x, q, cache.k[layer, :, :end], cache.v[layer, :, :end], sa, bias)
            x = attend(x, ca.project(ca.wq, x), cache.cross_k[layer], cache.cross_v[layer], ca,
                       cache.cross_bias, cross_repeat)
            x = blk.mlp(x)
        if not full_logits:
            x = x[:, -1:]
        return self.lm_logits(x), cache._replace(index=idx + t)


class BlipDecoderLM:
    """JAX's `decoder_lm`: the engine's LM protocol over one BLIP text
    decoder and one batch of (unrepeated) image features [B_img, Tv, W],
    taking token ids. The cross K/V are computed here once; the decode
    batch must be B_img * repeat rows, image-major."""

    takes_token_ids = True
    chunked_forward = False  # a speculative chunk would verify token by token

    def __init__(self, text: BlipText, encoder_hidden_states: torch.Tensor,
                 encoder_attention_mask: Optional[torch.Tensor] = None, repeat: int = 1):
        self.text, self.cfg, self.repeat = text, text.cfg, int(repeat)
        self.images = encoder_hidden_states.shape[0]
        self.dtype = encoder_hidden_states.dtype
        with torch.no_grad():
            self.cross_k, self.cross_v = text.precompute_cross(encoder_hidden_states)
        self.cross_bias = (None if encoder_attention_mask is None
                           else padding_bias(encoder_attention_mask))

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        if batch != self.images * self.repeat:
            raise ValueError(f"decode batch {batch} != images {self.images} x repeat "
                             f"{self.repeat}")
        # the activations follow the image features' dtype, as in JAX
        dtype = self.dtype if dtype is None else dtype
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
        dev = self.cross_k.device
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev),
                       cross_k=self.cross_k.to(dtype), cross_v=self.cross_v.to(dtype),
                       cross_bias=self.cross_bias, index=0)

    @torch.no_grad()
    def prefill(self, token_ids: torch.Tensor, cache: KVCache,
                full_logits: bool = False) -> Tuple[torch.Tensor, KVCache]:
        return self.text.forward_cached(token_ids, cache, self.repeat, full_logits)

    @torch.no_grad()
    def decode_step(self, token_ids: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        logits, cache = self.text.forward_cached(token_ids, cache, self.repeat)
        return logits[:, -1], cache


def decoder_lm(text: BlipText, encoder_hidden_states: torch.Tensor,
               encoder_attention_mask: Optional[torch.Tensor] = None,
               repeat: int = 1) -> BlipDecoderLM:
    """The decoder's engine adapter (JAX `blip_text.decoder_lm`)."""
    return BlipDecoderLM(text, encoder_hidden_states, encoder_attention_mask, repeat)


class BlipServingLM:
    """JAX's `serving_decoder_lm`: decode/serving.py's ring protocol over one
    BLIP text decoder (float or int8). A request's prefix is its image
    features [Tv, W]: prefill turns a batch of them into that batch's cross
    K/V and runs the fixed prompt through the self-attention ring, and
    scatter_refill pastes both the self-attention slabs and the cross K/V
    rows. Serve it with ServingEngine(prefix_len=num_image_tokens,
    prompt_len=len(prompt_ids)); it takes token ids."""

    takes_token_ids = True
    cache_dtype = torch.float32  # init_cache's dtype when given none, as JAX's

    def __init__(self, text: BlipText, prompt_ids, num_image_tokens: int, device="cuda"):
        dev = torch.device(device)
        weights = next(text.parameters()).device
        if weights.type != dev.type:
            raise ValueError(f"text decoder on {weights}, the adapter asked for {dev}")
        self.text, self.cfg = text, text.cfg
        self.num_image_tokens = int(num_image_tokens)
        self.prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.int64,
                                          device=weights).reshape(1, -1)

    def parameters(self):
        return self.text.parameters()

    def prefix_width(self) -> int:
        """The width of a request's prefix rows: the image encoder's."""
        return self.cfg.encoder_width

    def init_cache(self, batch: int, max_len: int, dtype=None) -> KVCache:
        dtype = self.cache_dtype if dtype is None else dtype
        cfg, dev = self.cfg, self.prompt_ids.device
        heads, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads

        def zeros(t):
            return torch.zeros((cfg.num_layers, batch, t, heads, dh), dtype=dtype, device=dev)

        return KVCache(k=zeros(max_len), v=zeros(max_len), cross_k=zeros(self.num_image_tokens),
                       cross_v=zeros(self.num_image_tokens), cross_bias=None, index=0)

    @torch.no_grad()
    def prefill(self, image_feats: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """image_feats [R, Tv, W] -> the batch's cross K/V into the cache,
        then the prompt through its self-attention; logits [R, 1, V]."""
        ck, cv = self.text.precompute_cross(image_feats)
        cache.cross_k.copy_(ck)
        cache.cross_v.copy_(cv)
        ids = self.prompt_ids.expand(image_feats.shape[0], -1)
        return self.text.forward_cached(ids, cache)

    @torch.no_grad()
    def decode_step(self, token_ids: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        logits, cache = self.text.forward_cached(token_ids, cache)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step_ring(self, token_ids: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                         start: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        logits, cache = self.text.forward_cached(token_ids, cache, ring=(pos, start))
        return logits[:, -1], cache

    @staticmethod
    def scatter_refill(cache: KVCache, small: KVCache, q: int) -> KVCache:
        """Paste a freshly prefilled R-row cache IN PLACE into the ring
        cache's row block [q, q+R): the self-attention slabs at the ring
        slots the prompt claims (GPT2.scatter_refill), the cross K/V as
        whole rows (cross-attention has no time axis of its own)."""
        rp = refill_positions(cache.index, small.k.shape[2], cache.k.shape[2], cache.k.device)
        paste_rows(cache.k, small.k, q, rp, time_axis=2)
        paste_rows(cache.v, small.v, q, rp, time_axis=2)
        rows = slice(q, q + small.cross_k.shape[1])
        cache.cross_k[:, rows] = small.cross_k.to(cache.cross_k.dtype)
        cache.cross_v[:, rows] = small.cross_v.to(cache.cross_v.dtype)
        return cache


def serving_decoder_lm(text: BlipText, prompt_ids, num_image_tokens: int,
                       device="cuda") -> BlipServingLM:
    """The decoder's continuous-batching adapter (JAX
    `blip_text.serving_decoder_lm`), on `device`: the card unless the
    caller asks for the CPU, where `text` must already lie."""
    return BlipServingLM(text, prompt_ids, num_image_tokens, device)


# --- int8 decode (port of blip_text.py:437-481) ---------------------------------------------

INT8_LINEARS = ("wq", "wk", "wv", "wo", "fc1", "fc2", "cls_transform")


@torch.no_grad()
def quantize_params(text: BlipText) -> BlipText:
    """The int8 decoder (JAX blip_text.quantize_params): a copy of `text`
    whose self- and cross-attention projections, MLP and MLM head linears
    are per-output-channel int8 (ops.quant.Int8Linear, which quant.linear
    dispatches on), the head padded to a multiple of 8 channels (zero
    weights, zero bias; `lm_logits` slices them off). Embeddings, biases
    and LayerNorms stay as they are. On the module's device."""
    out = copy.deepcopy(text)
    for mod in out.modules():
        for name, child in list(mod.named_children()):
            if name in INT8_LINEARS and isinstance(child, nn.Linear):
                setattr(mod, name, quant.Int8Linear.quantize(child.weight, child.bias))
    if text.has_lm_head:
        dec = text.cls_decoder
        bias = torch.nn.functional.pad(dec.bias.detach(), (0, -dec.bias.shape[0]
                                                          % quant.CHANNEL_ALIGN))
        out.cls_decoder = quant.Int8Linear.quantize(quant.pad_channels(dec.weight), bias)
    out.requires_grad_(False)
    return out
