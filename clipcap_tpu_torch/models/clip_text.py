"""CLIP text tower: causal transformer, eot-pooled projection (port of
clipcap_tpu/models/clip_text.py).

OpenAI CLIP semantics: token + position embeddings, pre-LN causal blocks
with QuickGELU, ln_final, then each row's feature at its eot position (the
argmax of the token ids: eot has the highest id) times text_projection.
Attention is the plain `dot_product_attention`, as in the JAX module: no
kernel runs here. The JAX module's `init` is the `CLIPText` constructor
(the same distributions, drawn from a torch generator) and `apply` is
`CLIPText.forward`; convert.clip_text_state_dict loads JAX parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import CLIPTextConfig
from ..ops import quant
from ..ops.activations import quick_gelu
from ..ops.attention import causal_bias, dot_product_attention
from ..ops.layernorm import LayerNorm
from .common import linear, make_generator, normal


class CLIPTextBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, gen, device, dtype):
        super().__init__()
        d = cfg.width
        eps = cfg.layer_norm_epsilon
        kw = dict(gen=gen, device=device, dtype=dtype, std=0.02, bias=True)
        self.heads = cfg.heads
        self.ln1 = LayerNorm(d, eps, device=device, dtype=dtype)
        self.qkv = linear(d, 3 * d, **kw)
        self.out = linear(d, d, **kw)
        self.ln2 = LayerNorm(d, eps, device=device, dtype=dtype)
        self.fc1 = linear(d, 4 * d, **kw)
        self.fc2 = linear(4 * d, d, **kw)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        qkv = quant.linear(self.ln1(x), self.qkv.weight, self.qkv.bias)
        q, k, v = (y.reshape(b, t, self.heads, d // self.heads) for y in qkv.chunk(3, dim=-1))
        attn = dot_product_attention(q, k, v, bias=bias).reshape(b, t, d)
        x = x + quant.linear(attn, self.out.weight, self.out.bias)
        h = quick_gelu(quant.linear(self.ln2(x), self.fc1.weight, self.fc1.bias))
        return x + quant.linear(h, self.fc2.weight, self.fc2.bias)


class CLIPText(nn.Module):
    """CLIP's text tower with the JAX package's init: N(0, 0.02) weights and
    token embedding, zero biases, positions N(0, 0.01), text_projection
    N(0, width^-1)."""

    def __init__(self, cfg: CLIPTextConfig, *, device="cuda", dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(seed, device)
        d = cfg.width
        self.blocks = nn.ModuleList(CLIPTextBlock(cfg, gen, device, dtype)
                                    for _ in range(cfg.layers))
        self.token_embedding = normal((cfg.vocab_size, d), 0.02, gen, device, dtype)
        self.pos = normal((cfg.context_length, d), 0.01, gen, device, dtype)
        self.ln_final = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.text_projection = normal((d, cfg.output_dim), d**-0.5, gen, device, dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] (zero-padded, eot the largest id of each row) -> [B, output_dim]."""
        tokens = tokens.long()
        b, t = tokens.shape
        x = self.token_embedding[tokens] + self.pos[None, :t]
        bias = causal_bias(t, t, device=x.device)
        for block in self.blocks:
            x = block(x, bias)
        x = self.ln_final(x)
        pooled = x[torch.arange(b, device=x.device), torch.argmax(tokens, dim=-1)]
        return pooled @ self.text_projection
