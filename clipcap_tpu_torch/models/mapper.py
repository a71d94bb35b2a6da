"""The prefix mapping network, "clip_project" (port of clipcap_tpu/models/mapper.py).

TransformerMapper (pooled CLIP embedding -> clip_length pseudo-tokens via
one Linear, reference layers/Transformer.py:133-161) and
TransformerMapperAllFeatures (a per-token Linear over the full ViT token
sequence with optional learned positions, reference :164-203), selected by
MapperConfig.use_all_features. The core is pre-LN with residuals; attention
has a bias-free fused keys-values projection and a biased output
projection; the MLP takes relu/elu/gelu/selu/geglu (geglu doubles the fc1
width). The output is the transformed learned prefix constants, the slice
after the visual tokens. The JAX module's `init` is the `Mapper`
constructor and `apply` is `Mapper.forward`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import MapperConfig
from ..ops.activations import is_gated, parse_act_fn
from ..ops.attention import multi_head_attention
from ..ops.layernorm import LayerNorm
from .common import linear, make_generator, remat_call

LN_EPS = 1e-5  # torch nn.LayerNorm default, used by the reference mapper


class MapperLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, act_fn: str, gen, device,
                 dtype):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        hidden_pre = hidden * 2 if is_gated(act_fn) else hidden
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.num_heads = num_heads
        self.act = parse_act_fn(act_fn)
        self.ln1 = LayerNorm(dim, LN_EPS, device=device, dtype=dtype)
        self.wq = linear(dim, dim, bias=False, **kw)
        self.wkv = linear(dim, 2 * dim, bias=False, **kw)
        self.wo = linear(dim, dim, bias=True, **kw)
        self.ln2 = LayerNorm(dim, LN_EPS, device=device, dtype=dtype)
        self.fc1 = linear(dim, hidden_pre, bias=True, **kw)
        self.fc2 = linear(hidden, dim, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x)
        attn, _ = multi_head_attention(h, None, wq=self.wq.weight, wkv=self.wkv.weight,
                                       wo=self.wo.weight, bo=self.wo.bias,
                                       num_heads=self.num_heads)
        x = x + attn
        h = self.fc2(self.act(self.fc1(self.ln2(x))))
        return x + h


class Mapper(nn.Module):
    """Mapper with torch nn.Linear's default init (as the JAX package and
    the reference use) and randn * prefix_init_std prefix constants."""

    def __init__(self, cfg: MapperConfig, *, device="cuda", dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(seed, device)
        d = cfg.dim_embedding
        out = d if cfg.use_all_features else cfg.clip_length * d
        self.linear = linear(cfg.dim_clip, out, bias=True, gen=gen, device=device, dtype=dtype)
        self.prefix_const = nn.Parameter(
            (torch.randn(cfg.prefix_length, d, generator=gen, device=device)
             * cfg.prefix_init_std).to(dtype))
        self.pos_embeddings = None
        if cfg.use_all_features and cfg.use_pos_embeddings:
            self.pos_embeddings = nn.Parameter(
                torch.randn(cfg.clip_length, d, generator=gen, device=device).to(dtype))
        self.layers = nn.ModuleList(
            MapperLayer(d, cfg.num_heads, cfg.mlp_ratio, cfg.act_fn, gen, device, dtype)
            for _ in range(cfg.num_layers))

    def forward(self, prefix: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """prefix [B, dim_clip] (pooled) or [B, clip_length, dim_clip]
        (all features) -> [B, prefix_length, dim_embedding]; remat
        checkpoints each layer (JAX's transformer_apply(remat=True))."""
        x, visual_len = self.sequence(prefix)
        for layer in self.layers:
            x = remat_call(layer, x) if remat else layer(x)
        return x[:, visual_len:]

    def sequence(self, prefix: torch.Tensor):
        """The layers' input, [projected prefix ‖ prefix constants], and the
        projected part's length."""
        cfg = self.cfg
        if cfg.use_all_features:
            if prefix.dim() != 3:
                raise ValueError(
                    f"all-features mapper expects [B, T, dim_clip], got {tuple(prefix.shape)}")
            x = self.linear(prefix)
            if self.pos_embeddings is not None:
                x = x + self.pos_embeddings[None, : x.shape[1]]
            visual_len = x.shape[1]
        else:
            if prefix.dim() != 2:
                raise ValueError(f"pooled mapper expects [B, dim_clip], got {tuple(prefix.shape)}")
            x = self.linear(prefix).reshape(prefix.shape[0], cfg.clip_length, cfg.dim_embedding)
            visual_len = cfg.clip_length
        const = self.prefix_const.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([x, const], dim=1), visual_len

