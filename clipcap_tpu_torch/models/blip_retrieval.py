"""BLIP image-text retrieval heads, ITM and ITC (port of
clipcap_tpu/models/blip_retrieval.py).

The reference's blip_rank (reference sampling.py:40-62) over the BLIP
retrieval checkpoint (reference sampling.py:344-351):

- itm: the text encoder (BERT with cross-attention to the ViT tokens, the
  first token replaced by [ENC]) -> CLS hidden -> the 2-way itm_head; the
  match probability is softmax[..., 1] (reference sampling.py:55-57);
- itc: image CLS -> vision_proj, text-only CLS -> text_proj, both
  L2-normalized, their cosine (reference sampling.py:58-59).

`BlipRetrieval` is an nn.ModuleDict, the JAX params' layout: "visual"
(models.vit.ViT, style "blip"), "text" (models.blip_text.BlipText without
an MLM head), "vision_proj", "text_proj" and "itm_head". The functions
take any such mapping, as JAX's take a params dict: given the captioner's
{"visual", "text"} they raise KeyError where JAX's do.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ..core.config import BlipTextConfig, ViTConfig
from .blip_text import BlipText
from .common import linear, make_generator
from .vit import ViT


class BlipRetrieval(nn.ModuleDict):
    """The JAX package's init for the heads: uniform +-fan_in^-1/2 weights
    and biases (torch's default), as JAX draws them."""

    def __init__(self, vit_cfg: ViTConfig, text_cfg: BlipTextConfig, *, device="cuda",
                 dtype=torch.float32, seed: int = 0):
        gen = make_generator(seed + 2, device)
        kw = dict(bias=True, gen=gen, device=device, dtype=dtype)
        d, e = text_cfg.hidden_size, text_cfg.embed_dim
        super().__init__({
            "visual": ViT(vit_cfg, device=device, dtype=dtype, seed=seed),
            "text": BlipText(text_cfg, lm_head=False, device=device, dtype=dtype, seed=seed + 1),
            "vision_proj": linear(vit_cfg.width, e, **kw),
            "text_proj": linear(d, e, **kw),
            "itm_head": linear(d, 2, **kw)})
        self.vit_cfg, self.text_cfg = vit_cfg, text_cfg


@torch.no_grad()
def encode_image(params: Mapping, pixels: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> ViT tokens [B, Tv, D]."""
    return params["visual"](pixels, output="tokens")


@torch.no_grad()
def itm_score(params: Mapping, tokens: torch.Tensor, image_embeds: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P(match) per pair; tokens [B, T] with the first already [ENC]."""
    img_mask = torch.ones(image_embeds.shape[:-1], dtype=torch.int32, device=image_embeds.device)
    hidden = params["text"](tokens, attention_mask=attention_mask,
                            encoder_hidden_states=image_embeds, encoder_attention_mask=img_mask)
    logits = params["itm_head"](hidden[:, 0])
    return torch.softmax(logits.float(), dim=-1)[:, 1]


@torch.no_grad()
def itc_score(params: Mapping, tokens: torch.Tensor, image_embeds: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cosine of the projected image and text-only CLS features."""
    img = params["vision_proj"](image_embeds[:, 0])
    txt = params["text_proj"](params["text"](tokens, attention_mask=attention_mask)[:, 0])
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    return (img * txt).sum(dim=-1)
