"""The ClipCap captioner: visual prefix + mapper + causal LM
(port of clipcap_tpu/models/captioner.py: init, project_prefix, forward,
caption_loss, trainable_filter).

The JAX package's params dict {"mapper", "lm", ["visual"]} becomes the
`Captioner` module with those submodules; the JAX `init` is its
constructor. forward follows reference
model.py:132-149: text-embedding lookup, mapper projection, concat
[prefix_proj ‖ text_emb], prefix-extended attention mask, LM call.
caption_loss is the training_step CE (model.py:203-209) with its quirks:
-1 padding is the mask, and ignore_index 0 also drops genuine id-0 tokens.
Prefix-only training (CLIPCaptionPrefixOnly, model.py:219-226) is a
gradient partition, not a subclass: `trainable_filter` marks which
parameters receive gradients and optimizer state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import CaptionerConfig, ViTConfig
from ..lm.registry import get_lm
from .mapper import Mapper
from .vit import ViT


class Captioner(nn.Module):
    def __init__(self, cfg: CaptionerConfig, lm_cfg, *, vit_cfg: Optional[ViTConfig] = None,
                 device="cuda", dtype=torch.float32, seed: int = 0,
                 lm: Optional[nn.Module] = None):
        """`lm`, when given, is held in place of a freshly drawn LM (a frozen
        int8 LM under prefix-only training, as JAX's params may hold one)."""
        super().__init__()
        self.cfg = cfg
        self.lm_cfg = lm_cfg
        # distinct seeds per submodule, so each draws its own stream
        self.mapper = Mapper(cfg.mapper, device=device, dtype=dtype, seed=seed)
        self.lm = lm if lm is not None else get_lm(cfg.lm_type)(lm_cfg, device=device,
                                                                dtype=dtype, seed=seed + 1)
        self.visual = (ViT(vit_cfg, device=device, dtype=dtype, seed=seed + 2)
                       if vit_cfg is not None else None)

    def project_prefix(self, prefix: torch.Tensor) -> torch.Tensor:
        """Visual features -> prefix_length LM pseudo-token embeddings, after
        the optional L2 prefix normalization (reference dataset.py:167-168)."""
        if self.cfg.normalize_prefix:
            prefix = prefix / torch.linalg.vector_norm(prefix, dim=-1, keepdim=True)
        return self.mapper(prefix.to(self.mapper.linear.weight.dtype))

    def forward(self, tokens: torch.Tensor, prefix: torch.Tensor,
                mask: Optional[torch.Tensor] = None, logits_slice=None,
                remat: bool = False, lm_apply=None) -> torch.Tensor:
        """Logits [B, P+T, V] (or the logits_slice positions of them);
        remat checkpoints the LM's blocks, as in JAX (the mapper is not).
        lm_apply overrides the LM's forward: called as lm_apply(embeds,
        attention_mask=..., logits_slice=...), e.g. GPTJInt8.apply_q8, the
        W8A16 forward of a frozen int8 LM (JAX's `lm_apply`, which bakes in
        its own remat)."""
        embedding_text = self.lm.embed_tokens(tokens)
        prefix_proj = self.project_prefix(prefix).to(embedding_text.dtype)
        embedding_cat = torch.cat([prefix_proj, embedding_text], dim=1)
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
        full_mask = torch.cat(
            [torch.ones(prefix_proj.shape[:-1], dtype=mask.dtype, device=mask.device), mask],
            dim=1)
        if lm_apply is not None:
            return lm_apply(embedding_cat, attention_mask=full_mask, logits_slice=logits_slice)
        return self.lm(embedding_cat, attention_mask=full_mask, logits_slice=logits_slice,
                       remat=remat)

    def caption_loss(self, tokens: torch.Tensor, prefix: torch.Tensor,
                     remat: bool = False, lm_apply=None) -> Tuple[torch.Tensor, dict]:
        """The training_step CE loss (reference model.py:203-209) of tokens
        [B, T] padded with -1: the mask is tokens >= 0, negative ids become
        0, and the head runs on the positions that predict the tokens only
        (prefix_length-1 .. total-1). CE is logsumexp minus the picked
        logit in f32; ignore_index is 0, so the zeroed padding and genuine
        id-0 tokens drop out alike (a reference quirk), over a denominator
        of max(valid, 1); lm_apply as in forward. Returns (loss, {"loss",
        "valid_tokens"})."""
        mask = tokens >= 0
        tokens = torch.where(mask, tokens, torch.zeros((), dtype=tokens.dtype,
                                                       device=tokens.device))
        p = self.cfg.mapper.prefix_length
        total = p + tokens.shape[1]
        logits = self(tokens, prefix, mask, logits_slice=(p - 1, total - 1), remat=remat,
                      lm_apply=lm_apply)
        logits_f = logits.float().reshape(-1, logits.shape[-1])
        labels = tokens.reshape(-1).long()
        nll = torch.logsumexp(logits_f, dim=-1) - logits_f.gather(1, labels[:, None])[:, 0]
        valid = labels != 0
        denom = valid.sum().clamp(min=1)
        loss = torch.where(valid, nll, torch.zeros((), device=nll.device)).sum() / denom
        return loss, {"loss": loss, "valid_tokens": denom}

    def trainable_filter(self) -> Dict[str, bool]:
        """{parameter name: whether it trains}. prefix_only reproduces
        CLIPCaptionPrefixOnly (reference model.py:219-226): only the mapper
        sees the optimizer; the visual encoder trains only with
        train_visual_encoder (reference model.py:45-48)."""
        train = {"mapper": True, "lm": not self.cfg.prefix_only,
                 "visual": self.cfg.train_visual_encoder}
        return {name: train[name.split(".", 1)[0]] for name, _ in self.named_parameters()}
