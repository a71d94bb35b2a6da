"""CLIP cosine scoring of captions against images (port of
clipcap_tpu/eval/clip_scoring.py; reference evaluate_model.py:313-352).

Preprocess and encode the image with the CLIP vision tower (the port's
ViT, whose attention runs kernel K1 on the card), tokenize and encode the
captions with the CLIP text tower, and take the cosine similarities.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..data.preprocessing import clip_preprocess


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return a @ b.T


class ClipScoring:
    """Holds a CLIP ViT (`models.vit.ViT`, CLIP style) and a CLIP text tower
    (`models.clip_text.CLIPText`) on one device, and the CLIP tokenizer."""

    def __init__(self, visual, text, tokenizer):
        self.visual, self.vit_cfg = visual, visual.cfg
        self.text, self.text_cfg = text, text.cfg
        self.tokenizer = tokenizer
        self.device = next(visual.parameters()).device

    def preprocess_image(self, image) -> np.ndarray:
        return clip_preprocess(image, image_size=self.vit_cfg.image_size)

    def tokenize(self, text: Union[str, Sequence[str]]) -> np.ndarray:
        return self.tokenizer.tokenize(text, truncate=True)

    @torch.no_grad()
    def embed_image(self, image_tensor) -> torch.Tensor:
        x = torch.as_tensor(image_tensor).to(self.device, self.visual.cls.dtype)
        if x.dim() == 3:
            x = x[None]
        return self.visual(x, output="pooled").float()

    @torch.no_grad()
    def _encode_text(self, tokens) -> torch.Tensor:
        return self.text(torch.as_tensor(tokens).to(self.device)).float()

    def embed_text(self, captions: Sequence[str]) -> torch.Tensor:
        return self._encode_text(self.tokenize(list(captions)))

    def score_tensor(self, image_tensor, caption_tokens, method="cosine_similarity"):
        if method != "cosine_similarity":
            raise ValueError(f"Invalid value for parameter method: {method}")
        return cosine_similarity(self.embed_image(image_tensor), self._encode_text(caption_tokens))

    def score_image(self, image, captions: Union[str, Sequence[str]]):
        """PIL image + caption(s) -> [1, n] cosine similarities."""
        return self.score_tensor(self.preprocess_image(image), self.tokenize(captions))
