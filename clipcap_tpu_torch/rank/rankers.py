"""Caption rankers (port of CLIPRanker, clipcap_tpu/rank/rankers.py).

clip_rank (reference sampling.py:23-37): CLIP-encode the image once,
encode every candidate caption in one batched text-tower forward, and
take the cosine similarity. The image tower is the port's CLIP ViT; the
ResNet tower and BLIPRanker come with the Gen B slice (ROADMAP.md item 11).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def cos_sim(a: torch.Tensor, b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    if normalize:
        a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return a @ b.T


class CLIPRanker:
    """clip_rank over one image and a caption list: a CLIP ViT
    (`models.vit.ViT`) and text tower (`models.clip_text.CLIPText`) on one
    device, and the CLIP tokenizer."""

    def __init__(self, visual, text, tokenizer):
        self.visual, self.vit_cfg = visual, visual.cfg
        self.text, self.text_cfg = text, text.cfg
        self.tokenizer = tokenizer
        self.device = next(visual.parameters()).device

    @torch.no_grad()
    def image_features(self, pixels) -> torch.Tensor:
        return self.visual(torch.as_tensor(pixels).to(self.device), output="pooled")

    @torch.no_grad()
    def text_features(self, captions: Sequence[str]) -> torch.Tensor:
        toks = torch.from_numpy(self.tokenizer.tokenize(list(captions), truncate=True))
        return self.text(toks.to(self.device))

    def rank(self, pixels, captions: Sequence[str]) -> List[float]:
        """pixels [1, 3, H, W] -> the cosine similarity of each caption."""
        sims = cos_sim(self.text_features(captions), self.image_features(pixels))[:, 0]
        return [float(s) for s in sims.cpu().tolist()]
