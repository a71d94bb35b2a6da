"""Caption rankers (port of clipcap_tpu/rank/rankers.py).

- clip_rank (reference sampling.py:23-37): CLIP-encode the image once,
  encode every candidate caption in one batched text-tower forward, and
  take the cosine similarity. The image tower is a CLIP ViT or, for the
  RN50x64 re-ranking stage (reference sampling.py:436-479), CLIP's
  ModifiedResNet, told apart by its config's type.
- blip_rank (reference sampling.py:40-62): the BLIP ITM match probability
  or the ITC cosine of each caption.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def cos_sim(a: torch.Tensor, b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    if normalize:
        a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
        b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return a @ b.T


class CLIPRanker:
    """clip_rank over one image and a caption list: a CLIP image tower
    (`models.vit.ViT`, or `models.clip_resnet.ModifiedResNet`) and text
    tower (`models.clip_text.CLIPText`) on one device, and the CLIP
    tokenizer. `vit_cfg` is the image tower's config (a ResNetConfig for a
    ResNet), as in JAX."""

    def __init__(self, visual, text, tokenizer):
        from ..models.clip_resnet import ResNetConfig

        self.visual, self.vit_cfg = visual, visual.cfg
        self.text, self.text_cfg = text, text.cfg
        self.tokenizer = tokenizer
        self.device = next(visual.parameters()).device
        self._resnet = isinstance(visual.cfg, ResNetConfig)

    @torch.no_grad()
    def image_features(self, pixels) -> torch.Tensor:
        pixels = torch.as_tensor(pixels).to(self.device)
        return self.visual(pixels) if self._resnet else self.visual(pixels, output="pooled")

    @torch.no_grad()
    def text_features(self, captions: Sequence[str]) -> torch.Tensor:
        toks = torch.from_numpy(self.tokenizer.tokenize(list(captions), truncate=True))
        return self.text(toks.to(self.device))

    def rank(self, pixels, captions: Sequence[str]) -> List[float]:
        """pixels [1, 3, H, W] -> the cosine similarity of each caption."""
        sims = cos_sim(self.text_features(captions), self.image_features(pixels))[:, 0]
        return [float(s) for s in sims.cpu().tolist()]


class BLIPRanker:
    """blip_rank over one image and a caption list (mode "itm" or "itc"),
    over a mapping of modules in blip_retrieval's layout (a BlipRetrieval)
    and the WordPiece tokenizer. Each caption's first token is replaced by
    [ENC] in both modes, as JAX's ranker does."""

    def __init__(self, params, vit_cfg, text_cfg, tokenizer):
        from ..models import blip_retrieval

        self._br = blip_retrieval
        self.params = params
        self.vit_cfg, self.text_cfg = vit_cfg, text_cfg
        self.tokenizer = tokenizer
        self.device = next(params["visual"].parameters()).device

    def _prep_tokens(self, captions: Sequence[str], first_token_id: Optional[int]):
        rows = [self.tokenizer.encode(c) for c in captions]
        max_len = max(len(r) for r in rows)
        toks = np.zeros((len(rows), max_len), np.int64)
        mask = np.zeros((len(rows), max_len), np.int64)
        for i, r in enumerate(rows):
            if first_token_id is not None:
                r = [first_token_id] + r[1:]
            toks[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return torch.from_numpy(toks).to(self.device), torch.from_numpy(mask).to(self.device)

    def rank(self, pixels, captions: Sequence[str], mode: str = "itm") -> List[float]:
        img = self._br.encode_image(self.params, torch.as_tensor(pixels).to(self.device))
        img_rep = img.repeat_interleave(len(captions), dim=0)
        if mode == "itm":
            score = self._br.itm_score
        elif mode == "itc":
            score = self._br.itc_score
        else:
            raise RuntimeError(f'blip ranking mode "{mode}" not supported')
        toks, mask = self._prep_tokens(captions, self.tokenizer.enc_token_id)
        return [float(s) for s in score(self.params, toks, img_rep, mask).cpu().tolist()]
