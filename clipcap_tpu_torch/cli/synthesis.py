"""The caption-synthesis engine of the Gen-B apps (port of
clipcap_tpu/cli/synthesis.py).

The reference repeats this block in caption_me.py:100-126,
blip_coco_val_sample_sweep.py:45-88, multi_filter.py:145-191 and
prepare_human_eval*.py: BLIP-sample ~40 candidates over a heterogeneous
hyperparameter grid, then rank them by a mode. Here:

- default_grids(): the 40-slot top_p/min_len/max_len grids
  (reference prepare_human_eval.py:149-161);
- SynthesisEngine: the BLIP captioner ({"visual": ViT, "text": BlipText}),
  the WordPiece tokenizer and the rankers; synthesize() returns the
  candidates, rank() applies a mode (CLIP-ViT-L+RN50x64 | CLIP-ViT-L |
  CLIP-RN50x64 | ITM | ITC, reference caption_me.py:56-74);
- build_engine(): the engine of the sweep and human-eval CLIs from their
  parsed arguments.

The reference puts the sampler and the rankers on two GPUs (deviceA and
deviceB, caption_me.py:49-50); here they run one after the other on one
device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decode import hetero
from ..rank.cascade import two_stage_rank
from ..rank.rankers import BLIPRanker, CLIPRanker


def default_grids(set_top_p=None, set_min_len=None, set_max_len=None, n: int = 40):
    """The 40-candidate hyperparameter grid (prepare_human_eval.py:149-161),
    tiled or trimmed to any n."""

    def fit(values):
        reps = -(-n // len(values))
        return np.tile(np.asarray(values), reps)[:n]

    top_p = (np.full(n, set_top_p, np.float32) if set_top_p is not None
             else fit([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]).astype(np.float32))
    min_len = (np.full(n, set_min_len, np.int32) if set_min_len is not None
               else fit([5] * 8 + [10] * 8 + [15] * 8 + [20] * 8 + [30] * 8).astype(np.int32))
    max_len = (np.full(n, set_max_len, np.int32) if set_max_len is not None
               else fit([20] * 8 + [30] * 8 + [30] * 8 + [45] * 8 + [45] * 8).astype(np.int32))
    return top_p, min_len, max_len


@dataclasses.dataclass
class SynthesisEngine:
    blip_params: dict  # {"visual": models.vit.ViT, "text": models.blip_text.BlipText}
    blip_vit_cfg: object
    blip_text_cfg: object
    tokenizer: object  # WordPiece
    clip_rankers: Dict[str, CLIPRanker] = dataclasses.field(default_factory=dict)
    blip_ranker: Optional[BLIPRanker] = None
    preprocess_for_rank: Optional[dict] = None  # {name: image -> [3, H, W]}

    @property
    def device(self) -> torch.device:
        return next(self.blip_params["visual"].parameters()).device

    def enable_int8_decode(self) -> "SynthesisEngine":
        """Quantize the BLIP text decoder for int8 synthesis
        (models/blip_text.quantize_params); the visual encoder and the
        rankers keep full precision."""
        from ..models import blip_text

        self.blip_params = dict(self.blip_params,
                                text=blip_text.quantize_params(self.blip_params["text"]))
        return self

    @torch.no_grad()
    def encode_image(self, pixels) -> torch.Tensor:
        return self.blip_params["visual"](torch.as_tensor(pixels).to(self.device),
                                          output="tokens")

    def synthesize(
        self,
        pixels,  # [1, 3, S, S] BLIP-preprocessed
        sample_count: int = 40,
        top_p=None, top_k: float = 2500, typ_p: float = 0.0,
        min_len=None, max_len=None,
        force_eos_prob: float = 0.9,
        num_runs: int = 1,
        seed: int = 0,
    ) -> Tuple[List[str], list, list]:
        if top_p is None or min_len is None or max_len is None:
            g_top_p, g_min, g_max = default_grids(n=sample_count)
            top_p = g_top_p if top_p is None else top_p
            min_len = g_min if min_len is None else min_len
            max_len = g_max if max_len is None else max_len
        return hetero.sample(
            self.encode_image(pixels), self.blip_params["text"], self.tokenizer,
            sample_count=sample_count, top_p=top_p, top_k=top_k, typ_p=typ_p,
            min_len=min_len, max_len=max_len,
            force_eos_log_prob=math.log(force_eos_prob) if force_eos_prob > 0 else 0.0,
            num_runs=num_runs, seed=seed)

    # --- ranking modes (reference caption_me.py:56-74, 114-126) ---------------

    def rank(self, image, captions: Sequence[str], mode: str,
             top_n: int = 3) -> List[Tuple[str, float]]:
        """image: a PIL image (each ranker applies its own preprocessing)."""
        if not captions:
            return []

        def clip_scorer(name):
            ranker = self.clip_rankers[name]
            px = torch.from_numpy(ranker_preprocess(self, name, image))[None]
            return lambda caps: ranker.rank(px, caps)

        def blip_scorer(m):
            px = torch.from_numpy(ranker_preprocess(self, "blip", image))[None]
            return lambda caps: self.blip_ranker.rank(px, caps, mode=m)

        if mode == "CLIP-ViT-L+RN50x64":
            return two_stage_rank(captions, clip_scorer("ViT-L/14"), clip_scorer("RN50x64"),
                                  shortlist=5, top_n=top_n)
        if mode in ("CLIP-ViT-L", "CLIP-RN50x64"):
            name = "ViT-L/14" if mode == "CLIP-ViT-L" else "RN50x64"
            scores = clip_scorer(name)(list(captions))
            order = np.argsort(scores)[::-1][:top_n]
            return [(captions[i], float(scores[i])) for i in order]
        if mode in ("ITM", "ITC"):
            if self.blip_ranker is None:
                raise RuntimeError("no BLIP ranking model loaded")
            scores = blip_scorer(mode.lower())(list(captions))
            order = np.argsort(scores)[::-1][:top_n]
            return [(captions[i], float(scores[i])) for i in order]
        raise RuntimeError(f'Unsupported mode "{mode}"')


def build_engine(args) -> SynthesisEngine:
    """The engine of the sweep and human-eval CLIs: the BLIP captioner,
    CLIP ViT-L/14 when its checkpoint is given, and the BLIP ranker over the
    captioner's modules (as in JAX, so it cannot rank by ITM or ITC), all on
    args.device."""
    from .loading import load_blip_captioner, load_clip_ranker

    blip_params, vit_cfg, text_cfg, tokenizer = load_blip_captioner(
        args.blip_checkpoint, args.blip_vocab, vit_variant=args.blip_vit_variant,
        device=args.device)
    clip_rankers = {}
    if args.clip_vit_l_checkpoint:
        clip_rankers["ViT-L/14"] = load_clip_ranker("ViT-L/14", args.clip_vit_l_checkpoint,
                                                    args.clip_merges, device=args.device)
    return SynthesisEngine(blip_params=blip_params, blip_vit_cfg=vit_cfg,
                           blip_text_cfg=text_cfg, tokenizer=tokenizer,
                           clip_rankers=clip_rankers,
                           blip_ranker=BLIPRanker(blip_params, vit_cfg, text_cfg, tokenizer))


def ranker_preprocess(engine: SynthesisEngine, name: str, image) -> np.ndarray:
    """The [3, S, S] f32 pixels of `image` for ranker `name` ("blip" or a
    CLIP ranker's name)."""
    if engine.preprocess_for_rank and name in engine.preprocess_for_rank:
        return engine.preprocess_for_rank[name](image)
    from ..data.preprocessing import blip_preprocess, clip_preprocess

    if name == "blip":
        size = engine.blip_ranker.vit_cfg.image_size if engine.blip_ranker else 384
        return blip_preprocess(image, image_size=size)
    return clip_preprocess(image, image_size=engine.clip_rankers[name].vit_cfg.image_size)
