"""Gen-B batched heterogeneous caption sampling (port of
clipcap_tpu/decode/hetero.py; the reference's sampling.py:283-326).

- the caller encodes each image once; the decoder shares each image's
  cross-attention K/V across its `sample_count` candidate rows
  (models/blip_text.decoder_lm with repeat=), where the reference
  repeat_interleaves the image features (reference :286-288);
- the prompt ("a picture of ") is tokenized once, its first token replaced
  by BOS and its end token dropped (reference :294-298);
- generation runs through decode/engine.generate in token-id mode with
  per-row top_p/top_k/typ_p/min_length/max_length vectors, one value per
  candidate slot tiled over the images, min-length EOS suppression, the
  repetition penalty, force-EOS early stop and alternate-token
  continuation; finished rows are masked, never spliced out, where the
  reference shrinks its batch (reference :252-268);
- the `num_runs` outer loop and the caption dedup run on the host
  (reference :313-326).

On CUDA the sampled step is K2 (engine's default filter_method "fused")
at [images x sample_count, V]. JAX's compile cache (`_SAMPLE_CACHE`) and
its split of traced and static settings exist for jax.jit; eager PyTorch
has nothing to recompile, so neither is ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import blip_text
from .engine import GenerationSettings, generate


@torch.no_grad()
def sample(
    image_embeds: torch.Tensor,  # [B, Tv, W] BLIP ViT tokens
    text: "blip_text.BlipText",  # the BLIP text decoder (float or int8)
    tokenizer,  # WordPiece: encode/decode, bos/sep ids
    sample_count: int = 3,
    top_p=0.0,
    top_k=0.0,
    typ_p=0.0,
    min_len=0,
    max_len=32,
    repetition_penalty: float = 1.3,
    force_eos_log_prob: float = math.log(0.9),
    min_alternate_prob: float = 0.0,
    prompt: str = "a picture of ",
    unique: bool = True,
    num_runs: int = 1,
    seed: int = 0,
    vocab_prefilter: int = 4096,
    gumbel_noise: Optional[Sequence[torch.Tensor]] = None,  # per run: [N, B*count, V]
):
    """Returns (captions, parameters, stats) as reference sampling.py:283:
    parameters[i] = [min_len, max_len, top_p] of candidate i, stats[i] =
    {"eos_prob": per-step raw log P(eos), "tokens": token ids}. Each run
    draws its seed from `seed`; `gumbel_noise` injects each run's per-step
    draws instead (tests feed JAX's)."""
    batch = image_embeds.shape[0]
    total = batch * sample_count
    dev = image_embeds.device
    img_mask = torch.ones(image_embeds.shape[:-1], dtype=torch.int32, device=dev)
    lm = blip_text.decoder_lm(text, image_embeds, img_mask, repeat=sample_count)

    bos, eos = tokenizer.bos_token_id, tokenizer.sep_token_id
    prompt_ids = tokenizer.encode(prompt)
    prompt_ids = [bos] + prompt_ids[1:-1] if prompt_ids else [bos]
    prompt_arr = torch.tensor(np.tile(np.asarray(prompt_ids, np.int64), (total, 1)), device=dev)

    def per_sample(x, dtype=np.float32) -> np.ndarray:
        x = np.asarray(x.cpu() if torch.is_tensor(x) else x, dtype)
        if x.ndim == 0:
            return np.full((total,), x, dtype)
        return np.tile(x.reshape(-1), batch)[:total]  # one value per slot, tiled over images

    max_len_v = per_sample(max_len, np.int32)
    settings = GenerationSettings(
        max_new_tokens=int(max_len_v.max()) + 1,
        top_p=per_sample(top_p), top_k=per_sample(top_k), typ_p=per_sample(typ_p),
        repetition_penalty=repetition_penalty, eos_token_id=int(eos),
        min_length=per_sample(min_len, np.int32), max_length=max_len_v,
        force_eos_log_prob=float(force_eos_log_prob),
        min_alternate_prob=float(min_alternate_prob),
        # the "sort" filters' candidate count (JAX's setting; the default
        # "fused" method does not read it)
        vocab_prefilter=int(vocab_prefilter), pad_token_id=0)

    seeds = torch.Generator().manual_seed(int(seed))
    captions, parameters, stats = [], [], []
    for run in range(num_runs):
        run_seed = int(torch.randint(0, 2**62, (1,), generator=seeds))
        out = generate(lm, prompt_arr, settings, seed=run_seed, prompt_tokens=prompt_arr,
                       gumbel_noise=None if gumbel_noise is None else gumbel_noise[run],
                       device=dev)
        tokens, lengths, eos_lp = (out[k].cpu().numpy()
                                   for k in ("tokens", "lengths", "eos_logprob"))
        for i in range(total):
            ids = [int(t) for t in tokens[i][: lengths[i]]]
            caption = tokenizer.decode([t for t in ids if t != eos])  # the eos itself dropped
            if unique and caption in captions:
                continue
            captions.append(caption)
            parameters.append([int(settings.min_length[i]), int(max_len_v[i]),
                               float(settings.top_p[i])])
            stats.append({"eos_prob": eos_lp[i][: lengths[i]], "tokens": ids})
    return captions, parameters, stats
