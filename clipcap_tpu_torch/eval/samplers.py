"""Caption samplers (port of NoBeamCaptionSampler, ClipGuidedCaptionSampler
and BeamCaptionSampler, clipcap_tpu/eval/samplers.py).

A sampler takes the bundle and image tensors, runs visual encoder ->
mapper, then a decode strategy: pixels in, captions out. NoBeamCaptionSampler
(reference evaluate_model.py:374-393 over generate_no_beam :104-179) runs
the top_p sweep as the batch of one KV-cached generate(): BOS is
prepended, '.' stops count up to max_stops, any special token stops, and
specials are stripped from the output. ClipGuidedCaptionSampler (reference
:396-419) runs decode/clip_guided.py's lookahead. BeamCaptionSampler
returns the best beam of decode/beam.py per image.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..decode.beam import beam_search, beam_search_batched, best_beam_text, best_beam_texts
from ..decode.clip_guided import generate_clip_guided, generate_clip_guided_batch
from ..decode.engine import GenerationSettings, generate, trim_and_decode


class CaptionSamplerBase:
    def sample(self, bundle, image_tensor, image=None) -> List[str]:
        image_tensor = torch.as_tensor(image_tensor)
        if image_tensor.dim() == 3:
            image_tensor = image_tensor[None]
        image_embedding = bundle.encode_image(image_tensor)
        prefix = bundle.project_prefix(image_embedding)
        return self.generate_captions(bundle, prefix, image_embedding, image)

    def get_description(self) -> str:
        raise NotImplementedError()

    def generate_captions(self, bundle, prefix, image_embedding, image) -> List[str]:
        raise NotImplementedError()


class NoBeamCaptionSampler(CaptionSamplerBase):
    def __init__(
        self,
        top_p_values: Sequence[float] = (0.1,),
        temperature: float = 1.0,
        repetition_penalty: float = 1.2,
        max_decode_length: int = 75,
        max_stops: int = 3,
        stop_token: str = ".",
        seed: int = 0,
        vocab_prefilter: int = 4096,
        device: str = "cuda",
    ):
        if max_decode_length > 77:
            raise ValueError("maximum context length for CLIP models is 77")
        self.top_p_values = list(top_p_values)
        self.temperature = temperature
        self.repetition_penalty = repetition_penalty
        self.max_decode_length = max_decode_length
        self.max_stops = max_stops
        self.stop_token = stop_token
        self.seed = seed
        self.vocab_prefilter = vocab_prefilter  # acts only with filter_method="sort"
        self.device = device

    def get_description(self):
        return (
            f"NoBeam(rep_p={self.repetition_penalty}, temp={self.temperature}, "
            f"top_p={self.top_p_values})"
        )

    def _generate(self, bundle, prefix: torch.Tensor, n_img: int) -> dict:
        """One generate() over prefix rows repeated per top_p value
        (image-major: [img0 x sweep, img1 x sweep, ...])."""
        tokenizer = bundle.tokenizer
        n_p = len(self.top_p_values)
        prefix_rep = prefix.repeat_interleave(n_p, dim=0)
        bos = torch.full((n_img * n_p, 1), tokenizer.bos_token_id, dtype=torch.int64,
                         device=prefix.device)
        with torch.no_grad():
            prompt = torch.cat([prefix_rep, bundle.embed_text(bos).to(prefix.dtype)], dim=1)
            settings = GenerationSettings(
                max_new_tokens=self.max_decode_length,
                temperature=self.temperature,
                top_p=torch.tensor(self.top_p_values * n_img, dtype=torch.float32),
                repetition_penalty=self.repetition_penalty,
                stop_token_id=tokenizer.encode_text(self.stop_token)[0],
                max_stops=self.max_stops,
                stop_on_special=tuple(tokenizer.all_special_ids),
                vocab_prefilter=self.vocab_prefilter,
            )
            return generate(bundle.lm_decode, prompt, settings, seed=self.seed,
                            device=self.device,
                            cache_constraint=getattr(bundle, "cache_constraint", None))

    def generate_captions(self, bundle, prefix, image_embedding=None, image=None) -> List[str]:
        out = self._generate(bundle, prefix, prefix.shape[0])
        return trim_and_decode(out, bundle.tokenizer, strip_special=True)

    def sample_batch(self, bundle, image_tensors, images=None) -> List[List[str]]:
        """The top_p sweep for EACH of N images in ONE generate() call.

        Matches per-image sample() in distribution, not bit for bit: the
        engine draws one [rows, V] Gumbel per step, so a row's draws depend
        on its index in the stacked batch. With top_p small enough to pin
        the top token the outputs are exact. `images` is unused (the
        uniform sample_batch signature of the samplers)."""
        image_tensors = torch.as_tensor(image_tensors)
        if image_tensors.dim() == 3:
            image_tensors = image_tensors[None]
        prefix = bundle.prefix_from_pixels(image_tensors)
        n_img, n_p = prefix.shape[0], len(self.top_p_values)
        flat = trim_and_decode(self._generate(bundle, prefix, n_img), bundle.tokenizer,
                               strip_special=True)
        return [flat[i * n_p: (i + 1) * n_p] for i in range(n_img)]


class ClipGuidedCaptionSampler(CaptionSamplerBase):
    """CLIP-guided lookahead (decode/clip_guided.py), one caption per image.

    sample_batch runs all N images in one generate_clip_guided_batch call
    of up to N * branching_factor**(look_ahead-1) tree rows. The JAX
    sampler splits a call at 512 tree rows, where the TPU compiler's layout
    of the decode step turns slow; that limit is the TPU's, so one call here
    may hold more rows than one call there. Chunking would change no
    caption: images are independent."""

    def __init__(self, clip_scoring, branching_factor: int = 3, look_ahead: int = 4,
                 repetition_penalty: float = 1.2, device: str = "cuda"):
        self.clip_scoring = clip_scoring
        self.branching_factor = branching_factor
        self.look_ahead = look_ahead
        self.repetition_penalty = repetition_penalty
        self.device = device

    def get_description(self):
        return (
            f"ClipGuided(branching={self.branching_factor}, "
            f"look_ahead={self.look_ahead}, rep_p={self.repetition_penalty})"
        )

    def _kw(self) -> dict:
        return dict(branching_factor=self.branching_factor, look_ahead=self.look_ahead,
                    repetition_penalty_value=self.repetition_penalty, device=self.device)

    def generate_captions(self, bundle, prefix, image_embedding, image) -> List[str]:
        clip_image_embedding = self.clip_scoring.embed_image(
            self.clip_scoring.preprocess_image(image))
        return [generate_clip_guided(bundle, self.clip_scoring, clip_image_embedding[0], prefix,
                                     **self._kw())]

    def sample_batch(self, bundle, image_tensors, images) -> List[List[str]]:
        """One clip-guided caption for each of N images (PIL `images`, which
        the CLIP scorer preprocesses and encodes in one batch), every tree
        step and CLIP text batch shared across them. Per-image results
        equal sample() on the CPU in f32."""
        image_tensors = torch.as_tensor(image_tensors)
        if image_tensors.dim() == 3:
            image_tensors = image_tensors[None]
        prefix = bundle.prefix_from_pixels(image_tensors)
        clip_embs = self.clip_scoring.embed_image(
            np.stack([self.clip_scoring.preprocess_image(img) for img in images]))
        caps = generate_clip_guided_batch(bundle, self.clip_scoring, clip_embs, prefix,
                                          **self._kw())
        return [[c] for c in caps]


class BeamCaptionSampler(CaptionSamplerBase):
    """The best beam per image (decode/beam.py, reference inference.py:70-148).

    sample_batch runs all N images in one beam_search_batched call of
    N x beam_size rows. The JAX sampler splits a call at 480 rows, where
    the TPU compiler's layout of the decode step turns slow; that limit is
    the TPU's, so one call here may hold more rows than one call there.
    Chunking would change no token: images are independent."""

    def __init__(self, beam_size: int = 5, max_decode_length: int = 67,
                 temperature: float = 1.0, stop_token: str = ".", device: str = "cuda"):
        self.beam_size = beam_size
        self.max_decode_length = max_decode_length
        self.temperature = temperature
        self.stop_token = stop_token
        self.device = device

    def get_description(self):
        return f"Beam(size={self.beam_size}, temp={self.temperature})"

    def _kw(self, bundle) -> dict:
        return dict(beam_size=self.beam_size, max_new_tokens=self.max_decode_length,
                    temperature=self.temperature,
                    stop_token_id=bundle.tokenizer.encode_text(self.stop_token)[0],
                    device=self.device,
                    cache_constraint=getattr(bundle, "cache_constraint", None))

    def generate_captions(self, bundle, prefix, image_embedding=None, image=None) -> List[str]:
        out = beam_search(bundle.lm_decode, prefix, **self._kw(bundle))
        return [best_beam_text(out, bundle.tokenizer)]

    def sample_batch(self, bundle, image_tensors, images=None) -> List[List[str]]:
        """The best-beam caption of each of N images; `images` is unused
        (the uniform sample_batch signature of the samplers)."""
        image_tensors = torch.as_tensor(image_tensors)
        if image_tensors.dim() == 3:
            image_tensors = image_tensors[None]
        prefix = bundle.prefix_from_pixels(image_tensors)
        out = beam_search_batched(bundle.lm_decode, prefix, **self._kw(bundle))
        return [[t] for t in best_beam_texts(out, bundle.tokenizer)]
