"""KV-cached generation engine and CLIP-guided lookahead decoding."""

from .clip_guided import generate_clip_guided, generate_clip_guided_batch
from .engine import GenerationSettings, filter_and_sample, generate, trim_and_decode

__all__ = ["GenerationSettings", "filter_and_sample", "generate", "generate_clip_guided",
           "generate_clip_guided_batch", "trim_and_decode"]
