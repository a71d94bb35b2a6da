"""Caption rankers (CLIP cosine, BLIP ITM/ITC) and ranking cascades."""

from .cascade import threshold_cascade, two_stage_rank
from .rankers import BLIPRanker, CLIPRanker, cos_sim

__all__ = ["BLIPRanker", "CLIPRanker", "cos_sim", "threshold_cascade", "two_stage_rank"]
