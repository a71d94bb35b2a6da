"""Caption rankers (CLIP cosine similarity)."""
