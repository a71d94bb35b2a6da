"""Checkpoints (the training loop comes with ROADMAP.md's training item)."""
