"""Language-model registry (gpt2, gptj and t5/t0)."""
