"""Language-model registry (gpt2 and gptj)."""
