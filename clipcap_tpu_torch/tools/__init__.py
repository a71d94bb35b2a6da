"""Weight converters (import_weights.py) and measurement tools for the
port's kernels (k1_variants.py, sampler_variants.py; run on a CUDA card)."""
