"""Weight converters (import_weights.py); dataset preprocessing on the card
(preprocess.py) and the host-only dataset tools (merge_shards.py,
file_hashes.py, len_distribution.py, resize_images.py); Gumbel-softmax
caption optimization against BLIP-ITC (gumbel_caption_opt.py); measurement
tools (profile_decode.py, profile_train_step.py, and k1_variants.py and
sampler_variants.py for the port's kernels; they run on a CUDA card)."""
