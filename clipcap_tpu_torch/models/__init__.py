"""Models of the captioning path: ViT, mapper, GPT-2, GPT-J, T5/T0, captioner,
bundle, and CLIP's text tower."""
