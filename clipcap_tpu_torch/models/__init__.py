"""Models of the captioning path: ViT, mapper, GPT-2, captioner, bundle,
and CLIP's text tower."""
