"""Caption samplers, CLIP scoring, the COCO validator and the caption
metrics (BLEU, METEOR, ROUGE-L, CIDEr-D, SPICE: copies of the JAX
package's pure-Python files)."""
