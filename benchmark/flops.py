"""Model operations a cell's traffic needs, counted from shapes: 2 x the
parameters in the matrix products for each token processed, plus attention
over the context (4 x context x width per layer and token: the score and
the value products). Only the work the requests need is counted: no dead
slot, no padding, no position of a ring the window bias hides.
"""

from __future__ import annotations


def gpt2_block_params(cfg: dict) -> int:
    """Parameters in one GPT-2 block's products: c_attn 3d^2, c_proj d^2,
    c_fc 4d^2, mlp_proj 4d^2."""
    return 12 * cfg["n_embd"] ** 2


def gpt2_request_ops(cfg: dict, prefix_len: int, emitted: int) -> float:
    """One served request: a prefill of `prefix_len` positions (the head on
    its last position only) and one decode step per emitted token (the
    last one's logits are computed though unused)."""
    d, layers, vocab = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    body = 2 * gpt2_block_params(cfg) * layers
    head = 2 * d * vocab
    positions = prefix_len + emitted
    ops = body * positions + head * (1 + emitted)
    # causal attention: the query at position i reads i + 1 keys
    ops += 4 * d * layers * positions * (positions + 1) / 2
    return float(ops)


def served_ops(cfg: dict, mix: dict, lengths) -> float:
    """All requests harvested in the window, by their emitted lengths."""
    p = cfg["mapper"]["prefix_length"]
    return sum(gpt2_request_ops(cfg, p, n) for n in lengths)


def linear_ops(tokens: float, fan_in: int, fan_out: int) -> float:
    return 2.0 * tokens * fan_in * fan_out


def vit_image_ops(v: dict) -> float:
    """One image through CLIP's ViT: the patch projection, the blocks'
    products and attention over all tokens, the pooled projection."""
    d, p = v["width"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    t = n + 1
    hidden = int(d * v["mlp_ratio"])
    per_layer = linear_ops(t, d, 3 * d) + linear_ops(t, d, d) + linear_ops(t, d, hidden) \
        + linear_ops(t, hidden, d) + 4.0 * t * t * d
    return linear_ops(n, 3 * p * p, d) + v["layers"] * per_layer + linear_ops(1, d, v["output_dim"])


def mapper_ops(m: dict) -> float:
    """One feature through the transformer mapper."""
    d = m["dim_embedding"]
    t = m["clip_length"] + m["prefix_length"]
    hidden = int(d * m["mlp_ratio"])
    per_layer = linear_ops(t, d, 3 * d) + linear_ops(t, d, d) + linear_ops(t, d, hidden) \
        + linear_ops(t, hidden, d) + 4.0 * t * t * d
    return linear_ops(1, m["dim_clip"], m["clip_length"] * d) + m["num_layers"] * per_layer


def gptj_token_ops(cfg: dict, context: int, head: bool) -> float:
    """One position through GPT-J: q, k, v, o and the MLP (12 d^2 a layer),
    attention over `context` keys, and the head if its logits are needed."""
    d = cfg["n_embd"]
    ops = cfg["n_layer"] * (2.0 * 12 * d * d + 4.0 * context * d)
    return ops + (2.0 * d * cfg["vocab_size"] if head else 0.0)


def beam_call_ops(cfg: dict, mix: dict) -> float:
    """One caption_pixels beam call: the images' encode and mapping, the
    prefill of each image's prefix (head on its last position), then one
    decode step for every beam row at each of max_new_tokens - 1 steps."""
    n, beam, steps = mix["images"], mix["beam_size"], mix["max_new_tokens"]
    p = cfg["mapper"]["prefix_length"]
    ops = n * (vit_image_ops(cfg["visual"]) + mapper_ops(cfg["mapper"]))
    ops += n * sum(gptj_token_ops(cfg, i + 1, head=(i == p - 1)) for i in range(p))
    ops += n * beam * sum(gptj_token_ops(cfg, p + k + 1, head=True) for k in range(1, steps))
    return ops
