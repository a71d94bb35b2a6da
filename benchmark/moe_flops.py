"""Operations and bytes of a DeepSeek-V3 captioner's serving (the
clipcap-moonlight16b cell), counted from shapes, and the kernels that
compute its routed experts' products.

`served_ops` counts the work the requests need, as benchmark/flops.py
does for GPT-2: per token 2 x the parameters its products touch (the
attention's projections, the dense layer's SwiGLU, per MoE layer the
router, the shared experts and the k routed experts it is sent to) plus
the scores and the weighted sum over its context, and the head where its
logits are needed.

`expert_gemm_bound_s` is the least time the card could take for the
routed experts' grouped products of a window's MoE calls: per call, the
weights of each expert that received a token read once (gate+up and
down), each routed token's input read and its output written once for
both products, over HBM bandwidth; or their operations over the bf16
peak, whichever is larger.
"""

from __future__ import annotations

from typing import Iterable

from .device import BF16_OPS_PER_S, HBM_BYTES_PER_S

# the name fragment of the grouped GEMM kernels torch._grouped_mm launches on
# sm90 (CUTLASS 3's GemmUniversal over a grouped problem shape, both products);
# the metric sums their device time
EXPERT_KERNELS = ("GroupProblem",)

BF16 = 2


def attention_params(cfg: dict) -> int:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    r, dn, dr, dv = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    return d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d


def token_params(cfg: dict, layer: int) -> int:
    """Parameters one token's products touch in `layer`."""
    d = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        mlp = 3 * d * cfg["intermediate_size"]
    else:
        f = cfg["moe_intermediate_size"]
        mlp = (d * cfg["n_routed_experts"] + 3 * d * f * cfg["n_shared_experts"]
               + 3 * d * f * cfg["num_experts_per_tok"])
    return attention_params(cfg) + mlp


def token_ops(cfg: dict, context: int, head: bool) -> float:
    """One position: the blocks' products, attention over `context` keys
    (scores over the nope and rope dims, the weighted sum over v), and the
    head if its logits are needed."""
    h = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    ops = sum(2.0 * token_params(cfg, i) for i in range(cfg["num_hidden_layers"]))
    ops += cfg["num_hidden_layers"] * 2.0 * context * h * (qk + cfg["v_head_dim"])
    return ops + (2.0 * cfg["hidden_size"] * cfg["vocab_size"] if head else 0.0)


def request_ops(cfg: dict, prefix_len: int, emitted: int) -> float:
    """A prefill of prefix_len positions (the head on its last only) and one
    decode step per emitted token (the last one's logits computed though
    unused)."""
    ops = sum(token_ops(cfg, i + 1, head=(i == prefix_len - 1)) for i in range(prefix_len))
    return ops + sum(token_ops(cfg, prefix_len + k + 1, head=True) for k in range(emitted))


def served_ops(cfg: dict, mix: dict, lengths: Iterable[int]) -> float:
    p = cfg["mapper"]["prefix_length"]
    return sum(request_ops(cfg, p, n) for n in lengths)


def expert_gemm_bound_s(cfg: dict, experts_hit: Iterable[int],
                        tokens_routed: Iterable[int]) -> float:
    """The least time for the grouped products of MoE calls that hit
    experts_hit[i] experts with tokens_routed[i] (token, expert) pairs."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    hit, pairs = sum(experts_hit), sum(tokens_routed)
    weight_bytes = hit * 3 * d * f * BF16
    act_bytes = pairs * BF16 * ((d + 2 * f) + (f + d))  # in and out of each product
    ops = pairs * 2.0 * 3 * d * f
    return max((weight_bytes + act_bytes) / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
