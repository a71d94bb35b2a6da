"""The DeepSeek-V3 family (Moonlight-16B-A3B): its weights' layout in the
port's state-dict names and the port's configuration objects for it. A
configuration file names its family; benchmark/weights.py and the drivers
find this module by that name, and the reference finds
benchmark/reference/deepseek_v3.py.

Weights are N(0, 0.02), the projections that write into the residual
stream (o_proj and every SwiGLU's down) N(0, 0.02 / sqrt(2 L)) as GPT-2's
residual projections, the token embedding N(0, `assumed.embed_std`),
RMSNorm gains 1, the router's correction bias N(0,
`assumed.router_bias_std`) and the final norm's gain
`assumed.final_norm_gain` (the configuration file says why).
"""

from __future__ import annotations

import math
from typing import List

from ..weights import Leaf

STD = 0.02


def layout(cfg: dict, prefix: str = "lm.") -> List[Leaf]:
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    r, dn, dr, dv = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = cfg["n_shared_experts"] * f
    a = cfg["assumed"]
    resid = STD / math.sqrt(2 * cfg["num_hidden_layers"])
    out = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"{prefix}layers.{i}."
        out += [(p + "attn_norm.weight", (d,), "const", 1.0),
                (p + "attn.q_proj.weight", (heads * (dn + dr), d), "normal", STD),
                (p + "attn.kv_a.weight", (r + dr, d), "normal", STD),
                (p + "attn.kv_norm.weight", (r,), "const", 1.0),
                (p + "attn.kv_b.weight", (heads * (dn + dv), r), "normal", STD),
                (p + "attn.o_proj.weight", (d, heads * dv), "normal", resid),
                (p + "mlp_norm.weight", (d,), "const", 1.0)]
        if i < cfg["first_k_dense_replace"]:
            w = cfg["intermediate_size"]
            out += [(p + "mlp.gate_up.weight", (2 * w, d), "normal", STD),
                    (p + "mlp.down.weight", (d, w), "normal", resid)]
            continue
        out += [(p + "mlp.router.weight", (e, d), "normal", STD),
                (p + "mlp.router_bias", (e,), "normal", float(a["router_bias_std"])),
                (p + "mlp.experts.gate_up", (e, 2 * f, d), "normal", STD),
                (p + "mlp.experts.down", (e, d, f), "normal", resid),
                (p + "mlp.shared.gate_up.weight", (2 * shared, d), "normal", STD),
                (p + "mlp.shared.down.weight", (d, shared), "normal", resid)]
    out += [(prefix + "embed", (cfg["vocab_size"], d), "normal", float(a["embed_std"])),
            (prefix + "norm.weight", (d,), "const", float(a["final_norm_gain"])),
            (prefix + "head.weight", (cfg["vocab_size"], d), "normal", STD)]
    return out


def program_configs(cfg: dict):
    """(the port's DeepseekV3Config, the CaptionerConfig's LM type and variant)."""
    import dataclasses

    from clipcap_tpu_torch.core.config import DeepseekV3Config

    names = {f.name for f in dataclasses.fields(DeepseekV3Config)}
    lm = DeepseekV3Config(**{k: v for k, v in cfg.items() if k in names})
    return lm, "deepseek_v3", "Moonlight-16B-A3B"
