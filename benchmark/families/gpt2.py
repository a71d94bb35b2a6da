"""The GPT-2 family: its weights' layout in the port's state-dict names
and the port's configuration objects for it. A configuration file names
its family; benchmark/weights.py and the drivers find this module by that
name, and the reference finds benchmark/reference/gpt2.py.
"""

from __future__ import annotations

import math
from typing import List

from ..weights import Leaf


def layout(cfg: dict, prefix: str = "lm.") -> List[Leaf]:
    d, n_layer = cfg["n_embd"], cfg["n_layer"]
    resid = 0.02 / math.sqrt(2 * n_layer)
    out = []
    for i in range(n_layer):
        p = f"{prefix}blocks.{i}."
        out += [(p + "ln1.weight", (d,), "const", 1.0), (p + "ln1.bias", (d,), "const", 0.0),
                (p + "c_attn.weight", (3 * d, d), "normal", 0.02),
                (p + "c_attn.bias", (3 * d,), "normal", 0.02),
                (p + "c_proj.weight", (d, d), "normal", resid),
                (p + "c_proj.bias", (d,), "normal", 0.02),
                (p + "ln2.weight", (d,), "const", 1.0), (p + "ln2.bias", (d,), "const", 0.0),
                (p + "c_fc.weight", (4 * d, d), "normal", 0.02),
                (p + "c_fc.bias", (4 * d,), "normal", 0.02),
                (p + "mlp_proj.weight", (d, 4 * d), "normal", resid),
                (p + "mlp_proj.bias", (d,), "normal", 0.02)]
    out += [(prefix + "wte", (cfg["vocab_size"], d), "normal", 0.02),
            (prefix + "wpe", (cfg["n_positions"], d), "normal", 0.02),
            (prefix + "ln_f.weight", (d,), "const", float(cfg["assumed"]["ln_f_gain"])),
            (prefix + "ln_f.bias", (d,), "const", 0.0)]
    return out


def program_configs(cfg: dict):
    """(the port's GPT2Config, the CaptionerConfig's LM type and variant)."""
    from clipcap_tpu_torch.core.config import GPT2Config

    lm = GPT2Config(vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
                    n_embd=cfg["n_embd"], n_layer=cfg["n_layer"], n_head=cfg["n_head"],
                    layer_norm_epsilon=cfg["layer_norm_epsilon"])
    return lm, "gpt2", "gpt2-xl"
