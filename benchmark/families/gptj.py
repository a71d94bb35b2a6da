"""The GPT-J family: its weights' layout in the port's state-dict names
and the port's configuration objects for it. A configuration file names
its family; benchmark/weights.py and the drivers find this module by that
name, and the reference finds benchmark/reference/gptj.py.
"""

from __future__ import annotations

from typing import List

from ..weights import Leaf


def layout(cfg: dict, prefix: str = "lm.") -> List[Leaf]:
    d = cfg["n_embd"]
    out = []
    for i in range(cfg["n_layer"]):
        p = f"{prefix}blocks.{i}."
        out += [(p + "ln1.weight", (d,), "const", 1.0), (p + "ln1.bias", (d,), "const", 0.0)]
        out += [(p + n + ".weight", (d, d), "normal", 0.02) for n in ("wq", "wk", "wv", "wo")]
        out += [(p + "w_in.weight", (4 * d, d), "normal", 0.02),
                (p + "w_in.bias", (4 * d,), "normal", 0.02),
                (p + "w_out.weight", (d, 4 * d), "normal", 0.02),
                (p + "w_out.bias", (d,), "normal", 0.02)]
    out += [(prefix + "wte", (cfg["vocab_size"], d), "normal", 0.02),
            (prefix + "ln_f.weight", (d,), "const", float(cfg["assumed"]["ln_f_gain"])),
            (prefix + "ln_f.bias", (d,), "const", 0.0),
            (prefix + "lm_head.weight", (cfg["vocab_size"], d), "normal", 0.02),
            (prefix + "lm_head.bias", (cfg["vocab_size"],), "normal", 0.02)]
    return out


def program_configs(cfg: dict):
    """(the port's GPTJConfig, the CaptionerConfig's LM type and variant)."""
    from clipcap_tpu_torch.core.config import GPTJConfig

    lm = GPTJConfig(vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
                    n_embd=cfg["n_embd"], n_layer=cfg["n_layer"], n_head=cfg["n_head"],
                    rotary_dim=cfg["rotary_dim"], layer_norm_epsilon=cfg["layer_norm_epsilon"])
    return lm, "gptj", "gpt-j-6B"
