"""Language-model surface (port of clipcap_tpu/lm/registry.py: gpt2, gptj, t5;
and the port's own deepseek_v3, alias moonlight, which JAX lacks).

An LM of the port is an nn.Module with the protocol the decode engine drives:

    embed_tokens(tokens)                 -> [B, T, D]
    embedding_size()                     -> D
    forward(inputs_embeds, attention_mask=None, logits_slice=None) -> logits
    init_cache(batch, max_len, dtype)    -> cache
    prefill(inputs_embeds, cache)        -> (logits [B, 1, V], cache)
    decode_step(token_embed, cache)      -> (logits [B, V], cache)

and the class attribute `chunked_forward`: True where
`forward_cached(embeds, cache)` runs a multi-token continuation of a
cache (speculative verification's chunk), False or absent where the LM
decodes one position per row and the chunk takes one decode_step per
token (the int8 modules and T5, as JAX's int8 adapters and its T5 have
no `_forward_cached`).

Name aliases follow the reference CLIs (train.py:191-198). As in JAX,
`get_lm_config("t5"/"t0", variant)` gives `T5Config()` (t5-small) whatever
the variant: a checkpoint's own `lm` payload sets the real geometry
(cli/loading.py), and `T5Config.variant` names the presets.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..core.config import DeepseekV3Config, GPT2Config, GPTJConfig, T5Config


class LMFamily(NamedTuple):
    """What the port carries for one LM family, in one place: its LM class
    and config, its int8 quantizer, its converters between the JAX tree
    and the port's state dict (both ways), and its HF importer."""
    lm: type
    config: type
    quantize_params: Callable
    state_dict: Callable  # JAX params -> the port's state dict
    params: Callable  # (state dict, layers) -> JAX params
    from_hf: Callable  # (HF state dict, config) -> the port's state dict


def normalize_lm_type(lm_type: str) -> str:
    t = lm_type.lower()
    if t == "gpt2":
        return "gpt2"
    if t in ("gptj", "gpt-j"):
        return "gptj"
    if t in ("t0", "t5"):
        return "t5"
    if t in ("deepseek_v3", "deepseek-v3", "moonlight"):
        return "deepseek_v3"
    raise ValueError(
        f"invalid language model type {lm_type!r} (expected 'gpt-j' / 'gpt2' / 't0' / 't5' / "
        "'deepseek_v3' / 'moonlight')"
    )


def _gpt2() -> LMFamily:
    from ..convert import gpt2_params, gpt2_state_dict
    from ..models import gpt2
    from ..tools.import_weights import gpt2_from_state_dict

    return LMFamily(gpt2.GPT2, GPT2Config, gpt2.quantize_params, gpt2_state_dict,
                    gpt2_params, gpt2_from_state_dict)


def _gptj() -> LMFamily:
    from ..convert import gptj_params, gptj_state_dict
    from ..models import gptj
    from ..tools.import_weights import gptj_from_state_dict

    return LMFamily(gptj.GPTJ, GPTJConfig, gptj.quantize_params, gptj_state_dict,
                    gptj_params, gptj_from_state_dict)


def _t5() -> LMFamily:
    from ..convert import t5_params, t5_state_dict
    from ..models import t5
    from ..tools.import_weights import t5_from_state_dict

    return LMFamily(t5.T5, T5Config, t5.quantize_params, t5_state_dict, t5_params,
                    t5_from_state_dict)


def _deepseek_v3() -> LMFamily:
    from ..models import deepseek_v3 as m

    return LMFamily(m.DeepseekV3, DeepseekV3Config, m.quantize_params, m.tree_state_dict,
                    m.params_tree, m.from_hf_state_dict)


# the modules load when a family is first asked for (convert imports this one)
_FAMILIES = {"gpt2": _gpt2, "gptj": _gptj, "t5": _t5, "deepseek_v3": _deepseek_v3}


def family(lm_type: str) -> LMFamily:
    """The family of `lm_type` (an alias of gpt2, gptj, t5 or deepseek_v3)."""
    return _FAMILIES[normalize_lm_type(lm_type)]()


def get_lm(lm_type: str):
    """The LM class implementing the protocol above."""
    return family(lm_type).lm


def get_lm_config(lm_type: str, variant: str):
    """The family's preset `variant`; for t5/t0 the default T5Config
    whatever the variant, as JAX's registry returns it."""
    cfg = family(lm_type).config
    return cfg() if cfg is T5Config else cfg.variant(variant)
