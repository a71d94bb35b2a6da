"""Torch checkpoints -> the port's modules (port of the GPT-2, GPT-J, T5,
mapper and CLIP converters of clipcap_tpu/tools/import_weights.py).

The reference loads its models from torch checkpoints (HF `from_pretrained`
at lms/GPT2.py:9, `clip.load` at train.py:206). Each converter here maps a
source state dict straight to the `state_dict` layout of the port's module,
ready for `convert.load`: no JAX layout in between. Inputs are plain
`{name: tensor or numpy array}` dicts (`torch.load` results, HF
`model.state_dict()`); nothing here imports `transformers`.

Layouts: torch nn.Linear stores [out, in], as the port's modules do, and is
copied through; HF GPT-2's Conv1D stores [in, out] and is transposed; a
patch Conv2d [D, C, P, P] becomes the per-patch linear [D, C*P*P]. The
BLIP and ResNet converters come with their ROADMAP.md items.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    """Accept torch tensors or numpy arrays; floating values come out as
    float32, the JAX converters' default dtype (a half-precision CLIP
    state dict gives f32 towers, as there)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32, copy=False) if x.dtype.kind == "f" else x


def _copy(sd: Mapping, pairs, transpose: bool = False) -> StateDict:
    """{port name: sd[source name]} for (port, source) pairs, each
    transposed when asked."""
    return {dst: (_np(sd[src]).T if transpose else _np(sd[src])) for dst, src in pairs}


def _linear(dst: str, src: str, sd: Mapping, transpose: bool = False) -> StateDict:
    return _copy(sd, [(dst + ".weight", src + ".weight")], transpose) | \
        _copy(sd, [(dst + ".bias", src + ".bias")])


def _norm(dst: str, src: str, sd: Mapping) -> StateDict:
    return _copy(sd, [(dst + ".weight", src + ".weight"), (dst + ".bias", src + ".bias")])


def _conv_patch_to_matmul(w) -> np.ndarray:
    """Conv2d weight [D, C, P, P] -> per-patch linear weight [D, C*P*P]
    (the (c, ph, pw) flatten order of models/vit.patchify)."""
    w = _np(w)
    return w.reshape(w.shape[0], -1)


def _fused_qkv(sd: Mapping, prefix: str) -> StateDict:
    """One qkv linear ([3D, D], rows q, k, v) from separate q/k/v linears."""
    names = [f"{prefix}.{p}_proj" for p in "qkv"]
    return {"qkv.weight": np.concatenate([_np(sd[n + ".weight"]) for n in names], axis=0),
            "qkv.bias": np.concatenate([_np(sd[n + ".bias"]) for n in names])}


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def gpt2_from_state_dict(sd: Mapping, cfg) -> StateDict:
    """HF GPT2LMHeadModel state dict (keys `transformer.*`, or a bare
    GPT2Model's) -> models.gpt2.GPT2."""
    p = "transformer."
    if p + "wte.weight" not in sd and "wte.weight" in sd:
        p = ""
    out = _copy(sd, [("wte", p + "wte.weight"), ("wpe", p + "wpe.weight")])
    out |= _norm("ln_f", p + "ln_f", sd)
    for i in range(cfg.n_layer):
        h = f"{p}h.{i}."
        blk = {**_norm("ln1", h + "ln_1", sd), **_norm("ln2", h + "ln_2", sd),
               # HF Conv1D stores [in, out]
               **_linear("c_attn", h + "attn.c_attn", sd, transpose=True),
               **_linear("c_proj", h + "attn.c_proj", sd, transpose=True),
               **_linear("c_fc", h + "mlp.c_fc", sd, transpose=True),
               **_linear("mlp_proj", h + "mlp.c_proj", sd, transpose=True)}
        out |= _prefixed(f"blocks.{i}", blk)
    return out


def gptj_from_state_dict(sd: Mapping, cfg) -> StateDict:
    """HF GPTJForCausalLM state dict (keys `transformer.*` and `lm_head.*`,
    or a bare GPTJModel's beside `lm_head.*`) -> models.gptj.GPTJ. HF's
    nn.Linear weights are [out, in] already; GPT-J's head is biased and
    untied."""
    p = "transformer."
    if p + "wte.weight" not in sd and "wte.weight" in sd:
        p = ""
    out = _copy(sd, [("wte", p + "wte.weight")]) | _norm("ln_f", p + "ln_f", sd)
    out |= _linear("lm_head", "lm_head", sd)
    for i in range(cfg.n_layer):
        h = f"{p}h.{i}."
        blk = {**_norm("ln1", h + "ln_1", sd),
               **_copy(sd, [(f"{dst}.weight", f"{h}attn.{src}.weight") for dst, src in
                            (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                             ("wo", "out_proj"))]),
               **_linear("w_in", h + "mlp.fc_in", sd), **_linear("w_out", h + "mlp.fc_out", sd)}
        out |= _prefixed(f"blocks.{i}", blk)
    return out


def t5_from_state_dict(sd: Mapping, cfg) -> StateDict:
    """HF T5ForConditionalGeneration state dict -> models.t5.T5. Each stack's
    relative-bias table is its block 0's; the lm_head is read when the
    embeddings are untied and the state dict has one."""
    out = {"shared": _np(sd["shared.weight"])}
    mlp = ([("wi_0", "wi_0"), ("wi_1", "wi_1"), ("wo", "wo")]
           if cfg.feed_forward_proj == "gated-gelu" else [("wi_0", "wi"), ("wo", "wo")])
    stacks = {"encoder": (cfg.num_layers, [("attn", "SelfAttention")]),
              "decoder": (cfg.num_decoder_layers, [("self_attn", "SelfAttention"),
                                                   ("cross_attn", "EncDecAttention")])}
    for stack, (n, attns) in stacks.items():
        out[f"{stack}.rel_bias"] = _np(
            sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
        out[f"{stack}.ln_f.weight"] = _np(sd[f"{stack}.final_layer_norm.weight"])
        for i in range(n):
            dst, src = f"{stack}.blocks.{i}", f"{stack}.block.{i}.layer"
            for j, (name, hf) in enumerate(attns):
                out[f"{dst}.ln{j + 1}.weight"] = _np(sd[f"{src}.{j}.layer_norm.weight"])
                out.update(_copy(sd, [(f"{dst}.{name}.{p}.weight", f"{src}.{j}.{hf}.{h}.weight")
                                      for p, h in zip(("wq", "wk", "wv", "wo"), "qkvo")]))
            j = len(attns)
            out[f"{dst}.ln{j + 1}.weight"] = _np(sd[f"{src}.{j}.layer_norm.weight"])
            out.update(_copy(sd, [(f"{dst}.mlp.{p}.weight", f"{src}.{j}.DenseReluDense.{h}.weight")
                                  for p, h in mlp]))
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        out["lm_head.weight"] = _np(sd["lm_head.weight"])
    return out


def mapper_from_torch_state_dict(sd: Mapping, cfg) -> StateDict:
    """The reference's torch mapper (layers/Transformer.py: linear,
    prefix_const, [pos_embeddings], transformer.layers.{i}.norm1,
    attn.to_queries, attn.to_keys_values, attn.project, norm2, mlp.fc1,
    mlp.fc2) -> models.mapper.Mapper."""
    out = _linear("linear", "linear", sd) | _copy(sd, [("prefix_const", "prefix_const")])
    if "pos_embeddings" in sd:
        out |= _copy(sd, [("pos_embeddings", "pos_embeddings")])
    for i in range(cfg.num_layers):
        s = f"transformer.layers.{i}."
        lay = {**_norm("ln1", s + "norm1", sd), **_norm("ln2", s + "norm2", sd),
               **_copy(sd, [("wq.weight", s + "attn.to_queries.weight"),
                            ("wkv.weight", s + "attn.to_keys_values.weight")]),
               **_linear("wo", s + "attn.project", sd),
               **_linear("fc1", s + "mlp.fc1", sd), **_linear("fc2", s + "mlp.fc2", sd)}
        out |= _prefixed(f"layers.{i}", lay)
    return out


def _hf_block(sd: Mapping, s: str) -> StateDict:
    """One HF CLIPEncoderLayer -> a ViT / CLIPText block of the port."""
    return {**_norm("ln1", s + "layer_norm1", sd), **_norm("ln2", s + "layer_norm2", sd),
            **_fused_qkv(sd, s + "self_attn"), **_linear("out", s + "self_attn.out_proj", sd),
            **_linear("fc1", s + "mlp.fc1", sd), **_linear("fc2", s + "mlp.fc2", sd)}


def _openai_block(sd: Mapping, s: str) -> StateDict:
    """One OpenAI CLIP ResidualAttentionBlock -> a ViT / CLIPText block."""
    return {**_norm("ln1", s + "ln_1", sd), **_norm("ln2", s + "ln_2", sd),
            # in_proj_weight is [3D, D] with rows q, k, v
            **_copy(sd, [("qkv.weight", s + "attn.in_proj_weight"),
                         ("qkv.bias", s + "attn.in_proj_bias")]),
            **_linear("out", s + "attn.out_proj", sd),
            **_linear("fc1", s + "mlp.c_fc", sd), **_linear("fc2", s + "mlp.c_proj", sd)}


def clip_vit_from_hf_state_dict(sd: Mapping, cfg) -> StateDict:
    """HF CLIPVisionModelWithProjection or CLIPModel (keys `vision_model.*`,
    `visual_projection.weight`) -> models.vit.ViT (style "clip")."""
    p = "vision_model."
    out = {"patch.weight": _conv_patch_to_matmul(sd[p + "embeddings.patch_embedding.weight"]),
           "cls": _np(sd[p + "embeddings.class_embedding"]).reshape(-1),
           "pos": _np(sd[p + "embeddings.position_embedding.weight"])}
    out |= _norm("ln_pre", p + "pre_layrnorm", sd) | _norm("ln_post", p + "post_layernorm", sd)
    for i in range(cfg.layers):
        out |= _prefixed(f"blocks.{i}", _hf_block(sd, f"{p}encoder.layers.{i}."))
    if "visual_projection.weight" in sd:
        out["proj"] = _np(sd["visual_projection.weight"]).T
    return out


def clip_vit_from_openai_state_dict(sd: Mapping, cfg) -> StateDict:
    """OpenAI CLIP checkpoint (keys `visual.*`) -> models.vit.ViT (style "clip")."""
    p = "visual."
    out = {"patch.weight": _conv_patch_to_matmul(sd[p + "conv1.weight"]),
           "cls": _np(sd[p + "class_embedding"]).reshape(-1),
           "pos": _np(sd[p + "positional_embedding"]),
           "proj": _np(sd[p + "proj"])}  # already [D, out]
    out |= _norm("ln_pre", p + "ln_pre", sd) | _norm("ln_post", p + "ln_post", sd)
    for i in range(cfg.layers):
        out |= _prefixed(f"blocks.{i}", _openai_block(sd, f"{p}transformer.resblocks.{i}."))
    return out


def clip_text_from_hf_state_dict(sd: Mapping, cfg) -> StateDict:
    """HF CLIPTextModelWithProjection or CLIPModel -> models.clip_text.CLIPText."""
    p = "text_model."
    out = {"token_embedding": _np(sd[p + "embeddings.token_embedding.weight"]),
           "pos": _np(sd[p + "embeddings.position_embedding.weight"]),
           "text_projection": _np(sd["text_projection.weight"]).T}
    out |= _norm("ln_final", p + "final_layer_norm", sd)
    for i in range(cfg.layers):
        out |= _prefixed(f"blocks.{i}", _hf_block(sd, f"{p}encoder.layers.{i}."))
    return out


def clip_text_from_openai_state_dict(sd: Mapping, cfg) -> StateDict:
    """OpenAI CLIP checkpoint (text tower keys at the top level) ->
    models.clip_text.CLIPText."""
    out = {"token_embedding": _np(sd["token_embedding.weight"]),
           "pos": _np(sd["positional_embedding"]),
           "text_projection": _np(sd["text_projection"])}  # already [D, out]
    out |= _norm("ln_final", "ln_final", sd)
    for i in range(cfg.layers):
        out |= _prefixed(f"blocks.{i}", _openai_block(sd, f"transformer.resblocks.{i}."))
    return out
