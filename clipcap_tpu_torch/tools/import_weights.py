"""Torch checkpoints -> the port's modules (port of the GPT-2, GPT-J, T5,
mapper, CLIP, BLIP and CLIP ResNet converters of
clipcap_tpu/tools/import_weights.py).

The reference loads its models from torch checkpoints (HF `from_pretrained`
at lms/GPT2.py:9, `clip.load` at train.py:206). Each converter here maps a
source state dict straight to the `state_dict` layout of the port's module,
ready for `convert.load`: no JAX layout in between. Inputs are plain
`{name: tensor or numpy array}` dicts (`torch.load` results, HF
`model.state_dict()`); nothing here imports `transformers`.

Layouts: torch nn.Linear stores [out, in], as the port's modules do, and is
copied through; HF GPT-2's Conv1D stores [in, out] and is transposed; a
patch Conv2d [D, C, P, P] becomes the per-patch linear [D, C*P*P]; the
ResNet's convolutions stay OIHW.
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


# --- BLIP (reference sampling.py:330-351) --------------------------------------------------


def blip_vit_from_hf_state_dict(sd: Mapping, cfg) -> StateDict:
    """HF BlipVisionModel (keys `embeddings.*`, `encoder.layers.*`,
    `post_layernorm.*`, bare or under `vision_model.`) -> models.vit.ViT
    (style "blip")."""
    p = "" if "embeddings.class_embedding" in sd else "vision_model."
    out = {"patch.weight": _conv_patch_to_matmul(sd[p + "embeddings.patch_embedding.weight"]),
           "patch.bias": _np(sd[p + "embeddings.patch_embedding.bias"]),
           "cls": _np(sd[p + "embeddings.class_embedding"]).reshape(-1),
           "pos": _np(sd[p + "embeddings.position_embedding"]).reshape(-1, cfg.width)}
    out |= _norm("ln_post", p + "post_layernorm", sd)
    for i in range(cfg.layers):
        s = f"{p}encoder.layers.{i}."
        out |= _prefixed(f"blocks.{i}", {
            **_norm("ln1", s + "layer_norm1", sd), **_norm("ln2", s + "layer_norm2", sd),
            **_linear("qkv", s + "self_attn.qkv", sd),
            **_linear("out", s + "self_attn.projection", sd),
            **_linear("fc1", s + "mlp.fc1", sd), **_linear("fc2", s + "mlp.fc2", sd)})
    return out


def blip_text_from_hf_state_dict(sd: Mapping, cfg, prefix: str = "") -> StateDict:
    """HF BlipTextLMHeadModel or BlipTextModel state dict ->
    models.blip_text.BlipText. `prefix` selects the submodel inside a larger
    checkpoint ("text_decoder." in BlipForConditionalGeneration); both
    "bert."-rooted LM-head checkpoints and bare text models are read. The
    MLM head comes in when the state dict has one."""
    b = prefix + "bert." if prefix + "bert.embeddings.word_embeddings.weight" in sd else prefix
    out = _copy(sd, [("word_embeddings", b + "embeddings.word_embeddings.weight"),
                     ("position_embeddings", b + "embeddings.position_embeddings.weight")])
    out |= _norm("emb_ln", b + "embeddings.LayerNorm", sd)
    for i in range(cfg.num_layers):
        s = f"{b}encoder.layer.{i}."
        blk = {}
        for dst, src in (("self_attn", "attention"), ("cross_attn", "crossattention")):
            for name, hf in (("wq", "query"), ("wk", "key"), ("wv", "value")):
                blk |= _linear(f"{dst}.{name}", f"{s}{src}.self.{hf}", sd)
            blk |= _linear(f"{dst}.wo", f"{s}{src}.output.dense", sd)
            blk |= _norm(f"{dst}.ln", f"{s}{src}.output.LayerNorm", sd)
        blk |= _linear("mlp.fc1", s + "intermediate.dense", sd)
        blk |= _linear("mlp.fc2", s + "output.dense", sd)
        blk |= _norm("mlp.ln", s + "output.LayerNorm", sd)
        out |= _prefixed(f"blocks.{i}", blk)
    c = prefix + "cls.predictions."
    if c + "decoder.weight" in sd:
        out |= _linear("cls_transform", c + "transform.dense", sd)
        out |= _norm("cls_ln", c + "transform.LayerNorm", sd)
        out |= _copy(sd, [("cls_decoder.weight", c + "decoder.weight"),
                          ("cls_decoder.bias", c + "bias")])
    return out


def blip_retrieval_from_hf_state_dict(sd: Mapping, vit_cfg, text_cfg) -> StateDict:
    """HF BlipForImageTextRetrieval -> models.blip_retrieval.BlipRetrieval
    (the vision tower, the text encoder with cross-attention, and the ITM
    and ITC heads)."""
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    out = _prefixed("visual", blip_vit_from_hf_state_dict(sub("vision_model."), vit_cfg))
    text = blip_text_from_hf_state_dict(sub("text_encoder."), text_cfg)
    out |= _prefixed("text", {k: v for k, v in text.items() if not k.startswith("cls_")})
    for name in ("vision_proj", "text_proj", "itm_head"):
        out |= _linear(name, name, sd)
    return out


# --- CLIP ModifiedResNet (RN50 to RN50x64) ------------------------------------------------


def clip_resnet_config_from_state_dict(sd: Mapping):
    """The ResNetConfig of an OpenAI checkpoint, from its tensor shapes (as
    clip.load derives it)."""
    from ..models.clip_resnet import ResNetConfig

    counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{stage}.")})
                   for stage in range(1, 5))
    width = _np(sd["visual.conv3.weight"]).shape[0]
    output_dim = _np(sd["visual.attnpool.c_proj.weight"]).shape[0]
    spacial = int(round((_np(sd["visual.attnpool.positional_embedding"]).shape[0] - 1) ** 0.5))
    return ResNetConfig(layers=counts, width=width, output_dim=output_dim,
                        heads=width * 32 // 64, image_size=spacial * 32)


def clip_resnet_from_openai_state_dict(sd: Mapping, cfg=None) -> StateDict:
    """OpenAI CLIP checkpoint (keys `visual.*`) -> models.clip_resnet.
    ModifiedResNet: its names without the prefix (BatchNorm's
    num_batches_tracked dropped), every tensor as float32."""
    return {k[len("visual."):]: _np(v) for k, v in sd.items()
            if k.startswith("visual.") and not k.endswith("num_batches_tracked")}
