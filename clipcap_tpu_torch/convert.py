"""Convert the JAX package's parameters into the port's modules.

The JAX parameters come in as a pytree of numpy arrays (nested dicts):
layers stacked on a leading [L] axis, linear weights [in, out]. The port's
modules hold one submodule per layer and nn.Linear weights [out, in]. This
module owns every unstack and transpose; `load` copies the converted
tensors into a module, which keeps its device and takes the dtype each
tensor was stored in. `captioner_params` goes the other way, from a port
Captioner back to the JAX pytree layout (the layout of the checkpoint the
port writes, train/checkpoints.py).

bf16 on the host: numpy has no bf16. A JAX bf16 leaf is an `ml_dtypes`
bfloat16 array, which `np.save` writes as 2-byte records and `np.load`
gives back as `|V2` void records. Every 2-byte void array here is such a
bf16 leaf: `to_torch` views its bits as int16, then as torch.bfloat16, and
`to_numpy` writes a bf16 tensor back as `|V2` records, bit for bit.
Transposes, indexing and stacks move the records unchanged.

int8 trees: a quantized linear leaf of the JAX package, {"q": int8
[in, out], "s": f32 [out]} (ops/quant.quantize_weight), becomes the
port's Int8Linear buffers `q` [out, in] and `s`, and back. GPT-2's int8
`lm_head` ([D, V]) is padded to the port's multiple-of-8 channels with
q = 0 and s = 1e-12, what the port's own quantization gives zero rows,
and sliced back to the vocabulary on the way out. GPT-J's int8 lm_head
(vocabulary 50400) and T5's (32128 for T0) need no padding. So the
converters read and write what `gpt2.quantize_params`,
`gptj.quantize_params`, `t5.quantize_params`, `blip_text.quantize_params`
and `vit.quantize_params` make in either package (BLIP's int8 head, vocabulary
30524, is padded as GPT-2's is).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .ops.quant import CHANNEL_ALIGN, is_quantized

StateDict = Dict[str, np.ndarray]
BF16_RECORD = np.dtype("V2")  # what np.load gives for a JAX bf16 leaf


def is_bf16_record(value) -> bool:
    """A 2-byte void array: a bf16 leaf as np.load gives it (or an
    ml_dtypes bfloat16 array, whose numpy kind is void too)."""
    dt = np.asarray(value).dtype
    return dt.kind == "V" and dt.itemsize == 2


def to_torch(value) -> torch.Tensor:
    """A host array as a torch tensor in the dtype JAX would hold it in:
    bf16 records become torch.bfloat16 bit for bit, and float64 becomes
    float32 (jnp.asarray's canonical dtype while x64 is off)."""
    arr = np.asarray(value)
    if is_bf16_record(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    return t.float() if t.dtype == torch.float64 else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy: bf16 as `|V2` records (the inverse of
    to_torch), every other dtype as itself."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def _ln(prefix: str, p: dict, layer=None) -> StateDict:
    g, b = np.asarray(p["g"]), np.asarray(p["b"])
    if layer is not None:
        g, b = g[layer], b[layer]
    return {f"{prefix}.weight": g, f"{prefix}.bias": b}


def _lin(prefix: str, w, b=None, layer=None) -> StateDict:
    if is_quantized(w):
        q, sc = np.asarray(w["q"]), np.asarray(w["s"])
        if layer is not None:
            q, sc = q[layer], sc[layer]
        out = {f"{prefix}.q": q.T, f"{prefix}.s": sc}
    else:
        w = np.asarray(w)
        out = {f"{prefix}.weight": (w[layer] if layer is not None else w).T}
    if b is not None:
        b = np.asarray(b)
        out[f"{prefix}.bias"] = b[layer] if layer is not None else b
    return out


def vit_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.vit params -> clipcap_tpu_torch.models.vit.ViT."""
    sd = _lin("patch", params["patch"]["w"], params["patch"].get("b"))
    sd["cls"] = np.asarray(params["cls"])
    sd["pos"] = np.asarray(params["pos"])
    if "ln_pre" in params:
        sd.update(_ln("ln_pre", params["ln_pre"]))
    sd.update(_ln("ln_post", params["ln_post"]))
    if "proj" in params:
        sd["proj"] = np.asarray(params["proj"])  # used as x @ proj in both
    blocks = params["blocks"]
    for i in range(np.asarray(blocks["ln1"]["g"]).shape[0]):
        p = f"blocks.{i}"
        sd.update(_ln(f"{p}.ln1", blocks["ln1"], i))
        sd.update(_ln(f"{p}.ln2", blocks["ln2"], i))
        sd.update(_lin(f"{p}.qkv", blocks["attn"]["wqkv"], blocks["attn"]["bqkv"], i))
        sd.update(_lin(f"{p}.out", blocks["attn"]["wo"], blocks["attn"]["bo"], i))
        sd.update(_lin(f"{p}.fc1", blocks["mlp"]["w1"], blocks["mlp"]["b1"], i))
        sd.update(_lin(f"{p}.fc2", blocks["mlp"]["w2"], blocks["mlp"]["b2"], i))
    return sd


def mapper_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.mapper params -> clipcap_tpu_torch.models.mapper.Mapper."""
    sd = _lin("linear", params["linear"]["w"], params["linear"]["b"])
    sd["prefix_const"] = np.asarray(params["prefix_const"])
    if "pos_embeddings" in params:
        sd["pos_embeddings"] = np.asarray(params["pos_embeddings"])
    layers = params["layers"]
    for i in range(np.asarray(layers["ln1"]["g"]).shape[0]):
        p = f"layers.{i}"
        sd.update(_ln(f"{p}.ln1", layers["ln1"], i))
        sd.update(_ln(f"{p}.ln2", layers["ln2"], i))
        sd.update(_lin(f"{p}.wq", layers["attn"]["wq"], layer=i))
        sd.update(_lin(f"{p}.wkv", layers["attn"]["wkv"], layer=i))
        sd.update(_lin(f"{p}.wo", layers["attn"]["wo"], layers["attn"]["bo"], i))
        sd.update(_lin(f"{p}.fc1", layers["mlp"]["w1"], layers["mlp"]["b1"], i))
        sd.update(_lin(f"{p}.fc2", layers["mlp"]["w2"], layers["mlp"]["b2"], i))
    return sd


def moe_mapper_from_jax(params: dict) -> StateDict:
    """clipcap_tpu.models.moe params (the dense mapper's tree with each
    layer's mlp an expert bank {gate: {w}, w1, b1, w2, b2} stacked on [L])
    -> clipcap_tpu_torch.models.moe.MoEMapper. The banks keep JAX's
    layout; the rest converts as mapper_state_dict does."""
    layers = params["layers"]
    n = np.asarray(layers["ln1"]["g"]).shape[0]
    sd = _lin("linear", params["linear"]["w"], params["linear"]["b"])
    sd["prefix_const"] = np.asarray(params["prefix_const"])
    if "pos_embeddings" in params:
        sd["pos_embeddings"] = np.asarray(params["pos_embeddings"])
    mlp = layers["mlp"]
    for i in range(n):
        p = f"layers.{i}"
        sd.update(_ln(f"{p}.ln1", layers["ln1"], i))
        sd.update(_ln(f"{p}.ln2", layers["ln2"], i))
        sd.update(_lin(f"{p}.wq", layers["attn"]["wq"], layer=i))
        sd.update(_lin(f"{p}.wkv", layers["attn"]["wkv"], layer=i))
        sd.update(_lin(f"{p}.wo", layers["attn"]["wo"], layers["attn"]["bo"], i))
        sd[f"{p}.mlp.gate"] = np.asarray(mlp["gate"]["w"])[i]
        for leaf in ("w1", "b1", "w2", "b2"):
            sd[f"{p}.mlp.{leaf}"] = np.asarray(mlp[leaf])[i]
    return sd


def gpt2_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.gpt2 params -> clipcap_tpu_torch.models.gpt2.GPT2."""
    sd = {"wte": np.asarray(params["wte"]), "wpe": np.asarray(params["wpe"])}
    sd.update(_ln("ln_f", params["ln_f"]))
    blocks = params["blocks"]
    for i in range(np.asarray(blocks["ln1"]["g"]).shape[0]):
        p = f"blocks.{i}"
        sd.update(_ln(f"{p}.ln1", blocks["ln1"], i))
        sd.update(_ln(f"{p}.ln2", blocks["ln2"], i))
        attn, mlp = blocks["attn"], blocks["mlp"]
        sd.update(_lin(f"{p}.c_attn", attn["c_attn"]["w"], attn["c_attn"]["b"], i))
        sd.update(_lin(f"{p}.c_proj", attn["c_proj"]["w"], attn["c_proj"]["b"], i))
        sd.update(_lin(f"{p}.c_fc", mlp["c_fc"]["w"], mlp["c_fc"]["b"], i))
        sd.update(_lin(f"{p}.mlp_proj", mlp["c_proj"]["w"], mlp["c_proj"]["b"], i))
    if "lm_head" in params:  # the int8 tree (gpt2.quantize_params)
        head = _lin("lm_head", params["lm_head"])
        extra = -head["lm_head.q"].shape[0] % CHANNEL_ALIGN
        sd["lm_head.q"] = np.pad(head["lm_head.q"], ((0, extra), (0, 0)))
        sd["lm_head.s"] = np.pad(head["lm_head.s"], (0, extra), constant_values=np.float32(1e-12))
    return sd


def gptj_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.gptj params (float, or gptj.quantize_params'
    int8 tree) -> clipcap_tpu_torch.models.gptj.GPTJ (or GPTJInt8)."""
    sd = {"wte": np.asarray(params["wte"])}
    sd.update(_ln("ln_f", params["ln_f"]))
    sd.update(_lin("lm_head", params["lm_head"]["w"], params["lm_head"]["b"]))
    blocks = params["blocks"]
    attn, mlp = blocks["attn"], blocks["mlp"]
    for i in range(np.asarray(blocks["ln1"]["g"]).shape[0]):
        p = f"blocks.{i}"
        sd.update(_ln(f"{p}.ln1", blocks["ln1"], i))
        for name in ("wq", "wk", "wv", "wo"):
            sd.update(_lin(f"{p}.{name}", attn[name], layer=i))
        sd.update(_lin(f"{p}.w_in", mlp["w_in"], mlp["b_in"], i))
        sd.update(_lin(f"{p}.w_out", mlp["w_out"], mlp["b_out"], i))
    return sd


_T5_BLOCKS = {"encoder": ("ln1", "attn", "ln2", "mlp"),
              "decoder": ("ln1", "self_attn", "ln2", "cross_attn", "ln3", "mlp")}


def t5_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.t5 params (float, or t5.quantize_params' int8
    tree) -> clipcap_tpu_torch.models.t5.T5 (or T5Int8)."""
    sd = {"shared": np.asarray(params["shared"])}
    for stack, parts in _T5_BLOCKS.items():
        p = params[stack]
        sd[f"{stack}.rel_bias"] = np.asarray(p["rel_bias"])
        sd[f"{stack}.ln_f.weight"] = np.asarray(p["ln_f"]["g"])
        blocks = p["blocks"]
        for i in range(np.asarray(blocks["ln1"]["g"]).shape[0]):
            for part in parts:
                name = f"{stack}.blocks.{i}.{part}"
                if part.startswith("ln"):
                    sd[f"{name}.weight"] = np.asarray(blocks[part]["g"])[i]
                else:
                    for lin, w in blocks[part].items():
                        sd.update(_lin(f"{name}.{lin}", w, layer=i))
    if "lm_head" in params:
        sd.update(_lin("lm_head", params["lm_head"]["w"]))
    return sd


def lm_state_dict(params: dict, lm_type: str = "gpt2") -> StateDict:
    """The LM converter of `lm_type` (gpt2, gptj or t5)."""
    from .lm.registry import family

    return family(lm_type).state_dict(params)


def clip_text_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.clip_text params -> clipcap_tpu_torch.models.clip_text.CLIPText."""
    sd = {"token_embedding": np.asarray(params["token_embedding"]),
          "pos": np.asarray(params["pos"]),
          "text_projection": np.asarray(params["text_projection"])}
    sd.update(_ln("ln_final", params["ln_final"]))
    blocks = params["blocks"]
    for i in range(np.asarray(blocks["ln1"]["g"]).shape[0]):
        p = f"blocks.{i}"
        sd.update(_ln(f"{p}.ln1", blocks["ln1"], i))
        sd.update(_ln(f"{p}.ln2", blocks["ln2"], i))
        sd.update(_lin(f"{p}.qkv", blocks["attn"]["wqkv"], blocks["attn"]["bqkv"], i))
        sd.update(_lin(f"{p}.out", blocks["attn"]["wo"], blocks["attn"]["bo"], i))
        sd.update(_lin(f"{p}.fc1", blocks["mlp"]["w1"], blocks["mlp"]["b1"], i))
        sd.update(_lin(f"{p}.fc2", blocks["mlp"]["w2"], blocks["mlp"]["b2"], i))
    return sd


_BLIP_ATTN = {"self": "self_attn", "cross": "cross_attn"}


def blip_text_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.blip_text params (float, or blip_text.quantize_params'
    int8 tree) -> clipcap_tpu_torch.models.blip_text.BlipText. An int8 head
    ([D, V]) is padded to the port's multiple-of-8 channels with q = 0,
    s = 1e-12 and a zero bias, as the port's quantize_params pads it."""
    sd = {"word_embeddings": np.asarray(params["word_embeddings"]),
          "position_embeddings": np.asarray(params["position_embeddings"])}
    sd.update(_ln("emb_ln", params["emb_ln"]))
    blocks = params["blocks"]
    for i in range(np.asarray(blocks["mlp"]["ln"]["g"]).shape[0]):
        p = f"blocks.{i}"
        for src, dst in _BLIP_ATTN.items():
            a = blocks[src]
            for name in ("q", "k", "v", "o"):
                sd.update(_lin(f"{p}.{dst}.w{name}", a[f"w{name}"], a[f"b{name}"], i))
            sd.update(_ln(f"{p}.{dst}.ln", a["ln"], i))
        mlp = blocks["mlp"]
        sd.update(_lin(f"{p}.mlp.fc1", mlp["w1"], mlp["b1"], i))
        sd.update(_lin(f"{p}.mlp.fc2", mlp["w2"], mlp["b2"], i))
        sd.update(_ln(f"{p}.mlp.ln", mlp["ln"], i))
    if "cls" in params:
        cls = params["cls"]
        sd.update(_lin("cls_transform", cls["transform"]["w"], cls["transform"]["b"]))
        sd.update(_ln("cls_ln", cls["transform_ln"]))
        head = _lin("cls_decoder", cls["decoder"]["w"], cls["decoder"]["b"])
        if "cls_decoder.q" in head:
            extra = -head["cls_decoder.q"].shape[0] % CHANNEL_ALIGN
            head["cls_decoder.q"] = np.pad(head["cls_decoder.q"], ((0, extra), (0, 0)))
            head["cls_decoder.s"] = np.pad(head["cls_decoder.s"], (0, extra),
                                           constant_values=np.float32(1e-12))
            head["cls_decoder.bias"] = np.pad(head["cls_decoder.bias"], (0, extra))
        sd.update(head)
    return sd


def blip_retrieval_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.blip_retrieval params {"visual", "text",
    "vision_proj", "text_proj", "itm_head"} ->
    clipcap_tpu_torch.models.blip_retrieval.BlipRetrieval. The text
    encoder has no MLM head in the port: a "cls" subtree (JAX's random init
    carries one, which no ranking reads) is left out."""
    sd = {f"visual.{k}": v for k, v in vit_state_dict(params["visual"]).items()}
    text = {k: v for k, v in params["text"].items() if k != "cls"}
    sd.update({f"text.{k}": v for k, v in blip_text_state_dict(text).items()})
    for name in ("vision_proj", "text_proj", "itm_head"):
        sd.update(_lin(name, params[name]["w"], params[name]["b"]))
    return sd


def _bn(prefix: str, p: dict) -> StateDict:
    return {f"{prefix}.weight": np.asarray(p["g"]), f"{prefix}.bias": np.asarray(p["b"]),
            f"{prefix}.running_mean": np.asarray(p["mean"]),
            f"{prefix}.running_var": np.asarray(p["var"])}


def clip_resnet_state_dict(params: dict) -> StateDict:
    """clipcap_tpu.models.clip_resnet params -> clipcap_tpu_torch.models.
    clip_resnet.ModifiedResNet (OpenAI's `visual.*` names without the
    prefix; conv weights OIHW in both)."""
    sd = {}
    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = np.asarray(params[f"conv{i}"])
        sd.update(_bn(f"bn{i}", params[f"bn{i}"]))
    for stage in range(1, 5):
        for j, blk in enumerate(params[f"layer{stage}"]):
            p = f"layer{stage}.{j}"
            for i in (1, 2, 3):
                sd[f"{p}.conv{i}.weight"] = np.asarray(blk[f"conv{i}"])
                sd.update(_bn(f"{p}.bn{i}", blk[f"bn{i}"]))
            if "downsample" in blk:
                sd[f"{p}.downsample.0.weight"] = np.asarray(blk["downsample"]["conv"])
                sd.update(_bn(f"{p}.downsample.1", blk["downsample"]["bn"]))
    ap = params["attnpool"]
    sd["attnpool.positional_embedding"] = np.asarray(ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd.update(_lin(f"attnpool.{name}", ap[name]["w"], ap[name]["b"]))
    return sd


def captioner_state_dict(params: dict, lm_type: str = "gpt2") -> StateDict:
    """clipcap_tpu.models.captioner params {"mapper", "lm", ["visual"]} ->
    clipcap_tpu_torch.models.captioner.Captioner with a GPT-2, GPT-J or T5 LM."""
    sd = {f"mapper.{k}": v for k, v in mapper_state_dict(params["mapper"]).items()}
    sd.update({f"lm.{k}": v for k, v in lm_state_dict(params["lm"], lm_type).items()})
    if "visual" in params:
        sd.update({f"visual.{k}": v for k, v in vit_state_dict(params["visual"]).items()})
    return sd


# --- the port's modules -> the JAX pytree layout ------------------------------------------


def _unln(sd: StateDict, fmt: str, n: int) -> dict:
    return {"g": np.stack([sd[fmt.format(i) + ".weight"] for i in range(n)]),
            "b": np.stack([sd[fmt.format(i) + ".bias"] for i in range(n)])}


def _flat_w(sd: StateDict, name: str):
    """The [in, out] weight of the nn.Linear `name`, or the {"q", "s"} leaf
    of the Int8Linear so named."""
    if name + ".q" in sd:
        return {"q": sd[name + ".q"].T, "s": sd[name + ".s"]}
    return sd[name + ".weight"].T


def _unw(sd: StateDict, fmt: str, n: int):
    """Stacked [L, in, out] weights (or quantized leaves) of the linears
    named fmt.format(i)."""
    ws = [_flat_w(sd, fmt.format(i)) for i in range(n)]
    if isinstance(ws[0], dict):
        return {key: np.stack([w[key] for w in ws]) for key in ("q", "s")}
    return np.stack(ws)


def _unb(sd: StateDict, fmt: str, n: int) -> np.ndarray:
    return np.stack([sd[fmt.format(i) + ".bias"] for i in range(n)])


def _flat_ln(sd: StateDict, name: str) -> dict:
    return {"g": sd[name + ".weight"], "b": sd[name + ".bias"]}


def vit_params(sd: StateDict, layers: int) -> dict:
    """Inverse of vit_state_dict."""
    blk = "blocks.{}."
    params = {"patch": {"w": _flat_w(sd, "patch")}, "cls": sd["cls"], "pos": sd["pos"],
              "ln_post": _flat_ln(sd, "ln_post"),
              "blocks": {"ln1": _unln(sd, blk + "ln1", layers),
                         "ln2": _unln(sd, blk + "ln2", layers),
                         "attn": {"wqkv": _unw(sd, blk + "qkv", layers),
                                  "bqkv": _unb(sd, blk + "qkv", layers),
                                  "wo": _unw(sd, blk + "out", layers),
                                  "bo": _unb(sd, blk + "out", layers)},
                         "mlp": {"w1": _unw(sd, blk + "fc1", layers),
                                 "b1": _unb(sd, blk + "fc1", layers),
                                 "w2": _unw(sd, blk + "fc2", layers),
                                 "b2": _unb(sd, blk + "fc2", layers)}}}
    if "patch.bias" in sd:
        params["patch"]["b"] = sd["patch.bias"]
    if "ln_pre.weight" in sd:
        params["ln_pre"] = _flat_ln(sd, "ln_pre")
    if "proj" in sd:
        params["proj"] = sd["proj"]
    return params


def mapper_params(sd: StateDict, layers: int) -> dict:
    """Inverse of mapper_state_dict."""
    lay = "layers.{}."
    params = {"linear": {"w": sd["linear.weight"].T, "b": sd["linear.bias"]},
              "prefix_const": sd["prefix_const"],
              "layers": {"ln1": _unln(sd, lay + "ln1", layers),
                         "ln2": _unln(sd, lay + "ln2", layers),
                         "attn": {"wq": _unw(sd, lay + "wq", layers),
                                  "wkv": _unw(sd, lay + "wkv", layers),
                                  "wo": _unw(sd, lay + "wo", layers),
                                  "bo": _unb(sd, lay + "wo", layers)},
                         "mlp": {"w1": _unw(sd, lay + "fc1", layers),
                                 "b1": _unb(sd, lay + "fc1", layers),
                                 "w2": _unw(sd, lay + "fc2", layers),
                                 "b2": _unb(sd, lay + "fc2", layers)}}}
    if "pos_embeddings" in sd:
        params["pos_embeddings"] = sd["pos_embeddings"]
    return params


def gpt2_params(sd: StateDict, layers: int) -> dict:
    """Inverse of gpt2_state_dict."""
    blk = "blocks.{}."

    def lin(name):
        return {"w": _unw(sd, blk + name, layers), "b": _unb(sd, blk + name, layers)}

    params = {"wte": sd["wte"], "wpe": sd["wpe"], "ln_f": _flat_ln(sd, "ln_f"),
              "blocks": {"ln1": _unln(sd, blk + "ln1", layers),
                         "ln2": _unln(sd, blk + "ln2", layers),
                         "attn": {"c_attn": lin("c_attn"), "c_proj": lin("c_proj")},
                         "mlp": {"c_fc": lin("c_fc"), "c_proj": lin("mlp_proj")}}}
    if "lm_head.q" in sd:  # the int8 module: its padded channels dropped
        vocab = sd["wte"].shape[0]
        params["lm_head"] = {"q": sd["lm_head.q"][:vocab].T, "s": sd["lm_head.s"][:vocab]}
    return params


def gptj_params(sd: StateDict, layers: int) -> dict:
    """Inverse of gptj_state_dict (float or int8)."""
    blk = "blocks.{}."
    return {"wte": sd["wte"], "ln_f": _flat_ln(sd, "ln_f"),
            "lm_head": {"w": _flat_w(sd, "lm_head"), "b": sd["lm_head.bias"]},
            "blocks": {"ln1": _unln(sd, blk + "ln1", layers),
                       "attn": {name: _unw(sd, blk + name, layers)
                                for name in ("wq", "wk", "wv", "wo")},
                       "mlp": {"w_in": _unw(sd, blk + "w_in", layers),
                               "b_in": _unb(sd, blk + "w_in", layers),
                               "w_out": _unw(sd, blk + "w_out", layers),
                               "b_out": _unb(sd, blk + "w_out", layers)}}}


def t5_params(sd: StateDict, layers: int = None) -> dict:
    """Inverse of t5_state_dict. `layers` is not read: the encoder and the
    decoder each count their blocks from the state dict."""
    params = {"shared": sd["shared"]}
    for stack, parts in _T5_BLOCKS.items():
        n = len({k.split(".")[2] for k in sd if k.startswith(f"{stack}.blocks.")})
        blk = f"{stack}.blocks.{{}}."
        blocks = {}
        for part in parts:
            if part.startswith("ln"):
                blocks[part] = {"g": np.stack([sd[blk.format(i) + part + ".weight"]
                                               for i in range(n)])}
            else:
                lins = sorted({k[len(blk.format(0) + part) + 1:].split(".")[0]
                               for k in sd if k.startswith(blk.format(0) + part + ".")})
                blocks[part] = {lin: _unw(sd, blk + f"{part}.{lin}", n) for lin in lins}
        params[stack] = {"blocks": blocks, "rel_bias": sd[f"{stack}.rel_bias"],
                         "ln_f": {"g": sd[f"{stack}.ln_f.weight"]}}
    if "lm_head.weight" in sd or "lm_head.q" in sd:
        params["lm_head"] = {"w": _flat_w(sd, "lm_head")}
    return params


def lm_params(sd: StateDict, layers: int, lm_type: str = "gpt2") -> dict:
    """Inverse of lm_state_dict."""
    from .lm.registry import family

    return family(lm_type).params(sd, layers)


def captioner_params(model: nn.Module) -> dict:
    """A port Captioner (GPT-2, GPT-J or T5 LM, by its cfg.lm_type) -> the JAX
    package's captioner params {"mapper", "lm", ["visual"]}, numpy on the
    host (bf16 as `|V2` records): the inverse of captioner_state_dict."""
    sd = {k: to_numpy(v) for k, v in model.state_dict().items()}

    def sub(prefix):
        return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}

    lm_layers = len(model.lm.blocks) if hasattr(model.lm, "blocks") else None  # T5: two stacks
    params = {"mapper": mapper_params(sub("mapper"), len(model.mapper.layers)),
              "lm": lm_params(sub("lm"), lm_layers, model.cfg.lm_type)}
    if model.visual is not None:
        params["visual"] = vit_params(sub("visual"), len(model.visual.blocks))
    return params


def load(module: nn.Module, state: StateDict) -> nn.Module:
    """Copy a converted state dict into `module` (strict: every parameter
    must be given, with its shape). The module keeps its device; each
    floating parameter takes the dtype its value was stored in (to_torch's:
    bf16 stays bf16), as JAX keeps each leaf's stored dtype, so a module
    built in f32 and loaded from bf16 values computes in bf16."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"converted params do not match the module: missing {missing}, "
                       f"unexpected {extra}")
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, value in state.items():
            t = _to_device(value, own[name].device)
            if tuple(t.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(own[name].shape)}")
            if name in params and t.is_floating_point() and t.dtype != own[name].dtype:
                params[name].data = t
            else:
                own[name].copy_(t)
    return module


def _to_device(value, device) -> torch.Tensor:
    """to_torch(value), contiguous on `device`. A transposed view of a
    contiguous array (the [in, out] -> [out, in] weights) crosses to the
    device as that array and is transposed there: a transposing copy on
    the host is several times slower than a plain one, and at GPT-J's
    width it took most of a checkpoint's load."""
    arr = np.asarray(value)
    if arr.ndim == 2 and not arr.flags.c_contiguous and arr.T.flags.c_contiguous:
        return to_torch(arr.T).to(device).t().contiguous()
    return to_torch(arr).to(device)
