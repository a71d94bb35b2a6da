"""Model loading for the CLIs (port of clipcap_tpu/cli/loading.py:
load_state_dict, load_clip_ranker (ViT and ResNet towers),
load_blip_captioner, load_captioner_bundle; the towers and the captioner
also load without their tokenizers).

Every loader takes local paths and downloads nothing: torch .pth/.bin
state dicts and .npz dumps (converted by tools/import_weights), the port's
checkpoint directories (train/checkpoints.py), and tokenizer files. Each
builds its modules on `device`, the card unless asked for the CPU.
"""

from __future__ import annotations

import numpy as np

from ..core.config import BlipTextConfig, CaptionerConfig, CLIPTextConfig, ViTConfig
from ..lm.registry import get_lm_config


def load_state_dict(path: str) -> dict:
    """A torch .pth/.bin or numpy .npz state dict as {name: array}.
    Torch files load with weights_only=True: tensors and plain containers,
    no arbitrary pickled objects."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return obj


def _layers(sd: dict, prefix: str, at: int) -> int:
    """The number of distinct layer indices at dotted position `at` of the
    keys under `prefix`."""
    return len({k.split(".")[at] for k in sd if k.startswith(prefix)})


def _openai_text_cfg(sd: dict) -> CLIPTextConfig:
    """The text tower's config of an OpenAI CLIP checkpoint, from its shapes."""
    width = np.asarray(sd["ln_final.weight"]).shape[0]
    return CLIPTextConfig(
        vocab_size=np.asarray(sd["token_embedding.weight"]).shape[0], width=width,
        layers=_layers(sd, "transformer.resblocks.", 2), heads=width // 64,
        output_dim=np.asarray(sd["text_projection"]).shape[1])


def load_clip_towers(clip_model: str, checkpoint: str, device: str = "cuda"):
    """CLIP's image and text towers on `device`: for an "RN..." model the
    ModifiedResNet (models.clip_resnet, its config from the checkpoint's
    shapes, as clip.load derives it) from an OpenAI state dict; else the
    ViT (models.vit.ViT) from an OpenAI (keys `visual.*`) or HF state dict.
    The text tower is models.clip_text.CLIPText."""
    from .. import convert
    from ..models.clip_resnet import ModifiedResNet
    from ..models.clip_text import CLIPText
    from ..models.vit import ViT
    from ..tools import import_weights as W

    sd = load_state_dict(checkpoint)
    if clip_model.startswith("RN"):
        rn_cfg = W.clip_resnet_config_from_state_dict(sd)
        text_cfg = _openai_text_cfg(sd)
        visual = convert.load(ModifiedResNet(rn_cfg, device=device),
                              W.clip_resnet_from_openai_state_dict(sd, rn_cfg))
        text_sd = W.clip_text_from_openai_state_dict(sd, text_cfg)
        return visual, convert.load(CLIPText(text_cfg, device=device), text_sd)
    vit_cfg = ViTConfig.clip_variant(clip_model)
    if any(k.startswith("visual.") for k in sd):
        text_cfg = _openai_text_cfg(sd)
        vit_sd = W.clip_vit_from_openai_state_dict(sd, vit_cfg)
        text_sd = W.clip_text_from_openai_state_dict(sd, text_cfg)
    else:
        width = np.asarray(sd["text_model.final_layer_norm.weight"]).shape[0]
        text_cfg = CLIPTextConfig(
            vocab_size=np.asarray(sd["text_model.embeddings.token_embedding.weight"]).shape[0],
            width=width, layers=_layers(sd, "text_model.encoder.layers.", 3),
            heads=width // 64, output_dim=np.asarray(sd["text_projection.weight"]).shape[0])
        vit_sd = W.clip_vit_from_hf_state_dict(sd, vit_cfg)
        text_sd = W.clip_text_from_hf_state_dict(sd, text_cfg)
    return (convert.load(ViT(vit_cfg, device=device), vit_sd),
            convert.load(CLIPText(text_cfg, device=device), text_sd))


def load_clip_ranker(clip_model: str, checkpoint: str, merges_path: str, device: str = "cuda"):
    """A CLIPRanker from a CLIP state dict (OpenAI or HF for a ViT, OpenAI
    for an "RN..." ResNet) and CLIP's merges file."""
    from ..rank.rankers import CLIPRanker
    from ..tokenizers.clip_bpe import CLIPTokenizer

    visual, text = load_clip_towers(clip_model, checkpoint, device=device)
    return CLIPRanker(visual, text, CLIPTokenizer.from_merges_file(merges_path))


def load_blip_captioner(checkpoint: str, vocab_file: str, vit_variant: str = "ViT-L",
                        image_size: int = 384, device: str = "cuda"):
    """A BLIP caption checkpoint (HF BlipForConditionalGeneration's state
    dict; reference sampling.py:330-343) and its BERT vocab.txt ->
    ({"visual": ViT, "text": BlipText} on `device`, ViTConfig,
    BlipTextConfig, WordPieceTokenizer). The text decoder has bert-base's
    geometry (BlipTextConfig's defaults) and cross-attends the ViT's
    width, as JAX's loader builds it."""
    from .. import convert
    from ..models.blip_text import BlipText
    from ..models.vit import ViT
    from ..tokenizers.wordpiece import WordPieceTokenizer
    from ..tools import import_weights as W

    sd = load_state_dict(checkpoint)
    vit_cfg = ViTConfig.blip_variant(vit_variant, image_size=image_size)
    text_cfg = BlipTextConfig(encoder_width=vit_cfg.width)
    params = {"visual": convert.load(ViT(vit_cfg, device=device),
                                     W.blip_vit_from_hf_state_dict(sd, vit_cfg)),
              "text": convert.load(BlipText(text_cfg, device=device),
                                   W.blip_text_from_hf_state_dict(sd, text_cfg,
                                                                  prefix="text_decoder."))}
    return params, vit_cfg, text_cfg, WordPieceTokenizer.from_vocab_file(vocab_file)


def load_captioner(checkpoint_path: str, device: str = "cuda"):
    """A trained ClipCap checkpoint (a directory of clipcap_config.json and
    consolidated.npz, train/checkpoints.py) -> (Captioner on `device`,
    CaptionerConfig, LM config, ViTConfig or None).

    Each submodule (mapper, LM, visual) is built in the dtype its leaves
    were stored in, so a bf16 checkpoint computes in bf16, and an f32
    mapper beside a bf16 LM stays so. A submodule whose own leaves mix
    float dtypes runs in f32, its bf16 leaves widened exactly: JAX keeps
    each leaf's dtype and promotes op by op (bf16 with f32 gives f32), so
    there every product that meets an f32 leaf runs in f32 too."""
    from .. import convert
    from ..models.captioner import Captioner
    from ..train.checkpoints import load_config, read_params

    payload = load_config(checkpoint_path)
    cap_cfg = CaptionerConfig.from_dict(payload["captioner"])
    lm_cfg = get_lm_config(cap_cfg.lm_type, cap_cfg.lm_variant).from_dict(payload["lm"])
    params = read_params(checkpoint_path)
    vit_cfg = None
    if "visual" in params:
        if cap_cfg.visual_encoder_type.upper() == "BLIP":
            vit_cfg = ViTConfig.blip_variant(cap_cfg.visual_encoder_variant)
        else:
            vit_cfg = ViTConfig.clip_variant(cap_cfg.visual_encoder_variant)
    model = Captioner(cap_cfg, lm_cfg, vit_cfg=vit_cfg, device=device)
    convert.load(model, convert.captioner_state_dict(params, cap_cfg.lm_type))
    for sub in (model.mapper, model.lm, model.visual):
        if sub is not None and len({p.dtype for p in sub.parameters()}) > 1:
            sub.float()
    return model, cap_cfg, lm_cfg, vit_cfg


def load_captioner_bundle(checkpoint_path: str, tokenizer_vocab_dir: str,
                          prefix_only: bool = False, device: str = "cuda"):
    """A trained ClipCap checkpoint and its LM's tokenizer files ->
    CaptionerBundle on `device`. `prefix_only` is JAX's keyword: it
    affects training only and is ignored here, as in JAX."""
    from ..models.bundle import CaptionerBundle
    from ..tokenizers import create_tokenizer

    model, cap_cfg, lm_cfg, vit_cfg = load_captioner(checkpoint_path, device=device)
    return CaptionerBundle(model, cap_cfg, lm_cfg,
                           create_tokenizer(cap_cfg.lm_type, tokenizer_vocab_dir),
                           vit_cfg=vit_cfg, device=device)
