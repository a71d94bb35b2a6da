"""The port's weight converters (tools/import_weights.py) against HF's own
models and the JAX package's converters: random HF GPT2LMHeadModel and
CLIPModel built from small configs (nothing is downloaded) give, through
the port, HF's logits and features and those of JAX's import_weights; the
OpenAI CLIP layout and the reference mapper layout, as seeded numpy dicts
with the key names the JAX converters read, give JAX's features. f32,
atol = rtol = 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import clip_text as JT
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu.models import mapper as JM
from clipcap_tpu.models import vit as JV
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.clip_text import CLIPText
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.models.mapper import Mapper
from clipcap_tpu_torch.models.vit import ViT
from clipcap_tpu_torch.tools import import_weights as TW

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(autouse=True)
def _no_tensorflow(monkeypatch):
    """transformers would import TensorFlow, where installed, for nothing here."""
    monkeypatch.setenv("USE_TF", "0")


def test_gpt2_from_hf_state_dict():
    from transformers import GPT2Config as HFConfig
    from transformers import GPT2LMHeadModel

    cfg = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=4)
    torch.manual_seed(0)
    hf = GPT2LMHeadModel(HFConfig(**cfg, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
                                  attn_implementation="eager")).eval()
    sd = hf.state_dict()
    model = convert.load(GPT2(TC.GPT2Config(**cfg), device="cpu"),
                         TW.gpt2_from_state_dict(sd, TC.GPT2Config(**cfg)))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 7, 32)).astype(np.float32))
    with torch.no_grad():
        got = model(x)
        want_hf = hf(inputs_embeds=x).logits
    _close(got, want_hf.numpy())
    want_jax = JG.apply(JW.gpt2_from_state_dict(sd, JC.GPT2Config(**cfg)), JC.GPT2Config(**cfg),
                        jnp.asarray(x.numpy()))
    _close(got, want_jax)
    # a bare GPT2Model state dict (no "transformer." prefix) converts too
    bare = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    assert all(np.array_equal(a, b) for a, b in zip(
        TW.gpt2_from_state_dict(bare, TC.GPT2Config(**cfg)).values(),
        TW.gpt2_from_state_dict(sd, TC.GPT2Config(**cfg)).values()))


VIS = dict(image_size=32, patch_size=16, width=32, layers=2, heads=4, output_dim=16)
TXT = dict(vocab_size=60, context_length=12, width=32, layers=2, heads=4, output_dim=16)


def _tokens():
    """Zero-padded rows whose eot (the largest id) ends each caption."""
    toks = np.zeros((3, TXT["context_length"]), np.int64)
    for r, n in enumerate((4, 7, 12)):
        toks[r, :n] = np.random.default_rng(r).integers(1, TXT["vocab_size"] - 1, n)
        toks[r, n - 1] = TXT["vocab_size"] - 1
    return toks


def _pixels():
    return np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(np.float32)


def test_clip_from_hf_state_dict():
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config=dict(vocab_size=TXT["vocab_size"], hidden_size=32, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=TXT["context_length"], eos_token_id=2),
        vision_config=dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, image_size=32, patch_size=16),
        projection_dim=16)
    torch.manual_seed(1)
    hf = CLIPModel(cfg).eval()
    sd = hf.state_dict()
    vit_cfg, text_cfg = TC.ViTConfig(**VIS), TC.CLIPTextConfig(**TXT)
    visual = convert.load(ViT(vit_cfg, device="cpu"), TW.clip_vit_from_hf_state_dict(sd, vit_cfg))
    text = convert.load(CLIPText(text_cfg, device="cpu"),
                        TW.clip_text_from_hf_state_dict(sd, text_cfg))
    px, toks = _pixels(), _tokens()
    with torch.no_grad():
        img = visual(torch.from_numpy(px))
        txt = text(torch.from_numpy(toks))
        _close(img, hf.get_image_features(pixel_values=torch.from_numpy(px)).numpy())
        _close(txt, hf.get_text_features(input_ids=torch.from_numpy(toks)).numpy())
    jv, jt = JC.ViTConfig(**VIS), JC.CLIPTextConfig(**TXT)
    _close(img, JV.apply(JW.clip_vit_from_hf_state_dict(sd, jv), jv, jnp.asarray(px),
                         output="pooled"))
    _close(txt, JT.apply(JW.clip_text_from_hf_state_dict(sd, jt), jt, jnp.asarray(toks)))


def openai_clip_state_dict(vis: dict, txt: dict, seed: int = 0) -> dict:
    """A seeded OpenAI-layout CLIP state dict (the keys and shapes that
    clip_vit_from_openai_state_dict / clip_text_from_openai_state_dict read)."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.05):
        return (rng.normal(size=shape) * s).astype(np.float32)

    def blocks(prefix, d, n):
        out = {}
        for i in range(n):
            p = f"{prefix}transformer.resblocks.{i}."
            out.update({p + "ln_1.weight": 1 + w(d), p + "ln_1.bias": w(d),
                        p + "attn.in_proj_weight": w(3 * d, d), p + "attn.in_proj_bias": w(3 * d),
                        p + "attn.out_proj.weight": w(d, d), p + "attn.out_proj.bias": w(d),
                        p + "ln_2.weight": 1 + w(d), p + "ln_2.bias": w(d),
                        p + "mlp.c_fc.weight": w(4 * d, d), p + "mlp.c_fc.bias": w(4 * d),
                        p + "mlp.c_proj.weight": w(d, 4 * d), p + "mlp.c_proj.bias": w(d)})
        return out

    d, pch, grid = vis["width"], vis["patch_size"], vis["image_size"] // vis["patch_size"]
    sd = {"visual.conv1.weight": w(d, 3, pch, pch), "visual.class_embedding": w(d),
          "visual.positional_embedding": w(grid * grid + 1, d),
          "visual.ln_pre.weight": 1 + w(d), "visual.ln_pre.bias": w(d),
          "visual.ln_post.weight": 1 + w(d), "visual.ln_post.bias": w(d),
          "visual.proj": w(d, vis["output_dim"], s=d ** -0.5)}
    sd.update(blocks("visual.", d, vis["layers"]))
    t = txt["width"]
    sd.update({"token_embedding.weight": w(txt["vocab_size"], t),
               "positional_embedding": w(txt["context_length"], t, s=0.01),
               "ln_final.weight": 1 + w(t), "ln_final.bias": w(t),
               "text_projection": w(t, txt["output_dim"], s=t ** -0.5)})
    sd.update(blocks("", t, txt["layers"]))
    return sd


def test_clip_from_openai_state_dict():
    sd = openai_clip_state_dict(VIS, TXT)
    vit_cfg, text_cfg = TC.ViTConfig(**VIS), TC.CLIPTextConfig(**TXT)
    visual = convert.load(ViT(vit_cfg, device="cpu"),
                          TW.clip_vit_from_openai_state_dict(sd, vit_cfg))
    text = convert.load(CLIPText(text_cfg, device="cpu"),
                        TW.clip_text_from_openai_state_dict(sd, text_cfg))
    px, toks = _pixels(), _tokens()
    jv, jt = JC.ViTConfig(**VIS), JC.CLIPTextConfig(**TXT)
    with torch.no_grad():
        for mode in ("pooled", "tokens_proj"):
            _close(visual(torch.from_numpy(px), output=mode),
                   JV.apply(JW.clip_vit_from_openai_state_dict(sd, jv), jv, jnp.asarray(px),
                            output=mode))
        _close(text(torch.from_numpy(toks)),
               JT.apply(JW.clip_text_from_openai_state_dict(sd, jt), jt, jnp.asarray(toks)))


@pytest.mark.parametrize("all_features", [False, True])
def test_mapper_from_reference_state_dict(all_features):
    """The reference's torch mapper layout (layers/Transformer.py)."""
    cfg = dict(dim_clip=24, dim_embedding=32, prefix_length=4, clip_length=5, num_layers=2,
               num_heads=4, use_all_features=all_features, use_pos_embeddings=all_features)
    rng = np.random.default_rng(2)

    def w(*shape):
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    d, out = 32, (32 if all_features else 5 * 32)
    sd = {"linear.weight": w(out, 24), "linear.bias": w(out), "prefix_const": w(4, d)}
    if all_features:
        sd["pos_embeddings"] = w(5, d)
    for i in range(2):
        p = f"transformer.layers.{i}."
        sd.update({p + "norm1.weight": 1 + w(d), p + "norm1.bias": w(d),
                   p + "attn.to_queries.weight": w(d, d),
                   p + "attn.to_keys_values.weight": w(2 * d, d),
                   p + "attn.project.weight": w(d, d), p + "attn.project.bias": w(d),
                   p + "norm2.weight": 1 + w(d), p + "norm2.bias": w(d),
                   p + "mlp.fc1.weight": w(4 * d, d), p + "mlp.fc1.bias": w(4 * d),
                   p + "mlp.fc2.weight": w(d, 4 * d), p + "mlp.fc2.bias": w(d)})
    mapper = convert.load(Mapper(TC.MapperConfig(**cfg), device="cpu"),
                          TW.mapper_from_torch_state_dict(sd, TC.MapperConfig(**cfg)))
    x = (rng.normal(size=(3, 5, 24) if all_features else (3, 24))).astype(np.float32)
    with torch.no_grad():
        got = mapper(torch.from_numpy(x))
    jcfg = JC.MapperConfig(**cfg)
    _close(got, JM.apply(JW.mapper_from_torch_state_dict(sd, jcfg), jnp.asarray(x), jcfg))
