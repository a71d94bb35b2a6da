"""CLIP scoring in the port against the JAX package: CLIPText against
clip_text.apply, CLIPTokenizer against JAX's, and ClipScoring
(embed_image, embed_text, score_image) and CLIPRanker.rank against JAX's
on the shapes of tests/test_apps.py's tiny world. f32, atol = rtol = 1e-5."""

import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.eval.clip_scoring import ClipScoring as JaxScoring
from clipcap_tpu.models import clip_text as JT
from clipcap_tpu.rank.rankers import CLIPRanker as JaxRanker
from clipcap_tpu.tokenizers.clip_bpe import CLIPTokenizer as JaxClipTok
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.eval.clip_scoring import ClipScoring
from clipcap_tpu_torch.models.clip_text import CLIPText
from clipcap_tpu_torch.models.vit import ViT
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.rank.rankers import CLIPRanker
from clipcap_tpu_torch.tokenizers.clip_bpe import CLIPTokenizer
from clipcap_tpu_torch.tools import import_weights as TW

from test_torch_import_weights import openai_clip_state_dict

TOL = dict(atol=1e-5, rtol=1e-5)
MERGES = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>")]  # tests/test_apps.py:53
VIT = dict(image_size=32, patch_size=16, width=24, layers=1, heads=4, output_dim=12)
CAPTIONS = ["the cat", "a cat on the bench.", "The  CAT &amp; the   dog!", "x" * 200]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def world():
    """The CLIP half of test_apps.py's world, its weights a seeded
    OpenAI-layout state dict read by the JAX and the port converters."""
    tok_j, tok_t = JaxClipTok(MERGES), CLIPTokenizer(MERGES)
    text = dict(vocab_size=max(tok_j.encoder.values()) + 1, context_length=77, width=24,
                layers=1, heads=4, output_dim=12)
    sd = openai_clip_state_dict(VIT, text, seed=1)
    vit_j, text_j = JC.ViTConfig(**VIT, style="clip"), JC.CLIPTextConfig(**text)
    vit_t, text_t = TC.ViTConfig(**VIT, style="clip"), TC.CLIPTextConfig(**text)
    vit_p = JW.clip_vit_from_openai_state_dict(sd, vit_j)
    text_p = JW.clip_text_from_openai_state_dict(sd, text_j)
    visual = convert.load(ViT(vit_t, device="cpu"), TW.clip_vit_from_openai_state_dict(sd, vit_t))
    text = convert.load(CLIPText(text_t, device="cpu"),
                        TW.clip_text_from_openai_state_dict(sd, text_t))
    jax_scoring = JaxScoring(vit_p, vit_j, text_p, text_j, tok_j)
    jax_ranker = JaxRanker(vit_p, vit_j, text_p, text_j, tok_j)
    return (jax_scoring, jax_ranker, ClipScoring(visual, text, tok_t),
            CLIPRanker(visual, text, tok_t))


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_text_matches_jax():
    cfg = dict(vocab_size=300, context_length=16, width=32, layers=2, heads=4, output_dim=8)
    # a JAX-layout pytree of seeded weights, by JAX's converter
    params = JW.clip_text_from_openai_state_dict(openai_clip_state_dict(VIT, cfg, seed=4),
                                                 JC.CLIPTextConfig(**cfg))
    model = convert.load(CLIPText(TC.CLIPTextConfig(**cfg), device="cpu"),
                         convert.clip_text_state_dict(_tree(params)))
    toks = np.zeros((3, 16), np.int32)
    for r, n in enumerate((3, 9, 16)):
        toks[r, :n] = np.random.default_rng(r).integers(1, 298, n)
        toks[r, n - 1] = 299  # eot: the largest id
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    _close(got, JT.apply(params, JC.CLIPTextConfig(**cfg), jnp.asarray(toks)))
    # the port's own init draws the JAX init's distributions
    fresh = CLIPText(TC.CLIPTextConfig(**cfg), device="cpu", seed=3).requires_grad_(False)
    assert abs(float(fresh.token_embedding.std()) - 0.02) < 2e-3
    assert abs(float(fresh.pos.std()) - 0.01) < 2e-3
    assert abs(float(fresh.text_projection.std()) - 32 ** -0.5) < 0.03


def test_clip_tokenizer_matches_jax(tmp_path):
    tok_j, tok_t = JaxClipTok(MERGES), CLIPTokenizer(MERGES)
    np.testing.assert_array_equal(tok_t.tokenize(CAPTIONS, truncate=True),
                                  tok_j.tokenize(CAPTIONS, truncate=True))
    for c in CAPTIONS[:3]:
        assert tok_t.encode(c) == tok_j.encode(c)
        assert tok_t.decode(tok_t.encode(c)) == tok_j.decode(tok_j.encode(c))
    with pytest.raises(RuntimeError):
        tok_t.tokenize(CAPTIONS[3])
    # from a merges file, plain and gzip, with its version header line
    text = "#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n"
    (tmp_path / "m.txt").write_text(text)
    with gzip.open(tmp_path / "m.txt.gz", "wt", encoding="utf-8") as f:
        f.write(text)
    for name in ("m.txt", "m.txt.gz"):
        a = CLIPTokenizer.from_merges_file(str(tmp_path / name))
        b = JaxClipTok.from_merges_file(str(tmp_path / name))
        assert a.encoder == b.encoder and a.encode("the cat") == b.encode("the cat")


def test_clip_scoring_matches_jax(world):
    from PIL import Image

    jax_scoring, _, scoring, _ = world
    img = Image.fromarray(np.random.default_rng(1).integers(0, 255, (40, 52, 3), dtype=np.uint8))
    px = scoring.preprocess_image(img)
    np.testing.assert_array_equal(px, np.asarray(jax_scoring.preprocess_image(img)))
    with torch.no_grad():
        _close(scoring.embed_image(px), jax_scoring.embed_image(px))
        _close(scoring.embed_text(CAPTIONS[:3]), jax_scoring.embed_text(CAPTIONS[:3]))
        _close(scoring.score_image(img, CAPTIONS[:3]), jax_scoring.score_image(img, CAPTIONS[:3]))
        _close(scoring.score_image(img, "the cat"), jax_scoring.score_image(img, "the cat"))
    with pytest.raises(ValueError):
        scoring.score_tensor(px, scoring.tokenize("a"), method="dot")
    assert FA.LAUNCHES == {"fused_attention": 0}


def test_clip_ranker_matches_jax(world):
    _, jax_ranker, _, ranker = world
    px = np.random.default_rng(2).normal(size=(1, 3, 32, 32)).astype(np.float32)
    got = ranker.rank(torch.from_numpy(px), CAPTIONS[:3])
    want = jax_ranker.rank(jnp.asarray(px), CAPTIONS[:3])
    np.testing.assert_allclose(got, want, **TOL)
    _close(ranker.image_features(torch.from_numpy(px)), jax_ranker.image_features(jnp.asarray(px)))
