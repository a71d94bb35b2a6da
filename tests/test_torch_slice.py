"""The port's whole slice against the JAX bundle: pixels -> encode_image ->
project_prefix -> NoBeamCaptionSampler.sample_batch at a tiny ViT / mapper /
GPT-2 with a tiny genuine BPE vocabulary. top_p is small enough to pin the
top token (samplers.py:127-129), so both must give the same captions."""

import json

import jax
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.eval.samplers import NoBeamCaptionSampler as JaxSampler
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.models import vit as JV
from clipcap_tpu.models.bundle import CaptionerBundle as JaxBundle
from clipcap_tpu.tokenizers import GPT2TokenizerWrapper as JaxTok
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.data.preprocessing import normalize_on_device
from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
from clipcap_tpu_torch.models.bundle import CaptionerBundle
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS
from clipcap_tpu_torch.tokenizers import GPT2TokenizerWrapper
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode

VIT = dict(image_size=64, patch_size=16, width=64, layers=2, heads=2, output_dim=32)
MAP = dict(dim_clip=32, dim_embedding=64, prefix_length=4, clip_length=4, num_layers=2,
           num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and torch's default pool (one thread per core) in each
    would oversubscribe the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A small but genuine byte-level BPE vocabulary (as tests/test_tokenizer.py)."""
    d = tmp_path_factory.mktemp("vocab")
    base = list(bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("h", "e"), ("Ġ", "a"), ("i", "n"), ("Ġt", "he"), ("Ġ", "c"),
              ("a", "t"), ("Ġc", "at"), ("o", "g"), ("Ġ", "d"), ("Ġd", "og")]
    tokens = base + ["".join(m) for m in merges] + ["<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return str(d)


def test_tokenizer_matches_jax(vocab_dir):
    a, b = GPT2TokenizerWrapper.create(vocab_dir), JaxTok.create(vocab_dir)
    text = "the cat and the dog. caffè 東京"
    assert a.encode_text(text, max_token_length=5, add_bos=True, add_eos=True) == \
        b.encode_text(text, max_token_length=5, add_bos=True, add_eos=True)
    ids = b.encode_text(text)
    assert a.decode_tokens(ids) == b.decode_tokens(ids) == text
    assert (a.bos_token_id, a.all_special_ids) == (b.bos_token_id, b.all_special_ids)


def test_slice_captions_match_jax_bundle(vocab_dir):
    tok_j, tok_t = JaxTok.create(vocab_dir), GPT2TokenizerWrapper.create(vocab_dir)
    lm = dict(vocab_size=tok_j.vocab_size, n_positions=64, n_embd=64, n_layer=2, n_head=4)
    cap_j = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**MAP))
    vit_j = JC.ViTConfig(**VIT)
    params = JCAP.init(jax.random.PRNGKey(0), cap_j, JC.GPT2Config(**lm))
    params["visual"] = JV.init(jax.random.PRNGKey(1), vit_j)
    jax_bundle = JaxBundle(params=params, cap_cfg=cap_j, lm_cfg=JC.GPT2Config(**lm),
                           tokenizer=tok_j, vit_cfg=vit_j)

    bundle = CaptionerBundle.create(
        TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAP)),
        TC.GPT2Config(**lm), tok_t, TC.ViTConfig(**VIT), device="cpu")
    convert.load(bundle.model,
                 convert.captioner_state_dict(jax.tree_util.tree_map(np.asarray, params)))

    pixels01 = np.random.default_rng(0).random((3, 3, 64, 64)).astype(np.float32)
    pixels = normalize_on_device(torch.from_numpy(pixels01))
    from clipcap_tpu.data.preprocessing import normalize_on_device as jax_normalize

    np.testing.assert_allclose(pixels.numpy(), np.asarray(jax_normalize(pixels01)), rtol=1e-6)

    kw = dict(top_p_values=[1e-6, 1e-6], max_decode_length=8)
    want = JaxSampler(**kw).sample_batch(jax_bundle, pixels.numpy())
    got = NoBeamCaptionSampler(**kw, device="cpu").sample_batch(bundle, pixels)
    assert got == want
    assert len(got) == 3 and all(len(c) == 2 for c in got)
    # the per-image entry point agrees with the batched one when the top token is pinned
    assert NoBeamCaptionSampler(**kw, device="cpu").sample(bundle, pixels[1]) == got[1]
    assert FA.LAUNCHES == {"fused_attention": 0}
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def test_bundle_refuses_model_on_another_device():
    cfg = TC.CaptionerConfig(mapper=TC.MapperConfig(**MAP))
    lm = TC.GPT2Config(vocab_size=50, n_positions=16, n_embd=64, n_layer=1, n_head=4)
    bundle = CaptionerBundle.create(cfg, lm, None, device="cpu")
    with pytest.raises(ValueError):
        CaptionerBundle(bundle.model, cfg, lm, None)  # device defaults to the card
    with pytest.raises(ValueError):
        bundle.encode_image(torch.zeros(1, 3, 64, 64))  # no visual encoder
