"""The port's beam search against the JAX package: the golden `beam` and
`beam_lengths` of tests/fixtures/golden_tokens.json exactly; tokens,
lengths and scores equal to JAX's beam_search_batched on a tiny GPT-2 with
a stop token that fires; batched equal to per-image; and
BeamCaptionSampler.sample_batch equal to JAX's."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import beam as JB
from clipcap_tpu.eval.samplers import BeamCaptionSampler as JaxBeamSampler
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu.models.bundle import CaptionerBundle as JaxBundle
from clipcap_tpu.tokenizers import GPT2TokenizerWrapper as JaxTok
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import beam as TB
from clipcap_tpu_torch.eval.samplers import BeamCaptionSampler
from clipcap_tpu_torch.models.bundle import CaptionerBundle
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS
from clipcap_tpu_torch.tokenizers import GPT2TokenizerWrapper
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_tokens.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_golden_beam():
    """generate_golden.py:65-68: beam 4, 16 new tokens, image 0 of the
    golden world, on the JAX init converted to the port."""
    lm_cfg = JC.GPT2Config(**GOLDEN["lm_cfg"])
    cap_cfg = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**GOLDEN["map_cfg"]))
    params = JCAP.init(jax.random.PRNGKey(0), cap_cfg, lm_cfg)
    clip_embed = jax.random.normal(jax.random.PRNGKey(1), (GOLDEN["batch"], 512), jnp.float32)
    model = Captioner(TC.CaptionerConfig(mapper=TC.MapperConfig(**GOLDEN["map_cfg"])),
                      TC.GPT2Config(**GOLDEN["lm_cfg"]), device="cpu")
    convert.load(model, convert.captioner_state_dict(_tree(params)))
    with torch.no_grad():
        prefix = model.project_prefix(torch.from_numpy(np.array(clip_embed[:1])))
    out = TB.beam_search(model.lm, prefix, beam_size=4, max_new_tokens=16, device="cpu")
    assert out["tokens"].tolist() == GOLDEN["beam"]
    assert out["seq_lengths"].tolist() == GOLDEN["beam_lengths"]


LM = dict(vocab_size=97, n_positions=64, n_embd=64, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def small_world():
    """A tiny GPT-2, seeded in the port and handed to JAX in its layout,
    whose embedding (and tied head) is scaled up, so its next-token
    distributions are peaked rather than near uniform: beams then stop and
    compete away from near-ties."""
    model = GPT2(TC.GPT2Config(**LM), device="cpu", seed=0)
    with torch.no_grad():
        model.wte.mul_(50.0)
    params = _jax_tree(convert.gpt2_params(_numpy_sd(model), LM["n_layer"]))
    prefix = np.random.default_rng(1).normal(size=(3, 5, 64)).astype(np.float32)
    # a stop token that fires: the first token of image 0's best beam
    out = TB.beam_search_batched(model, torch.from_numpy(prefix), beam_size=3,
                                 max_new_tokens=10, device="cpu")
    return params, model, prefix, int(out["tokens"][0, 0, 0])


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_batched_beam_matches_jax(small_world, temperature):
    params, model, prefix, stop = small_world
    kw = dict(beam_size=3, max_new_tokens=10, temperature=temperature, stop_token_id=stop)
    want = JB.beam_search_batched(JG, params, JC.GPT2Config(**LM), jnp.asarray(prefix), **kw)
    got = TB.beam_search_batched(model, torch.from_numpy(prefix), device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["seq_lengths"].numpy(), np.asarray(want["seq_lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               atol=1e-5, rtol=1e-5)
    # the stop token fired: some beam is shorter than the others
    assert int(got["seq_lengths"].min()) < 10


def test_batched_beam_equals_per_image(small_world):
    _, model, prefix, stop = small_world
    kw = dict(beam_size=3, max_new_tokens=10, stop_token_id=stop, device="cpu")
    batched = TB.beam_search_batched(model, torch.from_numpy(prefix), **kw)
    for i in range(prefix.shape[0]):
        one = TB.beam_search(model, torch.from_numpy(prefix[i:i + 1]), **kw)
        assert torch.equal(one["tokens"], batched["tokens"][i])
        assert torch.equal(one["seq_lengths"], batched["seq_lengths"][i])
        np.testing.assert_allclose(one["scores"].numpy(), batched["scores"][i].numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_best_beam_text_orders_like_jax():
    class Tok:
        def decode_tokens(self, ids):
            return ",".join(map(str, ids))

    res = {"tokens": torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]]),
           "seq_lengths": torch.tensor([3, 2, 1]),
           "scores": torch.tensor([-1.0, -0.5, -0.5])}  # a tie for the best
    jres = {k: jnp.asarray(v.numpy()) for k, v in res.items()}
    assert TB.best_beam_text(res, Tok()) == JB.best_beam_text(jres, Tok())
    batched = {k: v[None] for k, v in res.items()}
    assert TB.best_beam_texts(batched, Tok()) == \
        JB.best_beam_texts({k: v[None] for k, v in jres.items()}, Tok())


def test_beam_refuses_another_device(small_world):
    _, model, prefix, _ = small_world
    with pytest.raises(ValueError):
        TB.beam_search_batched(model, torch.from_numpy(prefix))  # the card by default
    with pytest.raises(ValueError):
        TB.beam_search(model, torch.from_numpy(prefix), device="cpu")  # not one image


def test_beam_sampler_matches_jax(tmp_path):
    base = list(bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("h", "e"), ("Ġ", "a"), ("Ġt", "he")]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        base + ["".join(m) for m in merges] + ["<|endoftext|>"]))}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(f"{a} {b}" for a, b in merges) + "\n")
    tok_j, tok_t = JaxTok.create(str(tmp_path)), GPT2TokenizerWrapper.create(str(tmp_path))
    vit = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
    mapper = dict(dim_clip=16, dim_embedding=32, prefix_length=3, clip_length=3, num_layers=1,
                  num_heads=2)
    lm = dict(vocab_size=len(vocab), n_positions=48, n_embd=32, n_layer=1, n_head=2)
    cap_j = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**mapper))
    bundle = CaptionerBundle.create(
        TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**mapper)),
        TC.GPT2Config(**lm), tok_t, TC.ViTConfig(**vit), device="cpu")
    jax_bundle = JaxBundle(params=_jax_tree(convert.captioner_params(bundle.model)),
                           cap_cfg=cap_j, lm_cfg=JC.GPT2Config(**lm), tokenizer=tok_j,
                           vit_cfg=JC.ViTConfig(**vit))

    pixels = np.random.default_rng(0).normal(size=(4, 3, 32, 32)).astype(np.float32)
    kw = dict(beam_size=3, max_decode_length=6)
    want = JaxBeamSampler(**kw).sample_batch(jax_bundle, pixels)
    got = BeamCaptionSampler(**kw, device="cpu").sample_batch(bundle, torch.from_numpy(pixels))
    assert got == want and len(got) == 4
    with torch.no_grad():
        prefix = bundle.prefix_from_pixels(torch.from_numpy(pixels[2:3]))
    assert BeamCaptionSampler(**kw, device="cpu").generate_captions(bundle, prefix) == got[2]
    assert FA.LAUNCHES == {"fused_attention": 0}
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}
