"""The int8 decode paths on the CPU against the JAX package's, on the same
weights: bundle.enable_int8_decode() switches only the decode surface;
NoBeamCaptionSampler, generate, beam search (the shared-prefix int8 beam
cache), serving (ring decode and refills over the int8 cache, bf16
activations) and the CLIP-guided tree give JAX's int8 tokens exactly;
the shared-prefix beam equals the replicated int8 cache's bit for bit;
and cli.infer, cli.serve and cli.evaluate with --int8_decode print what
JAX's CLIs print.

Both packages compute the int8 products exactly and the activations in
bf16, rounded at different points (XLA keeps a fused residual add in f32
where eager torch rounds it), so logits agree to a few bf16 steps, not bit
for bit. The captioners here have peaked next-token distributions (wte
scaled up, as in the float path tests), so greedy choices are not near
ties; the sampler test's captioner also has one large input channel per
vocabulary row, which makes its int8 lm_head coarse enough that the int8
and float tokens differ (what pins fault 3.7 of ROADMAP.md)."""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.cli import evaluate as JEV
from clipcap_tpu.cli import infer as JI
from clipcap_tpu.cli import serve as JSV
from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import beam as JB
from clipcap_tpu.decode import clip_guided as JCG
from clipcap_tpu.decode import serving as JS
from clipcap_tpu.decode.engine import GenerationSettings as JSettings
from clipcap_tpu.eval.samplers import NoBeamCaptionSampler as JaxSampler
from clipcap_tpu.models.bundle import CaptionerBundle as JaxBundle
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import evaluate, infer, serve
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import beam as TB
from clipcap_tpu_torch.decode import clip_guided as CG
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode.serving import Request
from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
from clipcap_tpu_torch.models.bundle import CaptionerBundle
from clipcap_tpu_torch.models.gpt2 import GPT2Int8
from clipcap_tpu_torch.models.gptj import GPTJInt8
from clipcap_tpu_torch.models.t5 import T5Int8
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS

from test_torch_cli import world as cli_world  # noqa: F401 (a fixture)
from test_torch_validator import _cli_args, _printed_json
from test_torch_validator import world as coco_world  # noqa: F401 (a fixture)

LM = dict(vocab_size=61, n_positions=64, n_embd=32, n_layer=2, n_head=4)
VIT = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
MAPPER = dict(dim_clip=16, dim_embedding=32, prefix_length=4, clip_length=4, num_layers=1,
              num_heads=2)
SPECIAL = (0, 1, 2, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_tiny_vit():
    """One intra-op thread, and the CLI tests' tiny CLIP ViT in place of the
    ViT-B/32 their checkpoints name."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for cfg in (JC.ViTConfig, TC.ViTConfig):
        mp.setattr(cfg, "clip_variant", classmethod(lambda cls, name: cls(style="clip", **VIT)))
    yield
    mp.undo()
    torch.set_num_threads(before)


class Tok:
    bos_token_id = 3
    all_special_ids = SPECIAL

    def encode_text(self, text):
        assert text == "."
        return [5]

    def decode_tokens(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _bundles(seed: int = 1, scale: float = 5.0, outlier: bool = False):
    """The same captioner (tiny CLIP ViT, mapper, GPT-2) in both packages,
    seeded in the port, wte scaled up by `scale`. With `outlier`, every
    vocabulary row has one large channel (a constant shift of the float
    logits, a coarse int8 lm_head) and the bos row is zero (with tied
    embeddings a peaked LM would otherwise repeat bos, a special token, and
    end every caption at once)."""
    cap_t = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAPPER))
    port = CaptionerBundle.create(cap_t, TC.GPT2Config(**LM), Tok(),
                                  TC.ViTConfig(style="clip", **VIT), seed=seed, device="cpu")
    with torch.no_grad():
        port.model.lm.wte.mul_(scale)
        if outlier:
            port.model.lm.wte[Tok.bos_token_id] = 0.0
            port.model.lm.wte[:, 7] = 3.0
    params = jax.tree_util.tree_map(jnp.asarray, convert.captioner_params(port.model))
    jax_bundle = JaxBundle(params=params,
                           cap_cfg=JC.CaptionerConfig(lm_type="gpt2",
                                                      mapper=JC.MapperConfig(**MAPPER)),
                           lm_cfg=JC.GPT2Config(**LM), tokenizer=Tok(),
                           vit_cfg=JC.ViTConfig(style="clip", **VIT))
    return port, jax_bundle


@pytest.fixture(scope="module")
def bundles():
    port, jax_bundle = _bundles()
    return port.enable_int8_decode(), jax_bundle.enable_int8_decode()


def _no_launches():
    assert FA.LAUNCHES == {"fused_attention": 0}
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def test_fault_nobeam_sampler_decodes_on_lm_decode():
    """NoBeamCaptionSampler decoded on bundle.lm, so with int8 enabled the
    sweep kept decoding in float while beam search and the tree ran int8.
    It decodes on bundle.lm_decode, as JAX's does: JAX's int8 captions, and
    not the float ones."""
    port, jax_bundle = _bundles(seed=2, outlier=True)
    pixels = np.random.default_rng(0).normal(size=(3, 3, 32, 32)).astype(np.float32)
    kw = dict(top_p_values=[1e-6, 1e-6], max_decode_length=10)
    floats = NoBeamCaptionSampler(**kw, device="cpu").sample_batch(port, torch.from_numpy(pixels))
    port.enable_int8_decode()
    jax_bundle.enable_int8_decode()
    want = JaxSampler(**kw).sample_batch(jax_bundle, pixels)
    got = NoBeamCaptionSampler(**kw, device="cpu").sample_batch(port, torch.from_numpy(pixels))
    assert got == want and all(c for caps in got for c in caps)
    assert got != floats
    _no_launches()


def test_enable_int8_decode_switches_only_the_decode_surface(bundles):
    port, _ = bundles
    assert isinstance(port.lm_decode, GPT2Int8) and port.lm is port.model.lm
    assert port.lm_decode.wte.dtype == torch.bfloat16 and port.lm.wte.dtype == torch.float32
    tokens = torch.tensor([[4, 9, 11]])
    # forward, the loss and embed_text keep the float LM
    assert torch.equal(port.embed_text(tokens), port.model.lm.embed_tokens(tokens))
    prefix = torch.zeros(1, MAPPER["dim_clip"])
    assert torch.equal(port.forward(tokens, prefix), port.model(tokens, prefix))
    eng = port.make_serving_engine(TE.GenerationSettings(max_new_tokens=4, greedy=True),
                                   slots=2)
    assert eng.lm is port.lm_decode and eng.dtype == torch.bfloat16
    # GPT-J's and T5's int8 modules enable too, their leaves JAX's
    # enable_int8_decode's (JAX quantizes there under jit, where XLA
    # multiplies by 1/127 and the port divides, as JAX's eager
    # quantize_params does: a scale may differ by an ulp)
    jlm = dict(vocab_size=61, n_positions=64, n_embd=32, n_layer=2, n_head=4, rotary_dim=8)
    cap_t = TC.CaptionerConfig(lm_type="gptj", mapper=TC.MapperConfig(**MAPPER))
    gptj = CaptionerBundle.create(cap_t, TC.GPTJConfig(**jlm), Tok(), seed=3, device="cpu")
    jgptj = JaxBundle(params=jax.tree_util.tree_map(jnp.asarray,
                                                    convert.captioner_params(gptj.model)),
                      cap_cfg=JC.CaptionerConfig(lm_type="gptj", mapper=JC.MapperConfig(**MAPPER)),
                      lm_cfg=JC.GPTJConfig(**jlm), tokenizer=Tok())
    gptj.enable_int8_decode()
    jgptj.enable_int8_decode()
    assert isinstance(gptj.lm_decode, GPTJInt8) and gptj.lm is gptj.model.lm
    want = convert.gptj_state_dict(jax.tree_util.tree_map(np.asarray, jgptj.lm_decode_params))
    got = {k: convert.to_numpy(v) for k, v in gptj.lm_decode.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in got:
        if k.endswith(".s"):
            np.testing.assert_allclose(got[k], want[k], rtol=2.5e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tlm = dict(vocab_size=61, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_decoder_layers=2,
               num_heads=4, feed_forward_proj="gated-gelu", tie_word_embeddings=False)
    cap_5 = TC.CaptionerConfig(lm_type="t5", mapper=TC.MapperConfig(**MAPPER))
    t5 = CaptionerBundle.create(cap_5, TC.T5Config(**tlm), Tok(), seed=4, device="cpu")
    jt5 = JaxBundle(params=jax.tree_util.tree_map(jnp.asarray,
                                                  convert.captioner_params(t5.model)),
                    cap_cfg=JC.CaptionerConfig(lm_type="t5", mapper=JC.MapperConfig(**MAPPER)),
                    lm_cfg=JC.T5Config(**tlm), tokenizer=Tok())
    t5.enable_int8_decode()
    jt5.enable_int8_decode()
    assert isinstance(t5.lm_decode, T5Int8) and t5.lm is t5.model.lm
    want = convert.t5_state_dict(jax.tree_util.tree_map(np.asarray, jt5.lm_decode_params))
    got = {k: convert.to_numpy(v) for k, v in t5.lm_decode.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in got:
        if k.endswith(".s"):
            np.testing.assert_allclose(got[k], want[k], rtol=2.5e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    eng = t5.make_serving_engine(TE.GenerationSettings(max_new_tokens=4, greedy=True), slots=2)
    assert eng.lm is t5.lm_decode and eng.dtype == torch.float32  # T5's table stays f32


def _prompts(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, MAPPER["prefix_length"], LM["n_embd"])) * 0.3).astype(np.float32)


BEAM = dict(beam_size=4, max_new_tokens=9, stop_token_id=5)


def test_beam_search_int8_matches_jax():
    """Batched beam over the shared-prefix int8 cache, 3 images x beam 4, on
    a more peaked captioner (wte x 10): at x 5 two candidates for a fourth
    beam lie 1e-3 apart, below the packages' bf16 disagreement."""
    port, jax_bundle = _bundles(scale=10.0)
    port.enable_int8_decode()
    jax_bundle.enable_int8_decode()
    prompts = _prompts(3, 2)
    want = JB.beam_search_batched(jax_bundle.lm_decode, jax_bundle.lm_decode_params,
                                  jax_bundle.lm_cfg, jnp.asarray(prompts), **BEAM)
    got = TB.beam_search_batched(port.lm_decode, torch.from_numpy(prompts), device="cpu",
                                 **BEAM)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["seq_lengths"].numpy(), np.asarray(want["seq_lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=1e-2)
    _no_launches()


def test_beam_search_shared_prefix_equals_the_replicated_cache(bundles):
    """The shared-prefix branch gives, bit for bit, what the replicated int8
    cache gives through the same beam loop (beams reorder every step here)."""
    port, _ = bundles
    lm = port.lm_decode
    replicated = types.SimpleNamespace(init_cache=lm.init_cache, prefill=lm.prefill,
                                       decode_step=lm.decode_step,
                                       embed_tokens=lm.embed_tokens)
    prompts = torch.from_numpy(_prompts(3, 2))
    got = TB.beam_search_batched(lm, prompts, device="cpu", **BEAM)
    want = TB.beam_search_batched(replicated, prompts, device="cpu", **BEAM)
    for key in ("tokens", "seq_lengths", "scores"):
        assert torch.equal(got[key], want[key]), key
    assert len({tuple(b) for b in got["tokens"][0].tolist()}) == BEAM["beam_size"]


def test_generate_int8_matches_jax(bundles):
    port, jax_bundle = bundles
    prompts = _prompts(4, 3)
    settings = dict(max_new_tokens=10, greedy=True, eos_token_id=5)
    from clipcap_tpu.decode.engine import generate as jgenerate

    want = jgenerate(jax_bundle.lm_decode, jax_bundle.lm_decode_params, jax_bundle.lm_cfg,
                     jnp.asarray(prompts), JSettings(**settings))
    got = TE.generate(port.lm_decode, torch.from_numpy(prompts),
                      TE.GenerationSettings(**settings), device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))


def test_serving_int8_matches_jax(bundles):
    """Six requests with caps through 2 slots: refills and a ring wrap over
    the int8 cache, bf16 activations (the engine's dtype from the int8 wte)."""
    port, jax_bundle = bundles
    prompts = _prompts(6, 4)
    caps = [3, 8, 5, 8, 2, 6]
    settings = dict(max_new_tokens=8, greedy=True, eos_token_id=5)
    eng = port.make_serving_engine(TE.GenerationSettings(**settings), slots=2,
                                   steps_per_sync=3)
    got = eng.serve([Request(f"r{i}", prompts[i], max_length=c) for i, c in enumerate(caps)])
    jeng = jax_bundle.make_serving_engine(JSettings(**settings), slots=2, steps_per_sync=3)
    want = jeng.serve([JS.Request(f"r{i}", prompts[i], c) for i, c in enumerate(caps)],
                      jax_bundle.lm_decode_params)
    assert set(got) == set(want) and len(got) == 6
    for rid in want:
        assert (got[rid]["tokens"], got[rid]["stopped"]) == \
            (want[rid]["tokens"], want[rid]["stopped"]), rid
    _no_launches()


class StubScoring:
    """A deterministic 'CLIP': hashed bigram features of the text."""

    def embed_text(self, texts):
        feats = []
        for t in texts:
            h = np.zeros(8, np.float32)
            for i, tok in enumerate(t.split()):
                h[(int(tok) + i) % 8] += 1.0 + int(tok) * 0.01
            feats.append(h)
        return np.stack(feats)


@pytest.mark.parametrize("step_by_step", [False, True])
def test_clip_guided_int8_matches_jax(bundles, step_by_step):
    port, jax_bundle = bundles
    imgs = np.arange(16, dtype=np.float32).reshape(2, 8) + 1.0
    prefix = _prompts(2, 5)
    kw = dict(max_decode_length=9, look_ahead=3, branching_factor=2,
              repetition_penalty_value=1.2, step_by_step=step_by_step)
    want = JCG.generate_clip_guided_batch(jax_bundle, StubScoring(), jnp.asarray(imgs),
                                          jnp.asarray(prefix), **kw)
    got = CG.generate_clip_guided_batch(port, StubScoring(), torch.from_numpy(imgs),
                                        torch.from_numpy(prefix), device="cpu", **kw)
    assert got == want and all(got)


def test_infer_main_int8_matches_jax(cli_world, tmp_path):  # noqa: F811
    d, _ = cli_world
    args = ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--folder_path", str(d / "images"), "--clip_checkpoint", str(d / "clip.pt"),
            "--clip_merges", str(d / "clip_merges.txt"), "--int8_decode"]
    for extra in ([], ["--no_beam"]):  # --no_beam keeps the top-p 0.1 caption: the top token
        JI.main(args + extra + ["--out_filename_prefix", str(tmp_path / "jax")])
        got = infer.main(args + extra + ["--out_filename_prefix", str(tmp_path / "port"),
                                         "--device", "cpu"])
        want = json.loads((tmp_path / "jax_shutterstock.json").read_text())
        assert got == want and len(got) == 3


def test_serve_main_int8_matches_jax(cli_world, tmp_path):  # noqa: F811
    d, _ = cli_world
    args = ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--prefixes_npy", str(d / "feats.npy"), "--slots", "4", "--steps_per_sync", "4",
            "--max_new_tokens", "6", "--int8_decode"]
    JSV.main(args + ["--out_jsonl", str(tmp_path / "jax.jsonl")])
    assert serve.main(args + ["--out_jsonl", str(tmp_path / "port.jsonl"), "--device", "cpu"]) == 5
    want = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert (tmp_path / "port.jsonl").read_text().splitlines() == want and len(want) == 5


def test_evaluate_main_int8_matches_jax(coco_world, capsys):  # noqa: F811
    d, _, _ = coco_world
    JEV.main(_cli_args(d) + ["--int8_decode"])
    want = _printed_json(capsys.readouterr().out)
    evaluate.main(_cli_args(d) + ["--int8_decode", "--device", "cpu"])
    got = _printed_json(capsys.readouterr().out)
    assert got["sampler_scores"] == want["sampler_scores"]
    for key in ("validation_loss", "clip_score"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
