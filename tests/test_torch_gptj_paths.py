"""A GPT-J captioner through the decode paths and the three CLIs, on the
CPU, against the JAX package on the same checkpoint.

The world: a tiny CLIP ViT + mapper + GPT-J captioner (its vocabulary five
ids wider than the BPE's, as GPT-J-6B's 50400 rows are wider than GPT-2's
50257 tokens) seeded in the port and saved by the JAX package (Orbax, then
consolidate), a GPT-2 captioner on the same tokenizer as a speculative
draft, a tiny COCO folder, an OpenAI-layout CLIP state dict and a shard of
CLIP features. The GPT-J lm_head is scaled up, so its next-token
distributions are peaked (greedy choices are not near ties).

- the no-beam sweep (top-p near 0 pins the top token), batched beam
  search, serving (the ring with rotary at each row's own position, refills
  and wraps) and the CLIP-guided tree give JAX's captions and tokens;
- bundle.enable_int8_decode() on GPT-J: greedy generate, beam search on the
  replicated int8 cache and int8 serving give JAX's tokens;
- cli.infer (beam, --no_beam and --speculative_draft_checkpoint with the
  GPT-2 draft), cli.serve (float and --int8_decode) and cli.evaluate write
  or print what JAX's CLIs do.
No kernel launches on the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.cli import evaluate as JEV
from clipcap_tpu.cli import infer as JI
from clipcap_tpu.cli import loading as JL
from clipcap_tpu.cli import serve as JSV
from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import beam as JB
from clipcap_tpu.decode import clip_guided as JCG
from clipcap_tpu.decode import serving as JS
from clipcap_tpu.decode.engine import GenerationSettings as JSettings
from clipcap_tpu.decode.engine import generate as jgenerate
from clipcap_tpu.eval.samplers import NoBeamCaptionSampler as JaxSampler
from clipcap_tpu.train import checkpoints as JCK
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import evaluate, infer, loading, serve
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import beam as TB
from clipcap_tpu_torch.decode import clip_guided as CG
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode.serving import Request
from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.models.gptj import GPTJ, GPTJInt8
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode

from test_torch_import_weights import openai_clip_state_dict
from test_torch_validator import CLIP_MERGES, MAPPER, TEXT, VIT, _printed_json

MERGES = [("Ġ", "t"), ("h", "e"), ("Ġ", "a"), ("Ġt", "he"), ("c", "a")]
PADDING_IDS = 5  # GPT-J's rows past the BPE vocabulary


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_tiny_vit():
    """One intra-op thread, and a tiny CLIP ViT in place of the ViT-B/32 the
    checkpoints name."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for cfg in (JC.ViTConfig, TC.ViTConfig):
        mp.setattr(cfg, "clip_variant", classmethod(lambda cls, name: cls(style="clip", **VIT)))
    yield
    mp.undo()
    torch.set_num_threads(before)


def _save_jax_checkpoint(path, model, cap, lm):
    JCK.save_checkpoint(str(path), {"params": convert.captioner_params(model)}, cap_cfg=cap,
                        lm_cfg=lm)
    JCK.consolidate(str(path), str(path / "consolidated.npz"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("gptj")
    base = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        base + ["".join(m) for m in MERGES] + ["<|endoftext|>"]))}
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (d / "vocab" / "merges.txt").write_text("\n".join(f"{a} {b}" for a, b in MERGES) + "\n")

    (d / "images").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(3):
        name = f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (40 + 4 * i, 44, 3), dtype=np.uint8)).save(
            d / "images" / name)
        images.append({"id": i, "file_name": name, "coco_url": f"http://x/{name}"})
        annotations += [{"image_id": i, "caption": f"a cat on the mat {i} {j}.", "id": 10 * i + j}
                        for j in range(2)]
    (d / "captions.json").write_text(json.dumps({"images": images, "annotations": annotations}))
    (d / "images" / "img_1.json").write_text(json.dumps({"src": "http://x/1", "alt": "the cat"}))

    mapper = dict(MAPPER, dim_embedding=48)
    lm = JC.GPTJConfig(vocab_size=len(vocab) + PADDING_IDS, n_positions=96, n_embd=48,
                       n_layer=2, n_head=4, rotary_dim=8)
    cap = JC.CaptionerConfig(lm_type="gptj", lm_variant="gptj", visual_encoder_type="CLIP",
                             visual_encoder_variant="ViT-B/32", mapper=JC.MapperConfig(**mapper))
    model = Captioner(TC.CaptionerConfig.from_dict(dataclasses.asdict(cap)),
                      TC.GPTJConfig(**dataclasses.asdict(lm)),
                      vit_cfg=TC.ViTConfig(style="clip", **VIT), device="cpu", seed=3)
    with torch.no_grad():
        model.lm.lm_head.weight.mul_(50.0)  # peaked next-token distributions
    _save_jax_checkpoint(d / "ckpt", model, cap, lm)

    dlm = JC.GPT2Config(vocab_size=len(vocab), n_positions=96, n_embd=32, n_layer=1, n_head=2)
    dcap = JC.CaptionerConfig(lm_type="gpt2", visual_encoder_type="CLIP",
                              visual_encoder_variant="ViT-B/32", mapper=JC.MapperConfig(**MAPPER))
    draft = Captioner(TC.CaptionerConfig.from_dict(dataclasses.asdict(dcap)),
                      TC.GPT2Config(**dataclasses.asdict(dlm)),
                      vit_cfg=TC.ViTConfig(style="clip", **VIT), device="cpu", seed=4)
    _save_jax_checkpoint(d / "draft", draft, dcap, dlm)

    clip_sd = openai_clip_state_dict(VIT, TEXT)
    torch.save({k: torch.from_numpy(v) for k, v in clip_sd.items()}, d / "clip.pt")
    (d / "clip_merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES) + "\n")
    np.save(d / "feats.npy", rng.normal(size=(5, MAPPER["dim_clip"])).astype(np.float32))
    return d


@pytest.fixture(scope="module")
def bundles(world):
    d = world
    jb = JL.load_captioner_bundle(str(d / "ckpt"), str(d / "vocab"))
    tb = loading.load_captioner_bundle(str(d / "ckpt"), str(d / "vocab"), device="cpu")
    assert isinstance(tb.lm, GPTJ) and tb.lm_cfg.vocab_size == jb.lm_cfg.vocab_size
    return tb, jb


def _no_launches():
    assert FA.LAUNCHES == {"fused_attention": 0}
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def _prompts(bundle_t, n: int, seed: int) -> np.ndarray:
    feats = np.random.default_rng(seed).normal(size=(n, MAPPER["dim_clip"])).astype(np.float32)
    return bundle_t.project_prefix(torch.from_numpy(feats)).numpy()


def test_nobeam_sampler_matches_jax(bundles):
    tb, jb = bundles
    pixels = np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(np.float32)
    kw = dict(top_p_values=[1e-6, 1e-6], max_decode_length=10)
    want = JaxSampler(**kw).sample_batch(jb, pixels)
    got = NoBeamCaptionSampler(**kw, device="cpu").sample_batch(tb, torch.from_numpy(pixels))
    assert got == want and any(c for caps in got for c in caps)
    _no_launches()


BEAM = dict(beam_size=3, max_new_tokens=8, stop_token_id=14)


@pytest.mark.parametrize("int8", [False, True])
def test_beam_search_matches_jax(bundles, int8_bundles, int8):
    """Float caches, and the replicated int8 cache (GPT-J's int8 module has
    no shared-prefix beam cache, as JAX's has none)."""
    tb, jb = int8_bundles if int8 else bundles
    assert not hasattr(tb.lm_decode, "beam_prefix_cache")
    prompts = _prompts(tb, 3, 2)
    want = JB.beam_search_batched(jb.lm_decode, jb.lm_decode_params, jb.lm_cfg,
                                  jnp.asarray(prompts), **BEAM)
    got = TB.beam_search_batched(tb.lm_decode, torch.from_numpy(prompts), device="cpu", **BEAM)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["seq_lengths"].numpy(), np.asarray(want["seq_lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-2 if int8 else 1e-5)


@pytest.fixture(scope="module")
def int8_bundles(world):
    """The same checkpoint's bundles with int8 decode enabled."""
    tq = loading.load_captioner_bundle(str(world / "ckpt"), str(world / "vocab"), device="cpu")
    jq = JL.load_captioner_bundle(str(world / "ckpt"), str(world / "vocab"))
    tq.enable_int8_decode()
    jq.enable_int8_decode()
    assert isinstance(tq.lm_decode, GPTJInt8) and isinstance(tq.lm, GPTJ)
    return tq, jq


def test_int8_generate_matches_jax(int8_bundles):
    tq, jq = int8_bundles
    prompts = _prompts(tq, 4, 3)
    settings = dict(max_new_tokens=10, greedy=True, eos_token_id=14)
    want = jgenerate(jq.lm_decode, jq.lm_decode_params, jq.lm_cfg, jnp.asarray(prompts),
                     JSettings(**settings))
    got = TE.generate(tq.lm_decode, torch.from_numpy(prompts), TE.GenerationSettings(**settings),
                      device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))


@pytest.mark.parametrize("int8", [False, True])
def test_serving_matches_jax(bundles, int8_bundles, int8):
    """Six requests with caps through 2 slots: refills and ring wraps, each
    slot's rotary at its own logical position."""
    tb, jb = int8_bundles if int8 else bundles
    prompts = _prompts(tb, 6, 4)
    caps = [3, 8, 5, 8, 2, 6]
    settings = dict(max_new_tokens=8, greedy=True, eos_token_id=14)
    eng = tb.make_serving_engine(TE.GenerationSettings(**settings), slots=2, steps_per_sync=3)
    got = eng.serve([Request(f"r{i}", prompts[i], max_length=c) for i, c in enumerate(caps)])
    jeng = jb.make_serving_engine(JSettings(**settings), slots=2, steps_per_sync=3)
    want = jeng.serve([JS.Request(f"r{i}", prompts[i], c) for i, c in enumerate(caps)],
                      jb.lm_decode_params)
    assert set(got) == set(want) and len(got) == 6
    for rid in want:
        assert (got[rid]["tokens"], got[rid]["stopped"]) == \
            (want[rid]["tokens"], want[rid]["stopped"]), rid
    _no_launches()


class CharScoring:
    """A deterministic 'CLIP' over decoded text: hashed character features."""

    def embed_text(self, texts):
        feats = np.zeros((len(texts), 8), np.float32)
        for r, t in enumerate(texts):
            for i, ch in enumerate(t):
                feats[r, (ord(ch) + i) % 8] += 1.0 + (ord(ch) % 13) * 0.01
        return feats


def test_clip_guided_matches_jax(bundles):
    tb, jb = bundles
    imgs = np.arange(16, dtype=np.float32).reshape(2, 8) + 1.0
    prefix = _prompts(tb, 2, 5)
    kw = dict(max_decode_length=9, look_ahead=3, branching_factor=2,
              repetition_penalty_value=1.2)
    want = JCG.generate_clip_guided_batch(jb, CharScoring(), jnp.asarray(imgs),
                                          jnp.asarray(prefix), **kw)
    got = CG.generate_clip_guided_batch(tb, CharScoring(), torch.from_numpy(imgs),
                                        torch.from_numpy(prefix), device="cpu", **kw)
    assert got == want and all(got)


def _infer_args(d):
    return ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--folder_path", str(d / "images"), "--clip_checkpoint", str(d / "clip.pt"),
            "--clip_merges", str(d / "clip_merges.txt")]


@pytest.mark.parametrize("extra", [[], ["--no_beam"], ["--speculative_draft_checkpoint"]],
                         ids=["beam", "no_beam", "speculative"])
def test_infer_main_matches_jax(world, tmp_path, extra):
    """cli.infer on the GPT-J checkpoint: by beam, by the no-beam sweep (its
    top-p 0.1 caption is the top token), and by speculative greedy decode
    with the GPT-2 draft, which has its own CLIP encoder and mapper."""
    d = world
    if extra:
        extra = extra + ([str(d / "draft"), "--speculative_gamma", "3"]
                         if extra[0].startswith("--spec") else [])
    JI.main(_infer_args(d) + extra + ["--out_filename_prefix", str(tmp_path / "jax")])
    got = infer.main(_infer_args(d) + extra + ["--out_filename_prefix", str(tmp_path / "port"),
                                               "--device", "cpu"])
    want = json.loads((tmp_path / "jax_shutterstock.json").read_text())
    assert got == want and len(got) == 3 and "http://x/1" in got
    _no_launches()


@pytest.mark.parametrize("int8", [False, True])
def test_serve_main_matches_jax(world, tmp_path, int8):
    d = world
    args = ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--prefixes_npy", str(d / "feats.npy"), "--slots", "4", "--steps_per_sync", "4",
            "--max_new_tokens", "6"] + (["--int8_decode"] if int8 else [])
    JSV.main(args + ["--out_jsonl", str(tmp_path / "jax.jsonl")])
    assert serve.main(args + ["--out_jsonl", str(tmp_path / "port.jsonl"), "--device", "cpu"]) == 5
    want = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert (tmp_path / "port.jsonl").read_text().splitlines() == want and len(want) == 5


def test_evaluate_main_matches_jax(world, capsys, monkeypatch):
    """JAX's validator asks the tokenizer for bos/eos, which JAX's GPT-J
    wrapper refuses (its cli.evaluate raises TypeError on a GPT-J
    checkpoint); the port's wrapper takes them with GPT-2's semantics
    (ROADMAP.md section 3). So the port is compared here with a patched
    reference, not with JAX as it ships: GPT-2's encode_text is put into
    JAX's GPT-J wrapper at run time, after the refusal is pinned."""
    from clipcap_tpu.tokenizers import api as JTOK

    with pytest.raises(TypeError):
        JTOK.GPTJTokenizerWrapper.create(str(world / "vocab")).encode_text("a", add_bos=True)
    monkeypatch.setattr(JTOK.GPTJTokenizerWrapper, "encode_text",
                        JTOK.GPT2TokenizerWrapper.encode_text)
    d = world
    args = ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--clip_checkpoint", str(d / "clip.pt"), "--clip_merges", str(d / "clip_merges.txt"),
            "--valid_json_path", str(d / "captions.json"), "--image_folder_path",
            str(d / "images"), "--max_samples", "3", "--eval_batch_size", "3"]
    JEV.main(args)
    want = _printed_json(capsys.readouterr().out)
    evaluate.main(args + ["--device", "cpu"])
    got = _printed_json(capsys.readouterr().out)
    assert got["sampler_scores"] == want["sampler_scores"]
    for key in ("validation_loss", "clip_score"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
