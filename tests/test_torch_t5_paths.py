"""A T5/T0 captioner through the decode paths, the tokenizer and the CLIs,
on the CPU, against the JAX package on the same checkpoint.

The world: a tiny CLIP ViT + mapper + T5 (gated-gelu, untied lm_head, as
T0) captioner seeded in the port and saved by the JAX package (Orbax, then
consolidate), its lm_head scaled x 50 so that greedy choices are not near
ties; a `tokenizer.json` built with the `tokenizers` package (a word-level
vocabulary, T5's specials <pad> 0, </s> 1, <unk> 2, and T5's post-processor
appending </s>); an OpenAI-layout CLIP state dict, a shard of CLIP
features, prefix shards and a COCO folder.

- generate (greedy, and sampled with JAX's per-step Gumbel draws injected),
  beam search against a rebuild-from-scratch oracle and JAX's, the cross
  fields' beam invariance, and serving (refills, ring wraps, each
  request's encoder output swapped in) give JAX's tokens, in f32 and with
  int8 decode (T5Int8 over an f32 cache, the engine in bf16 as
  tests/test_serving.py runs it);
- the captioner's forward, loss, a train step and greedy decode match
  tests/test_lm_families_integration.py's t5 case run by JAX;
- T5TokenizerWrapper gives JAX's ids, specials and text;
- cli.infer (beam and --no_beam), cli.serve (float and --int8_decode) and
  cli.train --language_model_type t0 write what JAX's CLIs write, and
  cli.evaluate fails on a T5 checkpoint in both packages alike (the
  CLIP-guided sampler refuses cross-attention caches; past it, the
  validator asks the T5 wrapper for add_bos/add_eos, which neither takes).
Tolerances: tokens, lengths and captions equal; f32 logits and losses at
atol 1e-5 / rtol 1e-5, beam scores at 1e-5 (1e-2 in int8); parameters
after a train step at atol 1e-6 / rtol 1e-5. No kernel launches on the
CPU."""

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
from clipcap_tpu.cli import train as JTR
from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import beam as JB
from clipcap_tpu.decode import serving as JS
from clipcap_tpu.decode.engine import GenerationSettings as JSettings
from clipcap_tpu.decode.engine import generate as jgenerate
from clipcap_tpu.eval.samplers import NoBeamCaptionSampler as JaxSampler
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.models import t5 as JT
from clipcap_tpu.tokenizers import api as JTOK
from clipcap_tpu.train import checkpoints as JCK
from clipcap_tpu.train import create_train_state as j_create_train_state
from clipcap_tpu.train import make_train_step as j_make_train_step
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import evaluate, infer, loading, serve
from clipcap_tpu_torch.cli import train as train_cli
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.data.npy_reader import write_npy_shard
from clipcap_tpu_torch.decode import beam as TB
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode.serving import Request
from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.models.t5 import T5, T5Int8
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS
from clipcap_tpu_torch.tokenizers import api as TTOK
from clipcap_tpu_torch.train.train_step import create_train_state, make_train_step

from test_torch_import_weights import openai_clip_state_dict
from test_torch_validator import CLIP_MERGES, MAPPER, TEXT, VIT

TOL = dict(atol=1e-5, rtol=1e-5)
WORDS = ["a", "the", "cat", "dog", "on", "mat", "red", "two", "man", "sits", "near", "bus", "."]
SPECIALS = ["<pad>", "</s>", "<unk>"]
PADDING_IDS = 4  # the model's rows past the tokenizer's vocabulary, as T0's 32128 > 32100
LM = dict(d_model=32, d_kv=8, d_ff=48, num_layers=2, num_decoder_layers=2, num_heads=4,
          relative_attention_num_buckets=8, relative_attention_max_distance=32,
          feed_forward_proj="gated-gelu", tie_word_embeddings=False)
STOP = len(SPECIALS) + WORDS.index(".")


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


def write_t5_tokenizer(folder) -> int:
    """A T5-style tokenizer.json built with `tokenizers` (nothing fetched):
    word-level over WORDS, T5's specials, and T5's post-processor that
    appends </s>. Returns the vocabulary size."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {t: i for i, t in enumerate(SPECIALS + WORDS)}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.add_special_tokens(SPECIALS)
    tk.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                      special_tokens=[("</s>", 1)])
    folder.mkdir(parents=True, exist_ok=True)
    tk.save(str(folder / "tokenizer.json"))
    return len(vocab)


def _save_jax_checkpoint(path, model, cap, lm):
    JCK.save_checkpoint(str(path), {"params": convert.captioner_params(model)}, cap_cfg=cap,
                        lm_cfg=lm)
    JCK.consolidate(str(path), str(path / "consolidated.npz"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("t5")
    n_vocab = write_t5_tokenizer(d / "vocab")
    rng = np.random.default_rng(0)
    (d / "images").mkdir()
    images, annotations = [], []
    for i in range(3):
        name = f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (40 + 4 * i, 44, 3), dtype=np.uint8)).save(
            d / "images" / name)
        images.append({"id": i, "file_name": name, "coco_url": f"http://x/{name}"})
        annotations += [{"image_id": i, "caption": f"a cat on the mat {j} .", "id": 10 * i + j}
                        for j in range(2)]
    (d / "captions.json").write_text(json.dumps({"images": images, "annotations": annotations}))
    (d / "images" / "img_1.json").write_text(json.dumps({"src": "http://x/1", "alt": "the cat"}))

    lm = JC.T5Config(vocab_size=n_vocab + PADDING_IDS, **LM)
    cap = JC.CaptionerConfig(lm_type="t0", lm_variant="t0-11b", visual_encoder_type="CLIP",
                             visual_encoder_variant="ViT-B/32", mapper=JC.MapperConfig(**MAPPER))
    model = Captioner(TC.CaptionerConfig.from_dict(dataclasses.asdict(cap)),
                      TC.T5Config(**dataclasses.asdict(lm)),
                      vit_cfg=TC.ViTConfig(style="clip", **VIT), device="cpu", seed=3)
    with torch.no_grad():
        model.lm.lm_head.weight.mul_(50.0)  # peaked next-token distributions
    _save_jax_checkpoint(d / "ckpt", model, cap, lm)

    clip_sd = openai_clip_state_dict(VIT, TEXT)
    torch.save({k: torch.from_numpy(v) for k, v in clip_sd.items()}, d / "clip.pt")
    (d / "clip_merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES) + "\n")
    np.save(d / "feats.npy", rng.normal(size=(5, MAPPER["dim_clip"])).astype(np.float32))
    for i, n in enumerate((6, 5)):
        write_npy_shard(d / "shards" / "prefixes" / f"{i}.npy",
                        rng.normal(size=(n, MAPPER["dim_clip"])).astype(np.float32))
        tokens = rng.integers(3, n_vocab, size=(n, 7)).astype(np.int64)
        tokens[:, 5:] = -1
        write_npy_shard(d / "shards" / "tokens" / f"{i}.npy", tokens)
    (d / "lm.json").write_text(TC.T5Config(**dataclasses.asdict(lm)).to_json())
    return d


@pytest.fixture(scope="module")
def bundles(world):
    jb = JL.load_captioner_bundle(str(world / "ckpt"), str(world / "vocab"))
    tb = loading.load_captioner_bundle(str(world / "ckpt"), str(world / "vocab"), device="cpu")
    assert isinstance(tb.lm, T5) and tb.lm_cfg == TC.T5Config(**dataclasses.asdict(jb.lm_cfg))
    assert isinstance(tb.tokenizer, TTOK.T5TokenizerWrapper)
    return tb, jb


@pytest.fixture(scope="module")
def int8_bundles(world):
    tq = loading.load_captioner_bundle(str(world / "ckpt"), str(world / "vocab"), device="cpu")
    jq = JL.load_captioner_bundle(str(world / "ckpt"), str(world / "vocab"))
    tq.enable_int8_decode()
    jq.enable_int8_decode()
    assert isinstance(tq.lm_decode, T5Int8) and isinstance(tq.lm, T5)
    return tq, jq


def _no_launches():
    assert FA.LAUNCHES == {"fused_attention": 0}
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def _prompts(bundle_t, n: int, seed: int) -> np.ndarray:
    feats = np.random.default_rng(seed).normal(size=(n, MAPPER["dim_clip"])).astype(np.float32)
    return bundle_t.project_prefix(torch.from_numpy(feats)).numpy()


def _jax_step_gumbel(seed: int, n: int, shape) -> np.ndarray:
    """The per-step draws of JAX generate: rng, key = split(rng); gumbel(key)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(key, shape, dtype=jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "int8_greedy"])
def test_generate_matches_jax(bundles, int8_bundles, mode):
    tb, jb = int8_bundles if mode == "int8_greedy" else bundles
    prompts = _prompts(tb, 3, 1)
    n = 9
    kw = (dict(top_p=0.8, repetition_penalty=1.2, min_length=2, eos_token_id=STOP)
          if mode == "sampled" else dict(greedy=True, eos_token_id=STOP))
    want = jgenerate(jb.lm_decode, jb.lm_decode_params, jb.lm_cfg, jnp.asarray(prompts),
                     JSettings(max_new_tokens=n, **kw), rng=jax.random.PRNGKey(2))
    noise = None
    if mode == "sampled":
        noise = torch.from_numpy(_jax_step_gumbel(2, n, (3, jb.lm_cfg.vocab_size)))
    got = TE.generate(tb.lm_decode, torch.from_numpy(prompts),
                      TE.GenerationSettings(max_new_tokens=n, **kw), gumbel_noise=noise,
                      device="cpu")
    for key in ("tokens", "lengths", "stopped"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    _no_launches()


def test_nobeam_sampler_matches_jax(bundles):
    """The sweep prepends the T5 tokenizer's bos (its pad id, 0)."""
    tb, jb = bundles
    assert tb.tokenizer.bos_token_id == jb.tokenizer.bos_token_id == 0
    pixels = np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(np.float32)
    kw = dict(top_p_values=[1e-6, 1e-6], max_decode_length=10)
    want = JaxSampler(**kw).sample_batch(jb, pixels)
    got = NoBeamCaptionSampler(**kw, device="cpu").sample_batch(tb, torch.from_numpy(pixels))
    assert got == want and any(c for caps in got for c in caps)


def _oracle_beam(last_logits, beam_size, n):
    """Reference beam semantics (inference.py:70-137) in numpy, driven by a
    `last_logits(history) -> [V]` callback that rebuilds the state from
    scratch: no cache reorder, no expansion (tests/test_beam_cross_attention.py)."""
    def logsm(lg):
        return lg - np.log(np.exp(lg - lg.max()).sum()) - lg.max()

    logp = logsm(last_logits([]))
    order = np.argsort(-logp, kind="stable")[:beam_size]
    scores, tokens, seq_lengths = logp[order], order[:, None], np.ones(beam_size)
    for _ in range(1, n):
        logp = np.stack([logsm(last_logits([int(t) for t in tokens[b]]))
                         for b in range(beam_size)])
        vocab = logp.shape[-1]
        seq_lengths += 1
        avg = (scores[:, None] + logp) / seq_lengths[:, None]
        flat = np.argsort(-avg.reshape(-1), kind="stable")[:beam_size]
        source, nxt = flat // vocab, flat % vocab
        seq_lengths = seq_lengths[source]
        tokens = np.concatenate([tokens[source], nxt[:, None]], axis=1)
        scores = avg.reshape(-1)[flat] * seq_lengths
    return tokens, scores / seq_lengths


def test_beam_matches_rebuild_oracle_and_jax(bundles):
    """The twin of test_beam_cross_attention.py::test_t5_beam_matches_rebuild_oracle,
    and the batched beam of 2 images against JAX's."""
    tb, jb = bundles
    lm = tb.lm_decode
    prompts = _prompts(tb, 2, 2)
    n, beam = 6, 3

    def last_logits(history):
        p = torch.from_numpy(prompts[:1])
        logits, cache = lm.prefill(p, lm.init_cache(1, p.shape[1] + n))
        out = logits[:, -1]
        for tok in history:
            out, cache = lm.decode_step(lm.embed_tokens(torch.tensor([tok]))[:, None], cache)
        return out[0].detach().numpy().astype(np.float64)

    want_tokens, want_scores = _oracle_beam(last_logits, beam, n)
    one = TB.beam_search(lm, torch.from_numpy(prompts[:1]), beam_size=beam, max_new_tokens=n,
                         device="cpu")
    np.testing.assert_array_equal(one["tokens"].numpy(), want_tokens)
    np.testing.assert_allclose(one["scores"].numpy(), want_scores, atol=1e-4)
    kw = dict(beam_size=beam, max_new_tokens=8, stop_token_id=STOP)
    want = JB.beam_search_batched(jb.lm_decode, jb.lm_decode_params, jb.lm_cfg,
                                  jnp.asarray(prompts), **kw)
    got = TB.beam_search_batched(lm, torch.from_numpy(prompts), device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["seq_lengths"].numpy(), np.asarray(want["seq_lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), **TOL)
    _no_launches()


def test_int8_beam_matches_jax(int8_bundles):
    tq, jq = int8_bundles
    prompts = _prompts(tq, 2, 3)
    kw = dict(beam_size=3, max_new_tokens=8, stop_token_id=STOP)
    want = JB.beam_search_batched(jq.lm_decode, jq.lm_decode_params, jq.lm_cfg,
                                  jnp.asarray(prompts), **kw)
    got = TB.beam_search_batched(tq.lm_decode, torch.from_numpy(prompts), device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=1e-2)


def test_cross_fields_are_beam_invariant(bundles):
    """The twin of test_beam_cross_attention.py::test_cross_fields_are_beam_invariant:
    after _expand_beams the cross fields (the encoder output) hold every
    beam's row, and permuting them by any beam order changes no logit; the
    expansion takes the prefilled encoder output, not init_cache's
    placeholder."""
    tb, _ = bundles
    lm, beam = tb.lm_decode, 3
    prompt = torch.from_numpy(_prompts(tb, 1, 4))
    _, cache = lm.prefill(prompt, lm.init_cache(1, prompt.shape[1] + 4))
    cache = TB._expand_beams(cache, beam)
    assert cache.enc_hidden.shape == (beam, prompt.shape[1], LM["d_model"])
    assert cache.k.shape[1] == beam
    perm = torch.tensor([2, 0, 1])
    upd = {name: torch.index_select(getattr(cache, name), axis, perm)
           for name, axis in TB._CROSS_FIELDS.items() if getattr(cache, name, None) is not None}
    assert sorted(upd) == ["enc_hidden"]
    emb = lm.embed_tokens(torch.tensor([5, 7, 9]))[:, None]
    k0, v0 = cache.k.clone(), cache.v.clone()
    out_a, _ = lm.decode_step(emb, cache._replace(k=k0.clone(), v=v0.clone()))
    out_b, _ = lm.decode_step(emb, cache._replace(k=k0.clone(), v=v0.clone(), **upd))
    assert torch.equal(out_a, out_b)


@pytest.mark.parametrize("int8", [False, True], ids=["t5", "t5-int8"])
def test_serving_refill_and_ring_wrap_match_individual_runs(bundles, int8_bundles, int8):
    """The t5 and t5-int8 cases of tests/test_serving.py's test: 7 requests
    with staggered caps through 2 slots (ring = P + 12 + 1; the global index
    wraps it several times, every refill swaps the requests' encoder outputs
    in); each request equals its solo generate, in f32 and, for int8, in
    bf16 as JAX's test runs it. The f32 serve equals JAX's too (a bf16 one
    drifts from compiled JAX's by a few bf16 steps, see test_torch_t5.py)."""
    tb, jb = int8_bundles if int8 else bundles
    prompts = _prompts(tb, 7, 5)
    caps = [3, 9, 5, 12, 7, 4, 2]
    settings = dict(max_new_tokens=12, greedy=True, eos_token_id=STOP)
    reqs = [Request(f"r{i}", prompts[i], max_length=c) for i, c in enumerate(caps)]
    served = {}
    for dtype in [torch.float32] + ([torch.bfloat16] if int8 else []):
        eng = tb.make_serving_engine(TE.GenerationSettings(**settings), slots=2,
                                     steps_per_sync=3, dtype=dtype)
        got = served[dtype] = eng.serve(reqs)
        assert len(got) == 7
        for i, c in enumerate(caps):
            solo = TE.generate(tb.lm_decode, torch.from_numpy(prompts[i:i + 1]).to(dtype),
                               TE.GenerationSettings(**settings, max_length=c), device="cpu")
            assert got[f"r{i}"]["tokens"] == solo["tokens"][0, : int(solo["lengths"][0])].tolist()
            assert got[f"r{i}"]["stopped"] == bool(solo["stopped"][0])
    jeng = jb.make_serving_engine(JSettings(**settings), slots=2, steps_per_sync=3,
                                  dtype=jnp.float32)
    want = jeng.serve([JS.Request(f"r{i}", prompts[i], c) for i, c in enumerate(caps)],
                      jb.lm_decode_params)
    got = served[torch.float32]
    for rid in want:
        assert (got[rid]["tokens"], got[rid]["stopped"]) == \
            (want[rid]["tokens"], want[rid]["stopped"]), rid
    _no_launches()


def test_forward_loss_train_decode():
    """The t5 case of tests/test_lm_families_integration.py::test_forward_loss_train_decode,
    the port against JAX on JAX's captioner.init: logits, the loss, one
    train step (its loss and every updated parameter) and greedy decode."""
    map_cfg = dict(dim_clip=16, dim_embedding=32, prefix_length=4, clip_length=2, num_layers=1,
                   num_heads=2)
    lm = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1, num_decoder_layers=1,
              num_heads=4, relative_attention_num_buckets=8, relative_attention_max_distance=16)
    jcap = JC.CaptionerConfig(lm_type="t5", mapper=JC.MapperConfig(**map_cfg))
    jlm = JC.T5Config(**lm)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 64, size=(2, 8)).astype(np.int64)
    tokens[:, -2:] = -1
    prefix = rng.normal(size=(2, 16)).astype(np.float32)
    params = JCAP.init(jax.random.PRNGKey(0), jcap, jlm)
    tcap = TC.CaptionerConfig(lm_type="t5", mapper=TC.MapperConfig(**map_cfg))
    model = Captioner(tcap, TC.T5Config(**lm), device="cpu")
    convert.load(model, convert.captioner_state_dict(jax.tree_util.tree_map(np.array, params),
                                                     "t5"))
    toks0 = np.where(tokens >= 0, tokens, 0)
    want = JCAP.forward(params, jcap, jlm, jnp.asarray(toks0), jnp.asarray(prefix))
    got = model(torch.from_numpy(toks0), torch.from_numpy(prefix))
    assert got.shape == (2, 4 + 8, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    jloss, _ = JCAP.caption_loss(params, jcap, jlm, jnp.asarray(tokens), jnp.asarray(prefix))
    with torch.no_grad():
        loss, _ = model.caption_loss(torch.from_numpy(tokens), torch.from_numpy(prefix))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)

    # f32 compute (the JAX test takes the bf16 default), so the step's
    # gradients and update compare at f32 tolerances
    kw = dict(optimizer_lr=1e-3, scheduler_warmup_steps=1, total_steps=10,
              gradient_clip_val=1.0, remat=False, bf16_compute=False)
    jstate, jtx = j_create_train_state(jax.random.PRNGKey(0), jcap, jlm, JC.TrainConfig(**kw),
                                       params=params)
    jstate, jm = j_make_train_step(jcap, jlm, JC.TrainConfig(**kw), jtx, donate=False)(
        jstate, {"tokens": jnp.asarray(tokens), "prefix": jnp.asarray(prefix)})
    tcfg = TC.TrainConfig(**kw)
    state, tx = create_train_state(0, tcap, TC.T5Config(**lm), tcfg, model=model, device="cpu")
    state, m = make_train_step(tcap, TC.T5Config(**lm), tcfg, tx)(
        state, {"tokens": torch.from_numpy(tokens), "prefix": torch.from_numpy(prefix)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    after = convert.captioner_params(state.model)
    for a, b in zip(jax.tree_util.tree_leaves(after),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                                     jstate.params))):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   atol=1e-6, rtol=1e-5)

    proj = model.project_prefix(torch.from_numpy(prefix)).detach()
    out = TE.generate(model.lm, proj, TE.GenerationSettings(max_new_tokens=6, greedy=True),
                      device="cpu")
    jout = jgenerate(JT, jstate.params["lm"], jlm, jnp.asarray(proj.numpy()),
                     JSettings(max_new_tokens=6, greedy=True))
    assert out["tokens"].shape == (2, 6) and (out["tokens"] < 64).all()
    np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))


def test_tokenizer_matches_jax(world):
    tk = TTOK.create_tokenizer("t0", str(world / "vocab"))
    jtk = JTOK.create_tokenizer("t0", str(world / "vocab"))
    assert isinstance(tk, TTOK.T5TokenizerWrapper)
    for attr in ("eos_token_id", "pad_token_id", "bos_token_id", "all_special_ids",
                 "vocab_size"):
        assert getattr(tk, attr) == getattr(jtk, attr), attr
    assert (tk.eos_token_id, tk.pad_token_id, tk.all_special_ids) == (1, 0, [0, 1, 2])
    for text in ("a cat on the mat .", "two red bus near a dog", "unknown words here", "."):
        assert tk.encode(text) == jtk.encode(text)
        assert tk.encode_text(text, max_token_length=3) == jtk.encode_text(text,
                                                                           max_token_length=3)
        ids = tk.encode_text(text)
        assert tk.decode_tokens(ids) == jtk.decode_tokens(ids)
    assert tk.encode_text(".")[0] == STOP
    for wrapper in (tk, jtk):
        with pytest.raises(TypeError):
            wrapper.encode_text("a cat", add_bos=True, add_eos=True)
    with pytest.raises(FileNotFoundError):
        TTOK.create_tokenizer("t5", str(world / "images"))


def _infer_args(d):
    return ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--folder_path", str(d / "images"), "--clip_checkpoint", str(d / "clip.pt"),
            "--clip_merges", str(d / "clip_merges.txt")]


@pytest.mark.parametrize("extra", [[], ["--no_beam"]], ids=["beam", "no_beam"])
def test_infer_main_matches_jax(world, tmp_path, extra):
    """cli.infer on the T5 checkpoint: the stop id is the tokenizer's id of
    "." in both."""
    d = world
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
            "--max_new_tokens", "6", "--eos_token_id", str(STOP)] + (
                ["--int8_decode"] if int8 else [])
    JSV.main(args + ["--out_jsonl", str(tmp_path / "jax.jsonl")])
    assert serve.main(args + ["--out_jsonl", str(tmp_path / "port.jsonl"), "--device", "cpu"]) == 5
    want = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert (tmp_path / "port.jsonl").read_text().splitlines() == want and len(want) == 5


def test_train_main_t0_matches_jax(world, tmp_path, monkeypatch):
    """cli.train --language_model_type t0 --prefix_only on prefix shards,
    the LM from an HF T5 state dict (--lm_checkpoint through
    t5_from_state_dict) in both packages. The mappers start from each
    package's own init, so the runs differ; what must agree: the frozen LM
    of both final checkpoints (the HF weights in bf16, bit for bit), the
    configs, and the loss each package computes on the port's trained
    captioner."""
    from transformers import T5Config as HFT5Config, T5ForConditionalGeneration

    d = world
    lm = json.loads((d / "lm.json").read_text())
    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(HFT5Config(dropout_rate=0.0, **lm))
    torch.save(hf.state_dict(), tmp_path / "t5.bin")
    args = ["--tokenizer_vocab_dir", str(d / "vocab"), "--lm_config_json", str(d / "lm.json"),
            "--language_model_type", "t0", "--lm_checkpoint", str(tmp_path / "t5.bin"),
            "--prefix_data_path", str(d / "shards"), "--prefix_only", "--prefix_size", "16",
            "--prefix_length", "3", "--clip_prefix_length", "3", "--num_layers", "1",
            "--num_attention_heads", "2", "--batch_size", "4", "--epochs", "1",
            "--max_steps", "2", "--scheduler_warmup_steps", "1", "--optimizer_lr", "1e-3",
            "--log_every_n_steps", "1", "--seed", "3"]
    monkeypatch.chdir(tmp_path)
    JTR.main(args + ["--output_dir", str(tmp_path / "jax")])
    res = train_cli.main(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert isinstance(res["state"].model.lm, T5) and int(res["state"].step) == 2
    port_ckpt, jax_ckpt = tmp_path / "port" / "demo_model_final", tmp_path / "jax" / "demo_model_final"
    tmodel, tcap, tlm, _ = loading.load_captioner(str(port_ckpt), device="cpu")
    jb = JL.load_captioner_bundle(str(jax_ckpt), str(d / "vocab"))
    assert dataclasses.asdict(tlm) == dataclasses.asdict(jb.lm_cfg) and tcap.lm_type == "t0"
    want_lm = convert.t5_state_dict(jax.tree_util.tree_map(np.asarray, jb.params["lm"]))
    got_lm = {k: convert.to_numpy(v) for k, v in tmodel.lm.state_dict().items()}
    assert sorted(got_lm) == sorted(want_lm)
    for k in want_lm:
        assert np.array_equal(got_lm[k].view(np.int16), np.asarray(want_lm[k]).view(np.int16)), k
    # the port's trained captioner, scored by both packages
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype.kind == "V" else a),
        convert.captioner_params(tmodel))
    rng = np.random.default_rng(1)
    tokens = rng.integers(3, 16, size=(2, 5)).astype(np.int64)
    prefix = rng.normal(size=(2, 16)).astype(np.float32)
    jloss, _ = JCAP.caption_loss(jparams, jb.cap_cfg, jb.lm_cfg, jnp.asarray(tokens),
                                 jnp.asarray(prefix))
    with torch.no_grad():
        loss, _ = tmodel.caption_loss(torch.from_numpy(tokens), torch.from_numpy(prefix))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2)


def test_evaluate_refuses_t5_as_jax_does(world, monkeypatch):
    """cli.evaluate on a T5 checkpoint fails in both packages, the same way.
    First the CLIP-guided sampler refuses the cross-attention cache
    (NotImplementedError). Past it (the sampler patched out, in both), the
    validation loss asks the tokenizer for encode_text(add_bos=True,
    add_eos=True), which JAX's T5 wrapper does not take, and neither does
    the port's, which has JAX's surface: TypeError."""
    from clipcap_tpu.eval import samplers as JSAM
    from clipcap_tpu_torch.eval import samplers as TSAM

    d = world
    args = ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--clip_checkpoint", str(d / "clip.pt"), "--clip_merges", str(d / "clip_merges.txt"),
            "--valid_json_path", str(d / "captions.json"), "--image_folder_path",
            str(d / "images"), "--max_samples", "2", "--eval_batch_size", "2"]
    with pytest.raises(NotImplementedError, match="cross-attention"):
        JEV.main(args)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        evaluate.main(args + ["--device", "cpu"])
    for mod in (JSAM, TSAM):
        monkeypatch.setattr(mod.ClipGuidedCaptionSampler, "sample_batch",
                            lambda self, bundle, tensors, images: [["a cat"]] * len(images))
        monkeypatch.setattr(mod.ClipGuidedCaptionSampler, "sample",
                            lambda self, bundle, tensor, image=None: ["a cat"])
    with pytest.raises(TypeError, match="add_bos"):
        JEV.main(args)
    with pytest.raises(TypeError, match="add_bos"):
        evaluate.main(args + ["--device", "cpu"])
