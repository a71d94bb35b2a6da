"""BLIP behind the port's ServingEngine (token-id ring decode) and BLIP
token-mode beam search, against the JAX package on the CPU.

- the ring step and scatter_refill of `serving_decoder_lm` against JAX's
  `decode_step_ring` and `scatter_refill`, through refills and a ring wrap,
  logits within 1e-5;
- ServingEngine in token mode on JAX's own case
  (tests/test_serving.py::test_serving_blip_token_mode_matches_individual_runs:
  6 requests, caps 2-12, 2 slots, refills and a ring wrap): the tokens of
  JAX's serve and of the port's solo decoder_lm runs, exactly;
- sampled serves with no refill equal the port's generate(seed=...) (JAX's
  random draws cannot be replayed), the Gen-B completion knobs included;
- the int8 adapter's greedy serve against JAX's int8 adapter: equal up to
  JAX's own near-ties (a flip only where JAX's top-2 gap lies within the
  int8 logit bound of tests/test_torch_blip_text.py);
- BLIP token-mode beam search against JAX's beam_search and
  beam_search_batched (tokens exact, scores within 1e-4) and against the
  rebuild oracle of tests/test_beam_cross_attention.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import beam as JBEAM
from clipcap_tpu.decode import serving as JSV
from clipcap_tpu.decode.engine import GenerationSettings as JSettings
from clipcap_tpu.models import blip_text as JB
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import beam as TBEAM
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode.serving import Request, ServingEngine
from clipcap_tpu_torch.models import blip_text as TB
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS

from test_beam_cross_attention import oracle_beam

# the BLIP config of tests/test_serving.py and tests/test_beam_cross_attention.py
CFG = dict(vocab_size=83, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
           encoder_width=16, embed_dim=16)
TV, PROMPT, EOS = 5, [30, 11, 2], 3
CAPS = [3, 9, 5, 12, 4, 2]
GREEDY = dict(max_new_tokens=12, greedy=True, eos_token_id=EOS)
RTOL, ATOL = 1e-5, 1e-5
BF16_STEP, INT8_STEPS = 2.0 ** -8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    """JAX's init of test_serving.py's BLIP decoder, converted to the port,
    and its six requests' image features."""
    jcfg = JC.BlipTextConfig(**CFG)
    params = JB.init(jax.random.PRNGKey(1), jcfg)
    text = convert.load(TB.BlipText(TC.BlipTextConfig(**CFG), device="cpu"),
                        convert.blip_text_state_dict(_np(params)))
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(TV, 16)).astype(np.float32) for _ in range(6)]
    return params, text, feats


def _engine(lm, settings, **kw):
    kw = {"slots": 2, "steps_per_sync": 3, **kw}
    return ServingEngine(lm, TC.BlipTextConfig(**CFG), prefix_len=TV, prompt_len=len(PROMPT),
                         settings=settings, device="cpu", **kw)


def _jax_serve(params, feats, caps, **kw):
    jcfg = JC.BlipTextConfig(**CFG)
    lm = JB.serving_decoder_lm(params, jcfg, PROMPT, num_image_tokens=TV)
    eng = JSV.ServingEngine(lm, jcfg, prefix_len=TV, prompt_len=len(PROMPT),
                            settings=JSettings(**GREEDY), slots=2, steps_per_sync=3,
                            dtype=jnp.float32, **kw)
    return eng.serve([JSV.Request(i, f, max_length=c)
                      for i, (f, c) in enumerate(zip(feats, caps))], params)


def _solo(text, feat, settings, seed=0):
    """The port's static engine on one request alone, by decoder_lm."""
    lm = TB.decoder_lm(text, torch.from_numpy(feat)[None])
    out = TE.generate(lm, torch.tensor([PROMPT]), settings, seed=seed, device="cpu")
    return out["tokens"][0, : int(out["lengths"][0])].tolist()


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def test_ring_step_and_refill_match_jax(world):
    """Two rows prefilled into a ring of 3 + 5 + 1 positions, ring steps at
    per-row positions, a one-row refill at slot 1 and steps until the
    global index has wrapped the ring: every step's logits against JAX's."""
    params, text, feats = world
    jcfg = JC.BlipTextConfig(**CFG)
    jlm = JB.serving_decoder_lm(params, jcfg, PROMPT, num_image_tokens=TV)
    tlm = TB.serving_decoder_lm(text, PROMPT, TV, device="cpu")
    p, ring = len(PROMPT), len(PROMPT) + 5 + 1
    two = np.stack(feats[:2])
    jc = jlm.init_cache(jcfg, batch=2, max_len=ring)
    jl, jc = jlm.prefill(params, jcfg, jnp.asarray(two), jc)
    tc = tlm.init_cache(2, ring)
    tl, tc = tlm.prefill(torch.from_numpy(two), tc)
    _close(tl[:, -1], jl[:, -1], "prefill")
    pos, start = np.array([p, p]), np.array([0, 0])
    rng = np.random.default_rng(3)
    for step in range(12):
        if step == 4:  # refill slot 1 with request 2 (JAX's serving._refill)
            js = jlm.init_cache(jcfg, batch=1, max_len=p)
            _, js = jlm.prefill(params, jcfg, jnp.asarray(feats[2][None]), js)
            jc = jlm.scatter_refill(jc, js, 1)
            ts = tlm.init_cache(1, p)
            _, ts = tlm.prefill(torch.from_numpy(feats[2][None]), ts)
            tc = tlm.scatter_refill(tc, ts, 1)
            assert tc.index == int(jc.index)
            pos[1], start[1] = p, tc.index - p
        ids = rng.integers(0, CFG["vocab_size"], 2)
        jl, jc = jlm.decode_step_ring(params, jcfg, jnp.asarray(ids)[:, None], jc,
                                      jnp.asarray(pos, jnp.int32), jnp.asarray(start, jnp.int32))
        tl, tc = tlm.decode_step_ring(torch.from_numpy(ids)[:, None], tc, torch.from_numpy(pos),
                                      torch.from_numpy(start))
        _close(tl, jl, f"ring step {step}")
        pos += 1
    assert tc.index > ring  # the global index wrapped the ring
    _close(tc.cross_k, jc.cross_k, "cross K after the refill")


def test_ring_step_refuses_prefill_and_grouped_rows(world):
    _, text, feats = world
    lm = TB.serving_decoder_lm(text, PROMPT, TV, device="cpu")
    cache = lm.init_cache(2, 9)
    zeros = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="decode-only"):
        text.forward_cached(torch.zeros(2, 2, dtype=torch.int64), cache, ring=(zeros, zeros))
    with pytest.raises(ValueError, match="grouped cross-attention"):
        text.forward_cached(torch.zeros(2, 1, dtype=torch.int64), cache, cross_repeat=2,
                            ring=(zeros, zeros))
    with pytest.raises(ValueError, match="asked for cuda"):
        TB.serving_decoder_lm(text, PROMPT, TV)  # the card unless asked for the CPU


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warmup"])
def test_serving_token_mode_matches_jax_and_solo(world, warm):
    """JAX's case: 6 requests, caps 2-12, 2 slots, 3 steps a sync: slots
    refill and the global index wraps the ring of 3 + 12 + 1."""
    params, text, feats = world
    settings = TE.GenerationSettings(**GREEDY)
    eng = _engine(TB.serving_decoder_lm(text, PROMPT, TV, device="cpu"), settings)
    assert eng.token_mode and eng.ring_len == len(PROMPT) + 12 + 1 and eng.dtype == torch.float32
    if warm:  # dummy prefixes of the image encoder's width, not the LM's
        eng.warmup()
    before = dict(FS.LAUNCHES)
    got = eng.serve([Request(i, f, max_length=c) for i, (f, c) in enumerate(zip(feats, CAPS))])
    assert len(PROMPT) + eng.last_stats["steps"] > eng.ring_len
    assert sum(eng.last_stats["refills"].values()) >= 2
    want = _jax_serve(params, feats, CAPS)
    for i, (f, c) in enumerate(zip(feats, CAPS)):
        assert got[i]["tokens"] == want[i]["tokens"], i
        assert got[i]["stopped"] == want[i]["stopped"], i
        assert got[i]["tokens"] == _solo(text, f, dataclasses.replace(settings, max_length=c)), i
    assert FS.LAUNCHES == before  # on the CPU no kernel launches


def test_serving_prefix_pool_of_features_matches_host_path(world):
    _, text, feats = world
    settings = TE.GenerationSettings(**GREEDY)
    lm = TB.serving_decoder_lm(text, PROMPT, TV, device="cpu")
    host = _engine(lm, settings).serve(
        [Request(i, f, max_length=c) for i, (f, c) in enumerate(zip(feats, CAPS))])
    pooled = _engine(lm, settings).serve(
        [Request(i, i, max_length=c) for i, c in enumerate(CAPS)],
        prefix_pool=torch.from_numpy(np.stack(feats)))
    assert {i: r["tokens"] for i, r in pooled.items()} == {i: r["tokens"] for i, r in host.items()}


@pytest.mark.parametrize("kw", [
    # the sampled path of test_serving.py:150 (threshold filters on the CPU)
    dict(top_p=0.9, top_k=11, repetition_penalty=1.2, temperature=0.9),
    # the Gen-B completion knobs of test_serving.py:173 under serving
    dict(top_p=0.95, temperature=1.1, min_length=3, force_eos_log_prob=-4.4,
         min_alternate_prob=0.01, stop_on_special=(11,), stop_token_id=5, max_stops=2),
    # Gen B's own step on the plain path: penalty 1.3, top-k, min length, "fused_step"
    dict(top_k=40.0, top_p=0.5, repetition_penalty=1.3, min_length=3,
         force_eos_log_prob=float(np.log(0.9)), filter_method="fused_step"),
], ids=["sampled", "genb_knobs", "genb_fused_step"])
def test_serving_sampled_no_refill_matches_generate_seed(world, kw):
    """4 requests on 4 slots: the serve draws what generate draws. A
    force-eos stop rescued by the alternate token emits nothing that step;
    generate marks it with the pad id (here -1), serving leaves it out."""
    _, text, feats = world
    settings = TE.GenerationSettings(max_new_tokens=12, eos_token_id=EOS, pad_token_id=-1, **kw)
    reqs = [Request(i, f) for i, f in enumerate(feats[:4])]
    got = _engine(TB.serving_decoder_lm(text, PROMPT, TV, device="cpu"), settings, slots=4,
                  steps_per_sync=5).serve(reqs, seed=9)
    lm = TB.decoder_lm(text, torch.from_numpy(np.stack(feats[:4])))
    out = TE.generate(lm, torch.tensor([PROMPT] * 4), settings, seed=9, device="cpu")
    lengths = out["lengths"].tolist()
    for i in range(4):
        emitted = [t for t in out["tokens"][i].tolist() if t >= 0]
        assert got[i]["tokens"] == emitted and len(emitted) == lengths[i], i
        assert got[i]["stopped"] == bool(out["stopped"][i]), i
    if "force_eos_log_prob" in kw and "filter_method" not in kw:
        assert min(lengths) < 12, "no row stopped early; the test is inert"


def _jax_greedy_gaps(lm, params, jcfg, feat, n):
    """JAX's solo greedy run of one request: each step's top-2 logit gap."""
    solo = lm(params, jcfg, jnp.asarray(feat)[None])
    cache = solo.init_cache(jcfg, batch=1, max_len=len(PROMPT) + n + 1)
    logits, cache = solo.prefill(params, jcfg, jnp.asarray([PROMPT], jnp.int32), cache)
    logits, gaps, scale = logits[:, -1], [], 0.0
    for _ in range(n):
        lg = np.asarray(logits[0], np.float32)
        top2 = np.sort(lg)[-2:]
        gaps.append(float(top2[1] - top2[0]))
        scale = max(scale, float(np.abs(lg).max()))
        tok = jnp.argmax(logits, axis=-1)
        logits, cache = solo.decode_step(params, jcfg, tok[:, None].astype(jnp.int32), cache)
    return gaps, scale


def test_int8_serving_matches_jax_int8_adapter(world):
    """The port's int8 decoder behind ServingEngine against JAX's int8 tree
    behind JAX's engine: greedy tokens equal, but where JAX's own solo run
    has a near-tie (top-2 gap within the int8 logit bound)."""
    params, text, feats = world
    jcfg = JC.BlipTextConfig(**CFG)
    q8 = TB.quantize_params(text)
    settings = TE.GenerationSettings(**GREEDY)
    got = _engine(TB.serving_decoder_lm(q8, PROMPT, TV, device="cpu"), settings).serve(
        [Request(i, f, max_length=c) for i, (f, c) in enumerate(zip(feats, CAPS))])
    jq = JB.quantize_params(params)
    want = _jax_serve(jq, feats, CAPS)
    flips = 0
    for i in range(len(feats)):
        a, b = got[i]["tokens"], want[i]["tokens"]
        if a != b:
            s = next(j for j in range(max(len(a), len(b)))
                     if j >= len(a) or j >= len(b) or a[j] != b[j])
            gaps, scale = _jax_greedy_gaps(JB.decoder_lm, jq, jcfg, feats[i], s + 1)
            assert gaps[s] <= INT8_STEPS * BF16_STEP * scale, (i, s, gaps[s])
            flips += 1
    assert flips <= 1


@pytest.fixture(scope="module")
def beam_world():
    """tests/test_beam_cross_attention.py's BLIP setup, converted."""
    jcfg = JC.BlipTextConfig(**CFG)
    params = JB.init(jax.random.PRNGKey(1), jcfg)
    text = convert.load(TB.BlipText(TC.BlipTextConfig(**CFG), device="cpu"),
                        convert.blip_text_state_dict(_np(params)))
    img = np.random.default_rng(2).normal(size=(1, 5, 16)).astype(np.float32)
    return params, text, img


def test_blip_token_mode_beam_matches_jax_and_rebuild_oracle(beam_world):
    params, text, img = beam_world
    jcfg = JC.BlipTextConfig(**CFG)
    prompt = [[2, 11, 12]]
    n, beam = 6, 3
    want = JBEAM.beam_search(JB.decoder_lm(params, jcfg, jnp.asarray(img)), params, jcfg,
                             jnp.asarray(prompt), beam_size=beam, max_new_tokens=n)
    lm = TB.decoder_lm(text, torch.from_numpy(img))
    got = TBEAM.beam_search(lm, torch.tensor(prompt), beam_size=beam, max_new_tokens=n,
                            device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["seq_lengths"].numpy(), np.asarray(want["seq_lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-4)

    def last_logits(history):
        cache = lm.init_cache(1, 3 + n)
        logits, cache = lm.prefill(torch.tensor(prompt), cache)
        out = logits[:, -1]
        for tok in history:
            out, cache = lm.decode_step(torch.tensor([[tok]]), cache)
        return out[0].numpy().astype(np.float32)

    oracle_tokens, oracle_scores = oracle_beam(last_logits, beam, n)
    np.testing.assert_array_equal(got["tokens"].numpy(), oracle_tokens)
    np.testing.assert_allclose(got["scores"].numpy(), oracle_scores, atol=1e-4)


def test_blip_token_mode_beam_batched_matches_jax(beam_world):
    """Three images x beam 4 with a stop token, in one batched search."""
    params, text, _ = beam_world
    jcfg = JC.BlipTextConfig(**CFG)
    imgs = np.random.default_rng(7).normal(size=(3, 5, 16)).astype(np.float32)
    prompt = [[2, 11, 12]] * 3
    kw = dict(beam_size=4, max_new_tokens=7, stop_token_id=EOS)
    want = JBEAM.beam_search_batched(JB.decoder_lm(params, jcfg, jnp.asarray(imgs)), params,
                                     jcfg, jnp.asarray(prompt), **kw)
    got = TBEAM.beam_search_batched(TB.decoder_lm(text, torch.from_numpy(imgs)),
                                    torch.tensor(prompt), device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["seq_lengths"].numpy(), np.asarray(want["seq_lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-4)
