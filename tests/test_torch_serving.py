"""The port's continuous-batching ServingEngine and cli/serve against the
JAX package and against the port's own static engine.

The contract, as in tests/test_serving.py: serving a request through a
slot, after any number of refills and ring wraps, gives exactly the tokens
the static engine gives for that request alone. Greedy f32 on the CPU makes
that token-exact, against the port's generate and against JAX's
ServingEngine on the same weights (the tiny GPT-2 of test_serving.py,
carried across with convert.gpt2_state_dict). JAX's random draws cannot be
reproduced by the port's serve, so sampled paths are held against the
port's generate with the same seed: with no refill, a serve draws exactly
what generate draws. On the CPU no kernel launches.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import serving as JSV
from clipcap_tpu.decode.engine import GenerationSettings as JSettings
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode import serving as TS
from clipcap_tpu_torch.decode.serving import Request, ServingEngine
from clipcap_tpu_torch.models.gpt2 import GPT2, quantize_params
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS

LM = dict(vocab_size=96, n_positions=96, n_embd=32, n_layer=2, n_head=4)
P = 5  # prefix length
EOS = 7
GREEDY = dict(max_new_tokens=12, greedy=True, eos_token_id=EOS)
SETTINGS = TE.GenerationSettings(**GREEDY)


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
def world():
    params = JG.init(jax.random.PRNGKey(0), JC.GPT2Config(**LM))
    model = convert.load(GPT2(TC.GPT2Config(**LM), device="cpu"),
                         convert.gpt2_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return params, model


def _requests(n, seed=0, caps=None, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(request_id=f"r{i}",
                prefix_embeds=rng.normal(size=(P, LM["n_embd"])).astype(np.float32),
                max_length=None if caps is None else caps[i])
            for i in range(n)]


def _engine(model, settings=SETTINGS, **kw):
    kw = {"slots": 2, "steps_per_sync": 3, **kw}
    return ServingEngine(model, TC.GPT2Config(**LM), prefix_len=P, settings=settings,
                         device="cpu", **kw)


def _solo(model, req, settings=SETTINGS, seed=0):
    """The port's static engine on one request alone."""
    if req.max_length is not None:
        settings = dataclasses.replace(settings, max_length=req.max_length)
    out = TE.generate(model, torch.from_numpy(req.prefix_embeds)[None], settings, seed=seed,
                      device="cpu")
    return out["tokens"][0, : int(out["lengths"][0])].tolist(), bool(out["stopped"][0])


def _batch(model, reqs, settings, seed=0):
    """The port's static engine on the requests as one batch (no caps)."""
    out = TE.generate(model, torch.from_numpy(np.stack([r.prefix_embeds for r in reqs])),
                      settings, seed=seed, device="cpu")
    return [(out["tokens"][i, : int(out["lengths"][i])].tolist(), bool(out["stopped"][i]))
            for i in range(len(reqs))]


def _jax_serve(params, reqs, **kw):
    kw = {"slots": 2, "steps_per_sync": 3, **kw}
    eng = JSV.ServingEngine(JG, JC.GPT2Config(**LM), prefix_len=P, settings=JSettings(**GREEDY),
                            dtype=jnp.float32, **kw)
    jreqs = [JSV.Request(r.request_id, r.prefix_embeds, r.max_length) for r in reqs]
    return eng.serve(jreqs, params)


def _same(got, want):
    assert set(got) == set(want)
    for rid in want:
        assert (got[rid]["tokens"], got[rid]["stopped"]) == \
            (want[rid]["tokens"], want[rid]["stopped"]), rid


def _no_launches():
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def test_serving_no_refill_matches_generate_and_jax(world):
    params, model = world
    reqs = _requests(4, seed=1)
    got = _engine(model, slots=4, steps_per_sync=5).serve(reqs)
    for req, (toks, stopped) in zip(reqs, _batch(model, reqs, SETTINGS)):
        assert (got[req.request_id]["tokens"], got[req.request_id]["stopped"]) == (toks, stopped)
    _same(got, _jax_serve(params, reqs, slots=4, steps_per_sync=5))
    _no_launches()


def test_serving_refill_and_ring_wrap_match_solo_and_jax(world):
    """2 slots, 7 requests with staggered caps: slots refill repeatedly and
    the global index (P + steps) wraps the ring of P + 12 + 1 = 18."""
    params, model = world
    reqs = _requests(7, seed=2, caps=[3, 9, 5, 12, 7, 4, 2])
    eng = _engine(model)
    got = eng.serve(reqs)
    assert eng.ring_len == P + 12 + 1
    assert P + eng.last_stats["steps"] > eng.ring_len
    for req in reqs:
        want, want_stopped = _solo(model, req)
        assert got[req.request_id]["tokens"] == want, req.request_id
        assert got[req.request_id]["stopped"] == want_stopped
    _same(got, _jax_serve(params, reqs))


@pytest.mark.parametrize("kw", [
    # the sampled path of test_serving.py:150 (threshold filters on the CPU)
    dict(top_p=0.9, top_k=11, repetition_penalty=1.2, temperature=0.9),
    # the Gen-B completion features of test_serving.py:173
    dict(top_p=0.95, temperature=1.1, min_length=3, force_eos_log_prob=-4.8,
         min_alternate_prob=0.01, stop_on_special=(11,), stop_token_id=5, max_stops=2),
], ids=["sampled", "genb"])
def test_serving_sampled_no_refill_matches_generate_seed(kw, world):
    _, model = world
    settings = TE.GenerationSettings(max_new_tokens=12, eos_token_id=EOS, **kw)
    reqs = _requests(4, seed=7)
    got = _engine(model, settings, slots=4, steps_per_sync=5).serve(reqs, seed=9)
    want = _batch(model, reqs, settings, seed=9)
    for req, (toks, stopped) in zip(reqs, want):
        assert (got[req.request_id]["tokens"], got[req.request_id]["stopped"]) == (toks, stopped)
    if "force_eos_log_prob" in kw:
        assert any(len(t) < 12 for t, _ in want), "no row stopped early; the test is inert"
    _no_launches()


def test_serving_fused_step_takes_the_threshold_path_on_cpu(world):
    """filter_method="fused_step" launches K3 only on CUDA: on the CPU its
    serve equals "threshold"'s, across refills, as in the static engine."""
    _, model = world
    base = TE.GenerationSettings(max_new_tokens=12, eos_token_id=EOS, top_p=0.9,
                                 repetition_penalty=1.2, min_length=2, temperature=0.9)
    reqs = _requests(4, seed=12, caps=[4, 9, 6, 3])
    outs = [_engine(model, dataclasses.replace(base, filter_method=m), steps_per_sync=4)
            .serve(reqs, seed=3) for m in ("fused_step", "threshold")]
    _same(*outs)
    _no_launches()


def test_serving_prefix_pool_matches_host_path(world):
    _, model = world
    host_reqs = _requests(5, seed=4, caps=[4, 9, 6, 12, 3])
    eng = _engine(model, steps_per_sync=4)
    want = eng.serve(host_reqs)
    pool = torch.from_numpy(np.stack([r.prefix_embeds for r in host_reqs]))
    got = eng.serve([dataclasses.replace(r, prefix_embeds=i) for i, r in enumerate(host_reqs)],
                    prefix_pool=pool)
    _same(got, want)


def test_serving_chunk_ladder_matches_solo(world):
    _, model = world
    reqs = _requests(9, seed=31, caps=[3, 6, 5, 2, 4, 6, 1, 5, 3])
    eng = _engine(model, steps_per_sync=4, chunk_sizes=(4, 2, 1))
    got = eng.serve(reqs)
    assert len(eng.last_stats["chunks"]) > 1  # the ladder engaged
    for req in reqs:
        want, want_stopped = _solo(model, req)
        assert (got[req.request_id]["tokens"], got[req.request_id]["stopped"]) == \
            (want, want_stopped), req.request_id


@pytest.mark.parametrize("depth,seed,caps", [
    # the pipelined loop against the synchronous one: slots are harvested
    # and refilled while up to 3 older chunks are in flight
    (4, 5, [2, 8, 3, 12, 5, 1, 4, 6, 2, 7]),
    # eager retirement: slots refilled before their previous occupant's
    # stopping chunk is harvested; the pending map carries its tokens
    (6, 13, [2, 8, 3, 12, 5, 1, 4, 6, 2, 7, 3, 9]),
], ids=["pipelined", "eager_retirement"])
def test_serving_pipeline_depth_matches_sync_loop_and_solo(depth, seed, caps, world):
    _, model = world
    reqs = _requests(len(caps), seed=seed, caps=caps)
    deep = _engine(model, steps_per_sync=1, pipeline_depth=depth).serve(reqs)
    sync = _engine(model, steps_per_sync=1, pipeline_depth=1).serve(reqs)
    _same(deep, sync)
    for req in reqs:
        want, want_stopped = _solo(model, req)
        assert (deep[req.request_id]["tokens"], deep[req.request_id]["stopped"]) == \
            (want, want_stopped), req.request_id


def test_serving_length_admission_matches_fifo_greedy(world):
    _, model = world
    reqs = _requests(10, seed=6, caps=[12, 2, 9, 3, 11, 4, 7, 2, 10, 5])
    eng = _engine(model)
    _same(eng.serve(list(reqs), admission="length"), eng.serve(list(reqs)))


def test_serving_lazy_generator_warmup_and_streaming(world):
    """serve() pulls from a generator in order and only as slots free up;
    after warmup(), on_result streams every result as it is harvested."""
    _, model = world
    reqs = _requests(6, seed=10, caps=[4, 9, 2, 7, 5, 3])
    eng = _engine(model).warmup()
    want = eng.serve(list(reqs))
    pulled, streamed = [], []

    def producer():
        for r in reqs:
            pulled.append(r.request_id)
            yield r

    got = eng.serve(producer(), on_result=lambda rid, res: streamed.append((rid, res)))
    assert pulled == [r.request_id for r in reqs]
    _same(got, want)
    assert {rid for rid, _ in streamed} == set(got) and len(streamed) == len(reqs)
    for rid, res in streamed:
        assert res is got[rid]


def test_serving_declared_max_request_length_matches_solo(world):
    _, model = world
    reqs = _requests(9, seed=21, caps=[3, 6, 5, 6, 2, 4, 1, 6, 3])
    eng = _engine(model, max_request_length=6)
    assert eng.ring_len == P + 7 + 1
    got = eng.serve(list(reqs))
    for req in reqs:
        want, want_stopped = _solo(model, req)
        assert (got[req.request_id]["tokens"], got[req.request_id]["stopped"]) == \
            (want, want_stopped), req.request_id
    with pytest.raises(ValueError, match="max_request_length"):
        eng.serve(_requests(2, seed=1, caps=[3, 9]))
    with pytest.raises(ValueError, match="max_request_length"):
        eng.serve(_requests(1, seed=1))  # no cap: the scan bound 12 > 6


@pytest.mark.parametrize("int8", [False, True], ids=["gpt2", "gpt2_int8"])
def test_serving_replays_no_graph_on_the_cpu(int8, world):
    """The CUDA graph step engages only on the card, for an LM that declares
    `graph_safe_ring_step`: float GPT-2 does not, GPT2Int8 does, and no
    engine on the CPU replays a graph (graph_steps 0 across refills and
    ring wraps). Float GPT-2's tokens are still each request's alone."""
    _, model = world
    lm = quantize_params(model) if int8 else model
    assert getattr(lm, "graph_safe_ring_step", False) is int8
    reqs = _requests(7, seed=2, caps=[3, 9, 5, 12, 7, 4, 2])
    eng = _engine(lm, dtype=torch.bfloat16 if int8 else None)
    got = eng.serve(reqs)
    assert eng.last_stats["graph_steps"] == 0 < eng.last_stats["steps"]
    assert eng.last_stats["refills"] and eng._graph is None
    if not int8:
        for req in reqs:
            assert (got[req.request_id]["tokens"], got[req.request_id]["stopped"]) == \
                _solo(model, req), req.request_id


def test_serving_graph_step_host_side_matches_eager(world, monkeypatch):
    """The graph step's host side, on the CPU: the capture is swapped for a
    stand-in whose replay reruns the captured step eagerly into its output
    buffer. The engine that replays it (its own ring cache, kept across
    serve calls; inputs copied into static buffers; the ring index filled
    from the host; refills pasting into the step's logits buffer) serves
    exactly the eager engine's sampled tokens over two serve calls with
    refills and ring wraps, and counts every decode step as a graph step."""

    class StandIn:
        def __init__(self, step):
            self.step, self.out = step, step()

        def replay(self):
            self.out.copy_(self.step())

    def capture(cls, step, dev):
        graph = StandIn(step)
        return graph, graph.out

    monkeypatch.setattr(TS._GraphStep, "_capture", classmethod(capture))
    _, model = world
    lm = quantize_params(model)
    settings = TE.GenerationSettings(max_new_tokens=12, eos_token_id=EOS, top_p=0.9,
                                     repetition_penalty=1.2, temperature=0.9)
    eager = _engine(lm, settings, dtype=torch.bfloat16, steps_per_sync=4)
    graphed = _engine(lm, settings, dtype=torch.bfloat16, steps_per_sync=4)
    graphed._graphable = True  # as on the card
    graphed.warmup()
    cache = graphed._graph.cache
    for seed, caps in ((3, [3, 9, 5, 12, 7, 4, 2]), (4, [6, 2, 11, 4, 8, 3])):
        reqs = _requests(len(caps), seed=seed, caps=caps)
        want = eager.serve(reqs, seed=seed)
        _same(graphed.serve(reqs, seed=seed), want)
        st = graphed.last_stats
        assert st["graph_steps"] == st["steps"] > graphed.ring_len and st["refills"]
        assert eager.last_stats["graph_steps"] == 0
    assert graphed._graph.cache is cache  # one cache, one capture, for the engine's life


def test_serving_rejections(world):
    _, model = world
    with pytest.raises(ValueError, match="sentence-length"):
        _engine(model, dataclasses.replace(SETTINGS, desired_sentence_length=10,
                                           stop_token_id=5))
    with pytest.raises(ValueError, match="per-row top_p"):
        _engine(model, dataclasses.replace(SETTINGS, top_p=np.array([0.9, 0.8])))
    with pytest.raises(TypeError, match="ring decode"):
        ServingEngine(torch.nn.Linear(2, 2), None, prefix_len=P, settings=SETTINGS,
                      device="cpu")
    with pytest.raises(ValueError, match="admission"):
        _engine(model).serve(_requests(2, seed=1), admission="priority")
    with pytest.raises(ValueError, match="eos_token_id"):
        _engine(model, dataclasses.replace(SETTINGS, eos_token_id=None), max_request_length=3)
    with pytest.raises(ValueError, match="serving asked for"):
        ServingEngine(model, TC.GPT2Config(**LM), prefix_len=P, settings=SETTINGS)  # the card


def test_bundle_make_serving_engine_on_cpu(world):
    from clipcap_tpu_torch.models.bundle import CaptionerBundle

    map_cfg = TC.MapperConfig(dim_clip=16, dim_embedding=LM["n_embd"], prefix_length=P,
                              clip_length=4, num_layers=1, num_heads=2)
    bundle = CaptionerBundle.create(TC.CaptionerConfig(lm_type="gpt2", mapper=map_cfg),
                                    TC.GPT2Config(**LM), None, device="cpu")
    eng = bundle.make_serving_engine(SETTINGS, slots=2)
    assert (eng.dtype, eng.device.type, eng.prefix_len) == (torch.float32, "cpu", P)
    pool = bundle.project_prefix(torch.from_numpy(
        np.random.default_rng(3).normal(size=(3, 16)).astype(np.float32)))
    caps = [3, 8, 5]
    out = eng.serve([Request(i, i, max_length=c) for i, c in enumerate(caps)], prefix_pool=pool)
    assert set(out) == {0, 1, 2}
    assert all(0 < out[i]["length"] <= c for i, c in enumerate(caps))


def test_serve_shard_jsonl_matches_jax(tmp_path):
    """cli/serve.serve_shard: CLIP features -> mapper pool -> continuous
    batching -> JSONL, against the JAX serve_shard on the same weights and
    a genuine byte-level vocabulary; with and without a declared cap."""
    from clipcap_tpu.cli.serve import serve_shard as jax_serve_shard
    from clipcap_tpu.models import captioner as JCAP
    from clipcap_tpu.models.bundle import CaptionerBundle as JaxBundle
    from clipcap_tpu.tokenizers import GPT2TokenizerWrapper as JaxTok
    from clipcap_tpu.tokenizers.bpe import ByteLevelBPE as JaxBPE
    from clipcap_tpu_torch.cli.serve import serve_shard
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.tokenizers import GPT2TokenizerWrapper
    from clipcap_tpu_torch.tokenizers.bpe import ByteLevelBPE, bytes_to_unicode

    base = list(dict.fromkeys(bytes_to_unicode().values()))
    vocab = {t: i for i, t in enumerate(base + ["<|endoftext|>"])}
    lm = dict(vocab_size=len(vocab), n_positions=96, n_embd=32, n_layer=1, n_head=4)
    mp = dict(dim_clip=16, dim_embedding=32, prefix_length=3, clip_length=4, num_layers=1,
              num_heads=2)
    cap_j = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**mp))
    params = JCAP.init(jax.random.PRNGKey(0), cap_j, JC.GPT2Config(**lm))
    jax_bundle = JaxBundle(params=params, cap_cfg=cap_j, lm_cfg=JC.GPT2Config(**lm),
                           tokenizer=JaxTok(JaxBPE(vocab, [])))
    bundle = CaptionerBundle.create(TC.CaptionerConfig(lm_type="gpt2",
                                                       mapper=TC.MapperConfig(**mp)),
                                    TC.GPT2Config(**lm), GPT2TokenizerWrapper(
                                        ByteLevelBPE(vocab, [])), device="cpu")
    convert.load(bundle.model,
                 convert.captioner_state_dict(jax.tree_util.tree_map(np.asarray, params)))

    feats = np.random.default_rng(0).normal(size=(9, 16)).astype(np.float32)
    eos = len(vocab) - 1
    for name, kw in [("plain", {}), ("declared", dict(eos_token_id=eos, max_request_length=4))]:
        kw = dict(slots=4, steps_per_sync=3, map_batch=4, max_new_tokens=6, greedy=True, **kw)
        assert serve_shard(bundle, feats, str(tmp_path / f"{name}.jsonl"), **kw) == 9
        jax_serve_shard(jax_bundle, feats, str(tmp_path / f"{name}_jax.jsonl"), **kw)
        got = [json.loads(x) for x in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        want = [json.loads(x) for x in (tmp_path / f"{name}_jax.jsonl").read_text().splitlines()]
        assert got == want, name
        assert all(0 < x["tokens"] <= kw.get("max_request_length", 6) for x in got)
    _no_launches()


def test_pick_slots_for_p50():
    from clipcap_tpu_torch.cli.serve import pick_slots_for_p50

    curve = {128: 0.6, 256: 1.1, 512: 1.4}
    assert pick_slots_for_p50(2.0, curve) == 512  # everything fits: most throughput
    assert pick_slots_for_p50(1.2, curve) == 256
    assert pick_slots_for_p50(0.7, curve) == 128
    assert pick_slots_for_p50(0.1, curve) == 128  # nothing fits: the floor
