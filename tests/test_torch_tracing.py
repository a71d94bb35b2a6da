"""The port's span recorder (utils/profiling.py) and the spans the serving
engine, beam search, the bundle, the kernel build and cli.serve record with
it, on the CPU at tiny sizes: nesting and parents, request phases kept
apart from call-stack spans, nothing recorded with no tracer active, every
harvested request's phases in order, and the same tokens and beams with
the tracer on and off."""

import json
import stat
import sys

import numpy as np
import pytest
import torch

from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import beam as TB
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode.serving import Request, ServingEngine
from clipcap_tpu_torch.models.bundle import CaptionerBundle
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.ops.kernels import _build
from clipcap_tpu_torch.utils import profiling as P

LM = dict(vocab_size=96, n_positions=96, n_embd=32, n_layer=2, n_head=4)
PREFIX = 5
STEP_TILES = ("serving.step.sample", "serving.step.book", "serving.step.lm")
PHASES = ("serving.request.admit", "serving.request.decode", "serving.request.harvest")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_tracer_left_on():
    assert P.active() is None
    yield
    assert P.stop() is None, "a test left a tracer active"


@pytest.fixture(scope="module")
def lm():
    return GPT2(TC.GPT2Config(**LM), device="cpu", seed=3)


def _requests(n, arrival_ns=None, seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(2, 9, n)
    return [Request(request_id=f"r{i}",
                    prefix_embeds=rng.normal(size=(PREFIX, LM["n_embd"])).astype(np.float32),
                    max_length=int(caps[i]), arrival_ns=arrival_ns)
            for i in range(n)]


def _engine(lm, **settings):
    settings = TE.GenerationSettings(**{"max_new_tokens": 10, "eos_token_id": 7, "greedy": True,
                                        **settings})
    return ServingEngine(lm, TC.GPT2Config(**LM), prefix_len=PREFIX, settings=settings,
                         device="cpu", slots=3, steps_per_sync=3)


def _serve(eng, reqs, seed=0):
    res = eng.serve(reqs, seed=seed)
    return {k: (v["tokens"], v["length"], v["stopped"]) for k, v in res.items()}


# ---- the recorder -------------------------------------------------------------------


def test_tracer_nests_spans_and_keeps_intervals_apart(tmp_path):
    tr = P.Tracer()
    outer = tr.begin("outer", 100)
    with tr.span("inner", k=2):
        tr.add("tile", 150, 160)
        tr.interval("phase", 120, 900, request_id="a")
    tr.end(1000)
    assert [s.name for s in tr.spans] == ["outer", "inner", "tile"]
    o, i, t = tr.spans
    assert (o.parent, i.parent, t.parent) == (None, outer, 1)
    assert (o.start_ns, o.end_ns) == (100, 1000) and i.attrs == {"k": 2}
    assert [(s.name, s.request_id, s.parent) for s in tr.intervals] == [("phase", "a", 1)]
    assert tr.named("phase")[0].seconds == pytest.approx(780e-9)
    assert tr.summary()["tile"]["count"] == 1
    assert tr.write_jsonl(str(tmp_path / "s.jsonl")) == 4
    lines = [json.loads(x) for x in (tmp_path / "s.jsonl").read_text().splitlines()]
    assert [x["kind"] for x in lines] == ["stack"] * 3 + ["interval"]
    assert lines[1]["k"] == 2 and lines[3]["request_id"] == "a"


def test_active_tracer_switches_on_and_off():
    assert P.span("x") is P.NULL  # the shared no-op
    calls = []

    @P.traced("f")
    def f(v):
        calls.append(v)
        return v + 1

    assert f(1) == 2
    with P.tracing() as tr:
        assert P.active() is tr
        with pytest.raises(RuntimeError):
            P.start()
        with P.span("outer"):
            assert f(2) == 3
    assert P.active() is None and calls == [1, 2]
    assert [(s.name, s.parent) for s in tr.spans] == [("outer", None), ("f", 0)]
    f(3)
    assert len(tr.spans) == 2  # a stopped tracer sees nothing more


# ---- the serving engine -------------------------------------------------------------


@pytest.mark.parametrize("stamped", [False, True])
def test_serving_records_each_request_phase_in_order(lm, stamped):
    eng = _engine(lm)
    arrival = P.now_ns() if stamped else None
    reqs = _requests(8, arrival_ns=arrival)
    with P.tracing() as tr:
        res = eng.serve(reqs)
    assert set(res) == {r.request_id for r in reqs}
    by = {}
    for s in tr.intervals:
        by.setdefault(s.request_id, {}).setdefault(s.name, []).append(s)
    want = set(PHASES) | ({"serving.request.queued"} if stamped else set())
    for r in reqs:
        phases = by[r.request_id]
        assert set(phases) == want and all(len(v) == 1 for v in phases.values())
        admit, decode, harvest = (phases[n][0] for n in PHASES)
        if stamped:
            queued = phases["serving.request.queued"][0]
            assert queued.start_ns == arrival and queued.end_ns == admit.start_ns
        # arrival <= pulled <= assigned <= stop chunk's dispatch <= harvest
        assert admit.start_ns <= admit.end_ns == decode.start_ns <= decode.end_ns
        assert decode.end_ns == harvest.start_ns <= harvest.end_ns
        assert res[r.request_id]["latency_s"] == pytest.approx(
            (harvest.end_ns - admit.end_ns) / 1e9, abs=1e-3)
    names = [s.name for s in tr.spans]
    assert names[0] == "serving.serve" and tr.spans[0].parent is None
    steps = eng.last_stats["steps"]
    assert steps > 0 and "wall_s" not in eng.last_stats
    for tile in STEP_TILES:
        assert names.count(tile) == steps
    chunks = {i for i, s in enumerate(tr.spans) if s.name == "serving.chunk"}
    assert len(chunks) == sum(eng.last_stats["chunks"].values())
    assert all(s.parent in chunks for s in tr.spans if s.name in STEP_TILES)
    refills = [s for s in tr.spans if s.name == "serving.refill"]
    assert len(refills) == sum(eng.last_stats["refills"].values()) > 0
    assert all(set(s.attrs) == {"r", "n_real"} and s.attrs["n_real"] <= s.attrs["r"]
               for s in refills)
    assert names.count("serving.harvest_wait") == len(chunks)
    # each step's tiles abut: sample, book, lm
    tiles = [s for s in tr.spans if s.name in STEP_TILES]
    for a, b, c in zip(tiles[0::3], tiles[1::3], tiles[2::3]):
        assert (a.name, b.name, c.name) == STEP_TILES
        assert a.end_ns == b.start_ns and b.end_ns == c.start_ns


@pytest.mark.parametrize("sampled", [False, True])
def test_serving_tokens_equal_with_tracer_on_and_off(lm, sampled):
    kw = dict(greedy=False, top_p=0.9, repetition_penalty=1.2) if sampled else {}
    eng = _engine(lm, **kw)
    eng.warmup()
    off = _serve(eng, _requests(7, seed=1), seed=5)
    with P.tracing() as tr:
        on = _serve(eng, _requests(7, seed=1), seed=5)
    assert on == off and tr.spans
    again = P.Tracer()  # never started: the untraced serve leaves it empty
    assert _serve(eng, _requests(7, seed=1), seed=5) == off
    assert not again.spans and not again.intervals


def test_serving_warmup_span_and_live_stats(lm):
    eng = _engine(lm)
    with P.tracing() as tr:
        eng.warmup()
    assert tr.spans[0].name == "serving.warmup"
    assert {s.name for s in tr.spans[1:]} <= set(STEP_TILES)  # warm-up chunks, no serve
    assert eng.stats is None and eng.last_stats is None
    seen = []  # (the engine's stats object, its step count) at each result
    eng.serve(_requests(6), on_result=lambda rid, res: seen.append((eng.stats,
                                                                    eng.stats["steps"])))
    assert len(seen) == 6 and all(st is eng.last_stats for st, _ in seen)
    steps = [n for _, n in seen]
    assert steps[0] > 0 and steps == sorted(steps) and steps[-1] <= eng.last_stats["steps"]
    assert len(set(steps)) > 1  # counted up in place while the call ran


# ---- beam search, the bundle, the kernel build ----------------------------------------


def test_beam_step_spans_and_equal_results(lm):
    prompt = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, PREFIX, LM["n_embd"])).astype(np.float32))
    kw = dict(beam_size=3, max_new_tokens=6, stop_token_id=11, device="cpu")
    off = TB.beam_search_batched(lm, prompt, **kw)
    with P.tracing() as tr:
        on = TB.beam_search_batched(lm, prompt, **kw)
        TB.beam_search(lm, prompt[:1], **kw)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    names = [s.name for s in tr.spans]
    assert names.count("beam.search") == 2
    assert names.count("beam.step") == 2 * (kw["max_new_tokens"] - 1)
    assert names.count("beam.step.select") == 2 * (kw["max_new_tokens"] - 1)
    assert names.count("beam.step.lm") == 2 * (kw["max_new_tokens"] - 2)
    steps = {i for i, s in enumerate(tr.spans) if s.name == "beam.step"}
    searches = {i for i, s in enumerate(tr.spans) if s.name == "beam.search"}
    assert all(tr.spans[i].parent in searches for i in steps)
    assert all(s.parent in steps for s in tr.spans if s.name.startswith("beam.step."))


def test_bundle_set_up_spans():
    cap = TC.CaptionerConfig(lm_type="gpt2", visual_encoder_type="none",
                             mapper=TC.MapperConfig(dim_clip=8, dim_embedding=LM["n_embd"],
                                                    prefix_length=2, clip_length=2,
                                                    num_layers=1, num_heads=2))
    with P.tracing() as tr:
        bundle = CaptionerBundle.create(cap, TC.GPT2Config(**LM), None, device="cpu")
        prefix = bundle.project_prefix(torch.zeros(4, 8))
        bundle.enable_int8_decode()
    assert prefix.shape == (4, 2, LM["n_embd"])
    assert [s.name for s in tr.spans if s.parent is None] == [
        "bundle.create", "bundle.map", "bundle.int8_quantize"]


def test_kernel_build_records_each_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with P.tracing() as tr:
        _build.build(["fused_sampler", "fused_attention"])
        _build.build(["fused_sampler"])  # built already: no nvcc
    builds = tr.named("kernels.build")
    assert sorted(s.attrs["kernel"] for s in builds) == ["fused_attention", "fused_sampler"]
    assert not tr.spans and all(s.end_ns >= s.start_ns for s in builds)


# ---- cli.serve --spans_jsonl --------------------------------------------------------


def test_serve_main_writes_spans(tmp_path, capsys):
    from clipcap_tpu_torch.cli import serve
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint

    base = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(base + ["<|endoftext|>"])}
    (tmp_path / "vocab").mkdir()
    (tmp_path / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "vocab" / "merges.txt").write_text("#version: 0.2\n")
    lm_cfg = TC.GPT2Config(vocab_size=len(vocab), n_positions=64, n_embd=32, n_layer=1,
                           n_head=2)
    cap = TC.CaptionerConfig(lm_type="gpt2", visual_encoder_type="none",
                             mapper=TC.MapperConfig(dim_clip=8, dim_embedding=32, prefix_length=2,
                                                    clip_length=2, num_layers=1, num_heads=2))
    save_checkpoint(str(tmp_path / "ckpt"), Captioner(cap, lm_cfg, device="cpu"), cap, lm_cfg)
    np.save(tmp_path / "feats.npy", np.random.default_rng(0).normal(size=(5, 8)).astype(
        np.float32))
    args = ["--checkpoint_path", str(tmp_path / "ckpt"), "--tokenizer_vocab_dir",
            str(tmp_path / "vocab"), "--prefixes_npy", str(tmp_path / "feats.npy"),
            "--slots", "2", "--steps_per_sync", "2", "--max_new_tokens", "4", "--device", "cpu"]
    assert serve.main(args + ["--out_jsonl", str(tmp_path / "off.jsonl")]) == 5
    assert serve.main(args + ["--out_jsonl", str(tmp_path / "on.jsonl"),
                              "--spans_jsonl", str(tmp_path / "spans.jsonl")]) == 5
    assert (tmp_path / "on.jsonl").read_text() == (tmp_path / "off.jsonl").read_text()
    recs = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    names = [r["name"] for r in recs]
    assert names.count("serving.serve") == 1 and "bundle.map" in names
    for phase in ("serving.request.queued",) + PHASES:
        assert sorted(r["request_id"] for r in recs if r["name"] == phase) == list(range(5))
    out = capsys.readouterr().out
    assert "serving.request.harvest: p50 " in out and "serving.request.queued: p50 " in out
