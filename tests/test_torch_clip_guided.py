"""CLIP-guided lookahead decode on the CPU (decode/clip_guided.py): the
port gives the JAX package's generate_clip_guided_batch tokens exactly in
f32, committing whole lookaheads and step by step, with a hashing stub for
CLIP, with one that always prefers the shortest candidate (so an
early-stopped leaf is chosen) and with one that prefers leaves that stopped
below level 0; a batch of images equals single calls;
the port equals a naive whole-sequence transcription of the reference
search (as tests/test_clip_guided.py holds JAX); the host reads the device
twice per chunk and never inside the level loop; cross-attention caches
are refused. Weights are seeded in the port and handed to JAX in its
layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import clip_guided as JCG
from clipcap_tpu.models.bundle import CaptionerBundle as JaxBundle
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import clip_guided as CG
from clipcap_tpu_torch.models.bundle import CaptionerBundle
from clipcap_tpu_torch.ops.sampling import repetition_penalty

LM = dict(vocab_size=37, n_positions=96, n_embd=32, n_layer=2, n_head=4)
MAPPER = dict(dim_clip=16, dim_embedding=32, prefix_length=4, clip_length=4, num_layers=1,
              num_heads=2)
SPECIAL = (0, 1, 2, 3)
KW = dict(max_decode_length=9, look_ahead=3, branching_factor=2, repetition_penalty_value=1.2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Tok:
    bos_token_id = 3
    all_special_ids = SPECIAL

    def decode_tokens(self, ids):
        return " ".join(str(int(i)) for i in ids)


class StubScoring:
    """A deterministic 'CLIP': hashed bigram features of the text (numpy,
    which both packages take)."""

    def embed_text(self, texts):
        feats = []
        for t in texts:
            h = np.zeros(8, np.float32)
            for i, tok in enumerate(t.split()):
                h[(int(tok) + i) % 8] += 1.0 + int(tok) * 0.01
            feats.append(h)
        return np.stack(feats)


class ShortestScoring:
    """Always prefers the shortest candidate text, so the chosen candidate
    is an early-stopped leaf wherever one exists."""

    def embed_text(self, texts):
        feats = np.zeros((len(texts), 2), np.float32)
        for i, t in enumerate(texts):
            feats[i, 0] = 1.0 / (1 + len(t.split()))
        return feats


class StopScoring:
    """Prefers a text of 2 words mod 3: with look-ahead 3 only an
    early-stopped leaf has that length in most chunks, so a leaf that stopped
    below level 0 is chosen wherever one exists."""

    def embed_text(self, texts):
        feats = np.zeros((len(texts), 2), np.float32)
        for i, t in enumerate(texts):
            h = sum(int(x) for x in t.split()) % 7 * 0.01
            feats[i] = (1.0, h) if len(t.split()) % 3 == 2 else (0.1, 1.0 + h)
        return feats


SCORINGS = {"stub": StubScoring(), "shortest": ShortestScoring(), "stops": StopScoring()}


@pytest.fixture(scope="module")
def bundles():
    """The same captioner in both packages, seeded in the port (wte scaled
    up, so the images' captions differ and finish at different chunks)."""
    cap_t = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAPPER))
    port = CaptionerBundle.create(cap_t, TC.GPT2Config(**LM), Tok(), seed=1, device="cpu")
    with torch.no_grad():
        port.model.lm.wte.mul_(5.0)
    params = jax.tree_util.tree_map(jnp.asarray, convert.captioner_params(port.model))
    jax_bundle = JaxBundle(params=params,
                           cap_cfg=JC.CaptionerConfig(lm_type="gpt2",
                                                      mapper=JC.MapperConfig(**MAPPER)),
                           lm_cfg=JC.GPT2Config(**LM), tokenizer=Tok())
    return port, jax_bundle


def _inputs(scoring: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if scoring == "shortest":
        imgs = np.tile(np.asarray([1.0, 0.1], np.float32), (n, 1))
    elif scoring == "stops":
        imgs = np.tile(np.asarray([1.0, 0.0], np.float32), (n, 1))
    else:
        imgs = np.arange(n * 8, dtype=np.float32).reshape(n, 8) + 1.0
    prefix = (rng.normal(size=(n, MAPPER["prefix_length"], LM["n_embd"])) * 0.3).astype(np.float32)
    return imgs, prefix


@pytest.mark.parametrize("step_by_step", [False, True])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_batch_matches_jax(bundles, scoring, step_by_step):
    port, jax_bundle = bundles
    imgs, prefix = _inputs(scoring, 3, 5)
    want = JCG.generate_clip_guided_batch(jax_bundle, SCORINGS[scoring], jnp.asarray(imgs),
                                          jnp.asarray(prefix), step_by_step=step_by_step, **KW)
    toks = CG.generate_clip_guided_tokens(port, SCORINGS[scoring], torch.from_numpy(imgs),
                                          torch.from_numpy(prefix), step_by_step=step_by_step,
                                          device="cpu", **KW)
    got = [Tok().decode_tokens([t for t in c if t not in SPECIAL]) for c in toks]
    assert got == want
    assert got == CG.generate_clip_guided_batch(
        port, SCORINGS[scoring], torch.from_numpy(imgs), torch.from_numpy(prefix),
        step_by_step=step_by_step, device="cpu", **KW)


@pytest.mark.parametrize("step_by_step", [False, True])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_batch_matches_singles(bundles, scoring, step_by_step):
    """Images that finish at different chunk counts ride along as ignored
    rows; each image's caption equals its single call."""
    port, _ = bundles
    imgs, prefix = _inputs(scoring, 3, 7)
    singles = [CG.generate_clip_guided(port, SCORINGS[scoring], torch.from_numpy(imgs[i]),
                                       torch.from_numpy(prefix[i:i + 1]),
                                       step_by_step=step_by_step, device="cpu", **KW)
               for i in range(3)]
    batched = CG.generate_clip_guided_batch(port, SCORINGS[scoring], torch.from_numpy(imgs),
                                            torch.from_numpy(prefix),
                                            step_by_step=step_by_step, device="cpu", **KW)
    assert batched == singles


def naive_clip_guided(bundle, scoring, img, prefix, max_decode_length, look_ahead, branching,
                      rep_penalty, step_by_step):
    """A direct transcription of the reference tree search (evaluate_model.py:
    183-310): one whole-sequence LM forward per node, no cache."""
    tok = bundle.tokenizer
    special = set(tok.all_special_ids)
    img = np.asarray(img, np.float32).reshape(-1)
    img = img / np.linalg.norm(img)
    lm = bundle.model.lm
    base = torch.cat([prefix, lm.embed_tokens(torch.tensor([[tok.bos_token_id]]))], dim=1)
    committed, committed_emb = [], base
    while True:
        depth = max(min(look_ahead, max_decode_length - len(committed)), 1)
        frontier, candidates = [(list(committed), committed_emb)], []
        for d in range(depth):
            nxt = []
            for toks, emb in frontier:
                logits = lm(emb)[:, -1].float()
                if rep_penalty != 1.0 and toks:
                    logits = repetition_penalty(logits, torch.tensor([toks]), rep_penalty)
                for nt in np.argsort(-logits[0].numpy(), kind="stable")[:branching]:
                    nt = int(nt)
                    emb2 = torch.cat([emb, lm.embed_tokens(torch.tensor([[nt]]))], dim=1)
                    if nt in special or d == depth - 1:
                        candidates.append((toks + [nt], emb2, nt in special))
                    else:
                        nxt.append((toks + [nt], emb2))
            frontier = nxt
            if not frontier:
                break
        feats = np.asarray(scoring.embed_text(
            [tok.decode_tokens([t for t in c[0] if t not in special]) for c in candidates]))
        feats = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-9)
        best_tokens, best_emb, stopped = candidates[int(np.argmax(feats @ img))]
        if step_by_step:
            committed = best_tokens[: len(committed) + 1]
            committed_emb = best_emb[:, : committed_emb.shape[1] + 1]
            if len(committed) >= max_decode_length or committed[-1] in special:
                break
        else:
            committed, committed_emb = best_tokens, best_emb
            if stopped or len(committed) >= max_decode_length:
                break
    return tok.decode_tokens([t for t in committed if t not in special])


@pytest.mark.parametrize("step_by_step", [False, True])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_matches_naive_reference(bundles, scoring, step_by_step):
    port, _ = bundles
    imgs, prefix = _inputs(scoring, 1, 2)
    with torch.no_grad():
        want = naive_clip_guided(port, SCORINGS[scoring], imgs[0], torch.from_numpy(prefix),
                                 KW["max_decode_length"], KW["look_ahead"],
                                 KW["branching_factor"], KW["repetition_penalty_value"],
                                 step_by_step)
    got = CG.generate_clip_guided(port, SCORINGS[scoring], torch.from_numpy(imgs[0]),
                                  torch.from_numpy(prefix), step_by_step=step_by_step,
                                  device="cpu", **KW)
    assert got == want


def test_host_reads_twice_per_chunk(bundles, monkeypatch):
    """One copy of the tree's ids and one of the CLIP scores per chunk;
    nothing reads a device value inside the level loop."""
    port, _ = bundles
    imgs, prefix = _inputs("stub", 3, 5)
    reads = {"cpu": 0, "other": 0}
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        reads["cpu"] += 1
        return real_cpu(self, *a, **kw)

    def other(name):
        real = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            reads["other"] += 1
            return real(self, *a, **kw)
        return read

    chunks = {"n": 0}
    real_expand = CG._expand_tree

    def expand(*a, **kw):
        chunks["n"] += 1
        return real_expand(*a, **kw)

    monkeypatch.setattr(CG, "_expand_tree", expand)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    for name in ("item", "tolist", "__int__", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, other(name))
    CG.generate_clip_guided_batch(port, StubScoring(), torch.from_numpy(imgs),
                                  torch.from_numpy(prefix), device="cpu", **KW)
    monkeypatch.undo()
    assert chunks["n"] >= 2 and reads == {"cpu": 2 * chunks["n"], "other": 0}


def test_cross_attention_caches_are_refused(bundles):
    port, _ = bundles
    cache = port.lm.init_cache(1, 4)

    class CrossCache(type(cache)):
        cross_k = None

    with pytest.raises(NotImplementedError, match="cross-attention"):
        CG._replicate_rows(CrossCache(*cache), 2)
    with pytest.raises(ValueError, match="CLIP"):
        CG.generate_clip_guided_tokens(port, StubScoring(), torch.ones(1, 8),
                                       torch.zeros(1, 4, 32), max_decode_length=78,
                                       device="cpu")
