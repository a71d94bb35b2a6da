"""The port's sort-based filters and filter_method="sort" against the JAX
package: top_k_top_p_filter (with and without the vocab prefilter and its
fall-back conditions) and typical_filter give JAX's kept sets and values
on seeded rows, with every top-p moved off the cumulative masses of its
row so that summation order cannot decide a cutoff; generate with
filter_method="sort" and JAX's Gumbel draws gives JAX's tokens. The
GenerationSettings and NoBeamCaptionSampler keywords are JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import engine as JE
from clipcap_tpu.eval.samplers import NoBeamCaptionSampler as JaxSampler
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu.ops import sampling as JS
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.ops import sampling as S

TIE_MARGIN = 1e-5  # top-p lies at least this far (relative) from every cumulative mass


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(b, v, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(b, v)) * scale).astype(np.float32)


def _mid_gap(x: np.ndarray, k, p) -> np.ndarray:
    """Each row's top-p moved to the middle of the gap between the two
    cumulative masses (f64) of its top-k-filtered row around it."""
    b, v = x.shape
    k = np.broadcast_to(np.asarray(k, np.float64), (b,))
    p = np.broadcast_to(np.asarray(p, np.float64), (b,)).copy()
    for r in range(b):
        if p[r] <= 0:
            continue
        vals = np.sort(x[r].astype(np.float64))[::-1]
        kr = k[r]
        kr = max(1.0, np.floor(kr * v)) if 0 < kr < 1 else np.floor(kr)
        if kr > 0:
            vals = vals[vals >= vals[int(min(kr, v)) - 1]]
        e = np.exp(vals - vals[0])
        cum = np.cumsum(e) / e.sum()
        lo = cum[cum <= p[r]].max(initial=0.0)
        hi = cum[cum > p[r]].min(initial=np.inf)
        if np.isfinite(hi):
            p[r] = (lo + hi) / 2
            assert (hi - lo) / 2 > TIE_MARGIN * p[r]
    return p.astype(np.float32)


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    np.testing.assert_array_equal(got.numpy(), want)


CASES = {
    "top_p": (0, 0.9),
    "top_k": (20, 0.0),
    "fractional_top_k_and_top_p": (0.05, 0.7),
    "per_row": ([0.0, 5.0, 40.0, 0.0, 1.0, 300.0], [0.3, 0.5, 0.0, 0.95, 0.8, 0.999]),
    "top_k_ties": (7, 0.6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_top_k_top_p_filter_matches_jax(case):
    k, p = CASES[case]
    x = _rows(6, 300, 1)
    if case == "top_k_ties":
        x = np.round(x * 2) / 2  # many ties, at the k-th value too
    p = _mid_gap(x, k, p)
    want = JS.top_k_top_p_filter(jnp.asarray(x), jnp.asarray(k, jnp.float32), jnp.asarray(p))
    got = S.top_k_top_p_filter(torch.from_numpy(x), torch.tensor(k, dtype=torch.float32),
                               torch.from_numpy(p))
    _same(got, want)


@pytest.mark.parametrize("k,p,engaged", [
    (0, 0.3, True),      # the nucleus fits the candidates
    (40, 0.5, True),     # an active top-k within the candidates
    (100, 0.5, False),   # top-k above prefilter_k: the full sort
    (0.05, 0.5, False),  # fractional top-k resolves to 100 > prefilter_k
    (0, 0.996, False),   # top-p near 1: the nucleus may leave the candidates
])
def test_prefilter_matches_jax_and_its_fall_backs(k, p, engaged):
    x = _rows(4, 2000, 2, scale=4.0)
    p = _mid_gap(x, k, p)
    kk = torch.tensor(k, dtype=torch.float32)
    want = JS.top_k_top_p_filter(jnp.asarray(x), jnp.asarray(k, jnp.float32), jnp.asarray(p),
                                 prefilter_k=64)
    got = S.top_k_top_p_filter(torch.from_numpy(x), kk, torch.from_numpy(p), prefilter_k=64)
    # values outside the candidate set are rebuilt as -inf, kept ones copied
    _same(got, want)
    full = S.top_k_top_p_filter(torch.from_numpy(x), kk, torch.from_numpy(p))
    if engaged:
        assert int(torch.isfinite(got).sum(-1).max()) <= 64
    else:
        assert torch.equal(got, full)


def test_typical_filter_matches_jax():
    x = _rows(5, 300, 3, scale=2.0)
    tp = np.array([0.2, 0.5, 0.9, 0.0, 0.95], np.float32)
    want = JS.typical_filter(jnp.asarray(x), jnp.asarray(tp))
    got = S.typical_filter(torch.from_numpy(x), torch.from_numpy(tp))
    _same(got, want)
    # min_tokens_to_keep
    want = JS.typical_filter(jnp.asarray(x), jnp.asarray(tp), min_tokens_to_keep=30)
    got = S.typical_filter(torch.from_numpy(x), torch.from_numpy(tp), min_tokens_to_keep=30)
    _same(got, want)


def _jax_step_gumbel(seed, n, shape):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(key, shape, dtype=jnp.float32)))
    return np.stack(out)


LM = dict(vocab_size=97, n_positions=64, n_embd=64, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def lm_world():
    """A tiny GPT-2 seeded in the port and handed to JAX in its layout, and
    a seeded prefix."""
    model = GPT2(TC.GPT2Config(**LM), device="cpu", seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, convert.gpt2_params(sd, LM["n_layer"]))
    prefix = np.random.default_rng(1).normal(size=(3, 5, 64)).astype(np.float32)
    return params, model, prefix


@pytest.mark.parametrize("kw", [
    dict(top_p=0.8, repetition_penalty=1.2, vocab_prefilter=32),
    dict(top_k=10.0, top_p=0.9, temperature=0.7, vocab_prefilter=16),
    dict(top_p=0.6, typ_p=0.8, vocab_prefilter=0),
])
def test_generate_sort_matches_jax_with_jax_draws(lm_world, kw):
    params, model, prefix = lm_world
    n = 8
    want = JE.generate(JG, params, JC.GPT2Config(**LM), jnp.asarray(prefix),
                       JE.GenerationSettings(max_new_tokens=n, filter_method="sort", **kw),
                       rng=jax.random.PRNGKey(2))
    noise = torch.from_numpy(_jax_step_gumbel(2, n, (3, LM["vocab_size"])))
    got = TE.generate(model, torch.from_numpy(prefix),
                      TE.GenerationSettings(max_new_tokens=n, filter_method="sort", **kw),
                      gumbel_noise=noise, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_fault_vocab_prefilter_keywords_are_jax_ones():
    """GenerationSettings and NoBeamCaptionSampler take the JAX keywords,
    vocab_prefilter included, with the same defaults."""
    a, b = JE.GenerationSettings, TE.GenerationSettings
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    defaults = {f.name: f.default for f in dataclasses.fields(a)}
    assert defaults == {f.name: f.default for f in dataclasses.fields(b)}
    assert b(vocab_prefilter=512, filter_method="sort").vocab_prefilter == 512
    kw = dict(top_p_values=(0.1, 0.5), temperature=0.9, repetition_penalty=1.1,
              max_decode_length=20, max_stops=2, stop_token=".", seed=3, vocab_prefilter=4096)
    want, got = JaxSampler(**kw), NoBeamCaptionSampler(**kw, device="cpu")
    for name in kw:
        assert getattr(got, name) == getattr(want, name), name
    assert NoBeamCaptionSampler(device="cpu").vocab_prefilter == JaxSampler().vocab_prefilter
