"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

K1 (fused attention) at the f32 tolerance of tests/test_pallas_attention.py
(atol 2e-5, rtol 1e-5). K2/K3 (fused filter + sampler) with injected Gumbel
noise: next and alt exact, alt_prob and eos_lp at rtol 1e-5. On CPU tensors
the wrappers take the plain version and launch nothing, so their launch
counters stay 0. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from clipcap_tpu.ops import sampling as JS
from clipcap_tpu.ops.pallas.fused_attention import fused_attention as jax_fused_attention
from clipcap_tpu.ops.pallas import fused_sampler as JF
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and torch's default pool (one thread per core) in each
    would oversubscribe the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("shape", [(2, 50, 4, 64), (1, 70, 2, 128)])
def test_fused_attention_plain_matches_pallas(shape, rng):
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    before = dict(FA.LAUNCHES)
    t = torch.from_numpy
    plain = FA.fused_attention_plain(t(q), t(k), t(v))
    got = FA.fused_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(_np(plain), _np(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(got), _np(plain))
    assert FA.LAUNCHES == before == {"fused_attention": 0}


def test_fused_attention_plain_bf16_rounds_probs_like_pallas(rng):
    """bf16: probabilities are cast to v's dtype before the product, as in the
    TPU kernel; output in bf16 (one bf16 ulp of slack, atol/rtol 1e-2)."""
    shape = (1, 50, 2, 64)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = jax_fused_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                               interpret=True)
    got = FA.fused_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("top_k,want", [
    (0, [0.0] * 3),
    (0.25, [128.0] * 3),
    (0.0001, [1.0] * 3),
    (7.9, [7.0] * 3),
    (1e9, [512.0] * 3),
    ([0.0, 5.0, 0.5], [0.0, 5.0, 256.0]),
])
def test_resolve_top_k(top_k, want):
    got = FS.resolve_top_k(top_k, 3, 512, "cpu")
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(_np(got), _np(JF.resolve_top_k(jnp.asarray(top_k), 3, 512)))


def _case(rng, B=6, V=512):
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3
    logits[2, 7] = -np.inf  # a pre-suppressed column flows through both bisections
    p = np.asarray([0.0, 0.1, 0.3, 0.5, 0.8, 0.95], np.float32)
    k = np.asarray([0.0, 5.0, 0.25, 0.0, 100.0, 3.0], np.float32)
    g = rng.gumbel(size=(B, V)).astype(np.float32)
    return logits, k, p, g


@pytest.mark.parametrize("gates", [(True, True), (True, False), (False, True)])
def test_fused_filter_sample_plain_matches_pallas(gates, rng):
    do_topk, do_topp = gates
    logits, k, p, g = _case(rng)
    want = JF.fused_filter_sample(jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p),
                                  seed=jnp.int32(7), gumbel_noise=jnp.asarray(g),
                                  do_topk=do_topk, do_topp=do_topp,
                                  interpret=pltpu.InterpretParams(), block_rows=2)
    t = torch.from_numpy
    got = FS.fused_filter_sample(t(logits), t(k), t(p), 7, gumbel_noise=t(g),
                                 do_topk=do_topk, do_topp=do_topp)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5, atol=1e-7)
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


@pytest.mark.parametrize("gates", [(True, True), (True, False), (False, True)],
                         ids=["topk_topp", "topk", "topp"])
def test_fused_filter_plain_matches_pallas(gates, rng):
    """K4: the filtered logits equal the Pallas `fused_filter`'s exactly
    (the same -inf pattern, kept values the input's bit for bit), with a
    top-p <= 0 row, fractional and disabled top-k rows, a -inf column and
    B=6 not a multiple of the 4 block rows; the kept set is that of
    S.top_k_top_p_filter_threshold."""
    from clipcap_tpu_torch.ops import sampling as TS

    do_topk, do_topp = gates
    logits, k, p, _ = _case(rng)
    want = JF.fused_filter(jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p), do_topk=do_topk,
                           do_topp=do_topp, interpret=True, block_rows=4)
    t = torch.from_numpy
    got = FS.fused_filter(t(logits), t(k), t(p), do_topk=do_topk, do_topp=do_topp)
    np.testing.assert_array_equal(_np(got), _np(want))
    kept = np.isfinite(_np(got))
    assert (np.where(kept, _np(got), 0) == np.where(kept, logits, 0)).all()
    assert not kept[2, 7]
    want_kept = np.isfinite(_np(TS.top_k_top_p_filter_threshold(
        t(logits), t(k) if do_topk else 0, t(p) if do_topp else 0.0)))
    np.testing.assert_array_equal(kept, want_kept)
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def test_fused_filter_sample_singleton_kept_set_alt_prob_zero():
    logits = torch.tensor([[10.0, 1.0, 0.5, -1.0]])
    nxt, alt, ap = FS.fused_filter_sample(logits, 1.0, 0.0, 0, gumbel_noise=torch.zeros(1, 4),
                                          do_topp=False)
    assert int(nxt[0]) == 0 and float(ap[0]) == 0.0


def test_fused_step_sample_plain_matches_pallas(rng):
    B, V, EOS, PEN, TEMP = 6, 512, 9, 1.2, 0.9
    logits, k, p, g = _case(rng, B, V)
    hist = rng.integers(0, V, (B, 7)).astype(np.int32)
    hist_valid = rng.random((B, 7)) < 0.7
    suppress = np.asarray([True, False, True, False, False, True])
    appears = JS.token_occurrence_mask(jnp.asarray(hist), V, tokens_valid=jnp.asarray(hist_valid))
    want = JF.fused_step_sample(
        jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p), seed=jnp.int32(3),
        appears=appears, penalty=PEN, temperature=TEMP, eos_token_id=EOS,
        suppress_eos=jnp.asarray(suppress), want_eos_lp=True, gumbel_noise=jnp.asarray(g),
        interpret=pltpu.InterpretParams(), block_rows=2)
    t = torch.from_numpy
    got = FS.fused_step_sample(
        t(logits), t(k), t(p), 3, appears=torch.from_numpy(np.array(appears)), penalty=PEN,
        temperature=TEMP, eos_token_id=EOS, suppress_eos=t(suppress), want_eos_lp=True,
        gumbel_noise=t(g))
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=1e-5)
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def test_fused_step_sample_argument_checks():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        FS.fused_step_sample(x, 0, 0.5, 0, penalty=1.2)
    with pytest.raises(ValueError):
        FS.fused_step_sample(x, 0, 0.5, 0, want_eos_lp=True)


def test_plain_sampler_seeded_noise_is_reproducible(rng):
    """Without injected noise the plain version draws from a generator
    seeded with `seed`: equal seeds give equal draws, and every token lies
    in the filter's kept set."""
    logits, k, p, _ = _case(rng)
    t = torch.from_numpy
    a = FS.fused_filter_sample(t(logits), t(k), t(p), 123)
    b = FS.fused_filter_sample(t(logits), t(k), t(p), 123)
    np.testing.assert_array_equal(_np(a[0]), _np(b[0]))
    kept = np.isfinite(np.asarray(JS.top_k_top_p_filter_threshold(
        jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p))))
    assert kept[np.arange(len(logits)), _np(a[0])].all()
