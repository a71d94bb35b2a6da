"""The port's tensor ops against the JAX package's, on the same numpy inputs.

Tolerances: f32 elementwise ops and norms at rtol 1e-5 / atol 1e-6 (same
formula, last-ulp differences of exp/tanh/erf); attention at atol 2e-5 /
rtol 1e-5 (the tolerance of tests/test_pallas_attention.py); the threshold
filters must keep identical sets, and kept values agree at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.ops import activations as JA
from clipcap_tpu.ops import attention as JATT
from clipcap_tpu.ops import layernorm as JL
from clipcap_tpu.ops import quant as JQ
from clipcap_tpu.ops import sampling as JS
from clipcap_tpu_torch.ops import activations as TA
from clipcap_tpu_torch.ops import attention as TATT
from clipcap_tpu_torch.ops import layernorm as TL
from clipcap_tpu_torch.ops import quant as TQ
from clipcap_tpu_torch.ops import sampling as TS


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
    return np.random.default_rng(3)


def test_layer_norm_and_rms_norm(rng):
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 2 + 1
    g = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), eps=1e-5)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), eps=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(g))
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["relu", "elu", "gelu", "selu", "geglu", "quick_gelu",
                                  "gelu_new"])
def test_activations(name, rng):
    x = rng.normal(size=(4, 16)).astype(np.float32) * 3
    want = JA.parse_act_fn(name)(jnp.asarray(x))
    got = TA.parse_act_fn(name)(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    assert TA.is_gated(name) == JA.is_gated(name)


def test_parse_act_fn_rejects_unknown():
    with pytest.raises(ValueError):
        TA.parse_act_fn("swish")


def test_dot_product_attention_with_biases(rng):
    q = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 3, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 3, 8)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, :3] = False
    jb = JATT.causal_bias(7, 9) + JATT.padding_bias(jnp.asarray(mask))
    tb = TATT.causal_bias(7, 9, device="cpu") + TATT.padding_bias(torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(tb), _np(jb))
    want = JATT.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jb)
    got = TATT.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), bias=tb)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("return_weights", [False, True])
def test_multi_head_attention(return_weights, rng):
    d, h = 16, 4
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    y = rng.normal(size=(2, 6, 12)).astype(np.float32)
    wq = rng.normal(size=(d, d)).astype(np.float32) * 0.3
    wkv = rng.normal(size=(12, 2 * d)).astype(np.float32) * 0.3
    wo = rng.normal(size=(d, d)).astype(np.float32) * 0.3
    bo = rng.normal(size=(d,)).astype(np.float32)
    want, wa = JATT.multi_head_attention(jnp.asarray(x), jnp.asarray(y), jnp.asarray(wq),
                                         jnp.asarray(wkv), jnp.asarray(wo), h,
                                         bo=jnp.asarray(bo), return_weights=return_weights)
    t = torch.from_numpy
    got, wb = TATT.multi_head_attention(t(x), t(y), t(wq.T.copy()), t(wkv.T.copy()),
                                        t(wo.T.copy()), h, bo=t(bo),
                                        return_weights=return_weights)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)
    if return_weights:
        np.testing.assert_allclose(_np(wb), _np(wa), atol=2e-6, rtol=1e-5)
    else:
        assert wa is None and wb is None


def test_linear_float_branch(rng):
    x = rng.normal(size=(3, 8)).astype(np.float32)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = JQ.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TQ.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # a quantized weight takes the int8 branch (compiled, as JAX's decode runs it)
    want = jax.jit(JQ.linear)(jnp.asarray(x), JQ.quantize_weight(jnp.asarray(w)))
    got = TQ.linear(torch.from_numpy(x), TQ.quantize_weight(torch.from_numpy(w.T.copy())))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)


def _assert_same_kept(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(np.where(np.isfinite(got), got, 0.0),
                               np.where(np.isfinite(want), want, 0.0), rtol=1e-6)


@pytest.mark.parametrize("neg_inf_col", [False, True])
def test_top_k_top_p_filter_threshold_kept_sets(neg_inf_col, rng):
    logits = rng.normal(size=(6, 512)).astype(np.float32) * 3
    if neg_inf_col:
        logits[:, 7] = -np.inf
    k = np.asarray([0.0, 5.0, 0.25, 0.0, 100.0, 3.0], np.float32)
    p = np.asarray([0.0, 0.1, 0.3, 0.5, 0.8, 0.95], np.float32)
    want = JS.top_k_top_p_filter_threshold(jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p))
    got = TS.top_k_top_p_filter_threshold(torch.from_numpy(logits), torch.from_numpy(k),
                                          torch.from_numpy(p))
    _assert_same_kept(got, want)
    # scalar settings and a disabled filter
    want = JS.top_k_top_p_filter_threshold(jnp.asarray(logits), 0, 0.6)
    got = TS.top_k_top_p_filter_threshold(torch.from_numpy(logits), 0, 0.6)
    _assert_same_kept(got, want)


def test_typical_filter_threshold_kept_sets(rng):
    logits = rng.normal(size=(4, 256)).astype(np.float32) * 2
    t = np.asarray([0.0, 0.2, 0.5, 0.9], np.float32)
    want = JS.typical_filter_threshold(jnp.asarray(logits), jnp.asarray(t))
    got = TS.typical_filter_threshold(torch.from_numpy(logits), torch.from_numpy(t))
    _assert_same_kept(got, want)


def test_token_occurrence_mask_and_repetition_penalty(rng):
    B, V, T = 4, 64, 9
    logits = rng.normal(size=(B, V)).astype(np.float32) * 2
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    valid = rng.random((B, T)) < 0.6
    want = JS.token_occurrence_mask(jnp.asarray(tokens), V, jnp.asarray(valid))
    got = TS.token_occurrence_mask(torch.from_numpy(tokens), V, torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(got), _np(want))
    for pen in (1.2, np.asarray([1.0, 1.3, 0.7, 2.0], np.float32)):
        want = JS.repetition_penalty(jnp.asarray(logits), jnp.asarray(tokens), pen,
                                     jnp.asarray(valid))
        got = TS.repetition_penalty(torch.from_numpy(logits), torch.from_numpy(tokens), pen,
                                    torch.from_numpy(valid))
        np.testing.assert_array_equal(_np(got), _np(want))


def test_sentence_length_penalty(rng):
    logits = rng.normal(size=(3, 32)).astype(np.float32)
    want = JS.sentence_length_penalty(jnp.asarray(logits), 5, 4, 10, 1.5)
    got = TS.sentence_length_penalty(torch.from_numpy(logits), 5, 4, 10, 1.5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


def test_sample_categorical_with_injected_gumbel(rng):
    """JAX's draws through the port's top-2 select JAX's tokens, including a
    row whose kept set is one token (the runner-up is the first other index)."""
    B, V = 5, 300
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3
    logits[4, :] = -np.inf
    logits[4, 0] = 1.0
    key = jax.random.PRNGKey(5)
    want = JS.sample_categorical(key, jnp.asarray(logits), num_samples=2)
    g = jax.random.gumbel(key, (B, V), dtype=jnp.float32)
    got = TS.sample_categorical(torch.from_numpy(logits), 2, gumbel=torch.from_numpy(np.array(g)))
    np.testing.assert_array_equal(_np(got), _np(want))
