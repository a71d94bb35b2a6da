"""GPT-2 in both dtypes, on the CPU: in f32 the port matches HF's
GPT2LMHeadModel (eager attention, built from a config, weights through the
port's HF converter) at atol 1e-5, as tests/test_gpt2_parity.py holds the
JAX package; in bf16 it matches the JAX package's apply (with a padding
mask), prefill, decode_step and decode_step_ring on the same bf16 weights.

The bf16 tolerance: bf16 keeps 8 significant bits, a relative step of
2^-8. Both packages round each matmul, bias add and activation to bf16
and keep attention scores, softmax and LayerNorm statistics in f32, but
not at the same points (torch's addmm rounds once where JAX's dot-then-add
rounds twice; torch rounds gelu_new op by op where XLA may fuse it). So an
activation may differ by about a step of its own scale, and a logit by a
few steps of the logits' scale: the tests allow 4 steps, 4 * 2^-8 *
max|logit| (the measured worst is under one step). Greedy tokens must be
equal wherever JAX's top-2 logit gap exceeds that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.tools import import_weights as TW

BF16_STEP = 2.0 ** -8
STEPS = 4
LM = dict(vocab_size=257, n_positions=64, n_embd=64, n_layer=3, n_head=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_tensorflow(monkeypatch):
    """transformers would import TensorFlow, where installed, for nothing here."""
    monkeypatch.setenv("USE_TF", "0")


# --- f32 against HF eager ---------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_pair():
    from transformers import GPT2Config as HFConfig
    from transformers import GPT2LMHeadModel

    cfg = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=3, n_head=4)
    torch.manual_seed(0)
    hf = GPT2LMHeadModel(HFConfig(**cfg, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
                                  attn_implementation="eager")).eval()
    model = convert.load(GPT2(TC.GPT2Config(**cfg), device="cpu"),
                         TW.gpt2_from_state_dict(hf.state_dict(), TC.GPT2Config(**cfg)))
    return hf, model


@pytest.mark.parametrize("masked", [False, True])
def test_f32_forward_matches_hf_eager(hf_pair, masked):
    hf, model = hf_pair
    torch.manual_seed(1)
    x = torch.randn(2, 10, 64)
    mask = torch.ones(2, 10, dtype=torch.long)
    if masked:
        mask[0, 6:] = 0  # right padding, as the captioner's -1-padded tokens
    with torch.no_grad():
        want = hf(inputs_embeds=x, attention_mask=mask).logits.numpy()
        got = model(x, attention_mask=mask).numpy()
    # padded queries attend nothing real: compare the valid rows
    rows = [(0, slice(0, 6 if masked else 10)), (1, slice(None))]
    for b, sl in rows:
        np.testing.assert_allclose(got[b, sl], want[b, sl], atol=1e-5, rtol=1e-5)


def test_f32_kv_decode_matches_hf_full_forward(hf_pair):
    hf, model = hf_pair
    torch.manual_seed(2)
    x = torch.randn(2, 12, 64)
    with torch.no_grad():
        want = hf(inputs_embeds=x).logits.numpy()
        logits, cache = model.prefill(x[:, :8], model.init_cache(2, 16), full_logits=True)
        np.testing.assert_allclose(logits.numpy(), want[:, :8], atol=1e-5, rtol=1e-5)
        for t in range(8, 12):
            step, cache = model.decode_step(x[:, t:t + 1], cache)
            np.testing.assert_allclose(step.numpy(), want[:, t], atol=1e-5, rtol=1e-5)
    assert cache.index == 12


# --- bf16 against JAX -------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_pair():
    """A GPT-2 seeded in the port (wte scaled up for peaked logits), cast
    to bf16 in both packages from the same f32 values."""
    model = GPT2(TC.GPT2Config(**LM), device="cpu", seed=3)
    with torch.no_grad():
        model.wte.mul_(20.0)
    f32 = convert.gpt2_params({k: v.numpy() for k, v in model.state_dict().items()},
                              LM["n_layer"])
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), f32)
    model = model.to(torch.bfloat16)
    # both round to nearest even: the same bits
    np.testing.assert_array_equal(convert.to_numpy(model.wte).view(np.int16),
                                  np.asarray(params["wte"]).view(np.int16))
    return params, model


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _close_bf16(got, want, what: str) -> float:
    got, want = _f32(got), _f32(want)
    tol = STEPS * BF16_STEP * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs err {err:.4g} > {tol:.4g}"
    return tol


def test_bf16_apply_with_mask_and_slice_matches_jax(bf16_pair):
    params, model = bf16_pair
    cfg_j = JC.GPT2Config(**LM)
    x = np.random.default_rng(0).normal(size=(2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    for kw in (dict(), dict(attention_mask=mask), dict(logits_slice=(3, 8))):
        jkw = {k: (jnp.asarray(v) if k == "attention_mask" else v) for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if k == "attention_mask" else v) for k, v in kw.items()}
        want = JG.apply(params, cfg_j, jnp.asarray(x, jnp.bfloat16), **jkw)
        with torch.no_grad():
            got = model(torch.from_numpy(x).to(torch.bfloat16), **tkw)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        _close_bf16(got, want, f"apply {sorted(kw)}")


def test_bf16_prefill_decode_and_greedy_tokens_match_jax(bf16_pair):
    """prefill, then greedy decode_step on each package's own tokens: the
    logits agree within the tolerance at every step, and the tokens are
    equal until a step where JAX's top-2 gap is below it."""
    params, model = bf16_pair
    cfg_j = JC.GPT2Config(**LM)
    prompt = np.random.default_rng(1).normal(size=(3, 6, 64)).astype(np.float32)
    jl, jc = JG.prefill(params, cfg_j, jnp.asarray(prompt, jnp.bfloat16),
                        JG.init_cache(cfg_j, 3, 20, jnp.bfloat16))
    with torch.no_grad():
        tl, tc = model.prefill(torch.from_numpy(prompt).to(torch.bfloat16),
                               model.init_cache(3, 20))
    assert tc.k.dtype == torch.bfloat16 and tl.dtype == torch.bfloat16
    tol = _close_bf16(tl, jl, "prefill")
    assert jc.k.dtype == jnp.bfloat16
    jl, tl = jl[:, -1], tl[:, -1]
    jstep = jax.jit(lambda e, c: JG.decode_step(params, cfg_j, e, c))
    same = np.ones(3, bool)
    for step in range(12):
        jf, tf = _f32(jl), _f32(tl)
        top2 = np.sort(jf, axis=-1)[:, -2:]
        jt, tt = jf.argmax(-1), tf.argmax(-1)
        flip = same & (jt != tt)
        assert not (flip & (top2[:, 1] - top2[:, 0] > tol)).any(), f"token flip at step {step}"
        same &= ~flip
        # both continue on JAX's tokens, so the caches stay comparable
        jl, jc = jstep(JG.embed_tokens(params, jnp.asarray(jt))[:, None], jc)
        with torch.no_grad():
            tl, tc = model.decode_step(model.embed_tokens(torch.from_numpy(jt))[:, None], tc)
        _close_bf16(tl, jl, f"decode_step {step}")
    assert tc.index == int(jc.index) == 18


def test_bf16_decode_step_ring_matches_jax(bf16_pair):
    params, model = bf16_pair
    cfg_j = JC.GPT2Config(**LM)
    rng = np.random.default_rng(2)
    b, p, ring = 3, 5, 9
    prefix = rng.normal(size=(b, p, 64)).astype(np.float32)
    _, jc = JG.prefill(params, cfg_j, jnp.asarray(prefix, jnp.bfloat16),
                       JG.init_cache(cfg_j, b, ring, jnp.bfloat16))
    with torch.no_grad():
        _, tc = model.prefill(torch.from_numpy(prefix).to(torch.bfloat16),
                              model.init_cache(b, ring))
    pos, start = np.full(b, p, np.int64), np.zeros(b, np.int64)
    start[2] = 2  # a row whose window starts later
    jstep = jax.jit(lambda e, c, q, s: JG.decode_step_ring(params, cfg_j, e, c, q, s))
    for step in range(8):  # past the ring's first wrap
        tok = rng.integers(0, LM["vocab_size"], b)
        jl, jc = jstep(JG.embed_tokens(params, jnp.asarray(tok))[:, None], jc,
                       jnp.asarray(pos, jnp.int32), jnp.asarray(start, jnp.int32))
        with torch.no_grad():
            tl, tc = model.decode_step_ring(model.embed_tokens(torch.from_numpy(tok))[:, None],
                                            tc, torch.from_numpy(pos), torch.from_numpy(start))
        _close_bf16(tl, jl, f"decode_step_ring {step}")
        pos += 1
    assert tc.index == int(jc.index)
