"""GPT-J's int8 decode module (models/gptj.GPTJInt8) against the JAX
package's gptj_int8 on the CPU.

- quantize_params: the port's quantization of a float GPT-J equals JAX's
  quantize_params leaf for leaf (q and s bit for bit) through the
  converter, in f32 and bf16 models; wte, the LayerNorms and the biases
  keep the float model's dtype, as JAX keeps those leaves;
- prefill (full logits, f32 attention on the call's own q/k/v) and decode
  steps against prefill_q8/decode_step_q8 within 4 bf16 steps of the
  logits' scale (tests/test_torch_gpt2_int8.py's rule); the ring step and
  scatter_refill against decode_step_ring_q8/scatter_refill_q8. Compiled
  JAX quantizes the MLP's int8 input from gelu_new's unrounded f32
  product (XLA moves the widening convert above it); the port does the
  same, and with it the golden's logits are JAX's to the bit on most steps;
- apply_q8, the W8A16 full forward, within 4 bf16 steps;
- the golden `gptj_greedy_int8` tokens (tests/fixtures/golden_tokens.json:
  JAX's init PRNGKey(3) of the fixture's config, the prefix PRNGKey(4))
  token for token, from JAX's int8 tree converted and from the port's own
  quantization of the converted float model.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import gptj as JG
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.models import gptj as TG

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_tokens.json").read_text())
BF16_STEP = 2.0 ** -8
STEPS = 4
LM = dict(vocab_size=104, n_positions=64, n_embd=64, n_layer=2, n_head=4, rotary_dim=8)
J_PREFILL = jax.jit(JG.prefill_q8, static_argnums=(1, 4))
J_STEP = jax.jit(JG.decode_step_q8, static_argnums=1)
J_RING = jax.jit(JG.decode_step_ring_q8, static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """A tiny GPT-J from JAX's init: the float params, JAX's int8 tree, and
    the port's int8 module loaded from that tree through the converter."""
    cfg = JC.GPTJConfig(**LM)
    params = JG.init(jax.random.PRNGKey(0), cfg)
    qparams = JG.quantize_params(params)
    model = convert.load(TG.GPTJInt8(TC.GPTJConfig(**LM), device="cpu", dtype=torch.float32),
                         convert.gptj_state_dict(_np(qparams)))
    return cfg, params, qparams, model


def _close_bf16(got, want, what: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = STEPS * BF16_STEP * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs err {err:.4g} > {STEPS} bf16 steps {tol:.4g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_matches_jax_through_the_converter(pair, dtype):
    cfg, params, _, _ = pair
    pj = jax.tree_util.tree_map(lambda a: a.astype(jnp.dtype(dtype)), params)
    flt = convert.load(TG.GPTJ(TC.GPTJConfig(**LM), device="cpu"),
                       convert.gptj_state_dict(_np(pj)))
    got = TG.quantize_params(flt)
    assert got.wte.dtype == getattr(torch, dtype) and got.blocks[0].w_in.bias.dtype == got.wte.dtype
    want = convert.gptj_state_dict(_np(JG.quantize_params(pj)))
    sd = {k: convert.to_numpy(v) for k, v in got.state_dict().items()}
    assert sorted(sd) == sorted(want)
    for k in sd:
        assert convert.to_torch(sd[k]).dtype == convert.to_torch(want[k]).dtype, k
        np.testing.assert_array_equal(sd[k].view(np.uint8), want[k].view(np.uint8), err_msg=k)
    assert got.lm_head.q.shape == (LM["vocab_size"], LM["n_embd"])  # no padded channels


def test_prefill_and_decode_steps_match_jax(pair):
    cfg, _, qparams, model = pair
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 11, LM["n_embd"])) * 0.5).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    jc = JG.init_cache_q8(cfg, 3, 12)
    want, jc = J_PREFILL(qparams, cfg, xj[:, :6], jc, True)
    cache = model.init_cache(3, 12)
    with torch.no_grad():
        got, cache = model.prefill(xb[:, :6], cache, full_logits=True)
        assert got.dtype == torch.float32
        _close_bf16(got, want, "int8 prefill")
        np.testing.assert_array_equal(cache.k[0, :, :, :6].numpy() != 0,
                                      np.asarray(jc.k)[0, :, :, :6] != 0)
        for t in range(6, 11):
            want, jc = J_STEP(qparams, cfg, xj[:, t:t + 1], jc)
            got, cache = model.decode_step(xb[:, t:t + 1], cache)
            _close_bf16(got, want, f"int8 decode step {t}")
    assert cache.index == int(jc.index)
    with pytest.raises(ValueError, match="one position"):
        model._forward_cached(xb[:, :2], cache._replace(index=6), fresh=False, full_logits=True)


def test_decode_step_ring_and_scatter_refill_match_jax(pair):
    cfg, _, qparams, model = pair
    rng = np.random.default_rng(2)
    b, p, t_ring, d = 3, 4, 8, LM["n_embd"]
    prefix = (rng.normal(size=(b, p, d)) * 0.5).astype(np.float32)
    jc = JG.init_cache_q8(cfg, b, t_ring)
    _, jc = J_PREFILL(qparams, cfg, jnp.asarray(prefix).astype(jnp.bfloat16), jc, False)
    cache = model.init_cache(b, t_ring)
    with torch.no_grad():
        _, cache = model.prefill(torch.from_numpy(prefix).bfloat16(), cache)
    pos, start = np.full(b, p, np.int64), np.zeros(b, np.int64)
    for step in range(14):
        if step == 5:
            new = (rng.normal(size=(2, p, d)) * 0.5).astype(np.float32)
            js = JG.init_cache_q8(cfg, 2, p)
            _, js = J_PREFILL(qparams, cfg, jnp.asarray(new).astype(jnp.bfloat16), js, False)
            jc = JG.scatter_refill_q8(jc, js, jnp.int32(1))
            small = model.init_cache(2, p)
            with torch.no_grad():
                _, small = model.prefill(torch.from_numpy(new).bfloat16(), small)
            cache = TG.GPTJInt8.scatter_refill(cache, small, 1)
            win = (cache.index - p + np.arange(p)) % t_ring
            assert torch.equal(cache.k[:, 1:3, :, win], small.k)
            start[1:], pos[1:] = cache.index - p, p
        tok = rng.integers(0, LM["vocab_size"], b)
        emb = np.array(JG.embed_tokens(qparams, jnp.asarray(tok)))[:, None]
        want, jc = J_RING(qparams, cfg, jnp.asarray(emb), jc, jnp.asarray(pos, jnp.int32),
                          jnp.asarray(start, jnp.int32))
        with torch.no_grad():
            got, cache = model.decode_step_ring(torch.from_numpy(emb), cache,
                                                torch.from_numpy(pos), torch.from_numpy(start))
        _close_bf16(got, want, f"int8 ring step {step}")
        pos += 1
    assert cache.index == int(jc.index) > t_ring


def test_apply_q8_matches_jax(pair):
    cfg, _, qparams, model = pair
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 7, LM["n_embd"])) * 0.5).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    want = JG.apply_q8(qparams, cfg, jnp.asarray(x), attention_mask=jnp.asarray(mask),
                       logits_slice=(1, 6))
    with torch.no_grad():
        got = model.apply_q8(torch.from_numpy(x), attention_mask=torch.from_numpy(mask),
                             logits_slice=(1, 6))
    assert got.dtype == torch.float32  # the f32 head bias promotes, as in JAX
    _close_bf16(got, want, "apply_q8")


def test_golden_gptj_greedy_int8():
    """The committed golden tokens of JAX's int8 GPT-J (vocabulary 50400),
    from JAX's int8 tree converted, and from the port's quantization of the
    converted float model."""
    cfg_j = JC.GPTJConfig(**GOLDEN["gptj_cfg"])
    jp = JG.init(jax.random.PRNGKey(3), cfg_j)
    prefix = jax.random.normal(jax.random.PRNGKey(4), (GOLDEN["batch"], 10, cfg_j.n_embd),
                               jnp.float32)
    prompt = torch.from_numpy(np.array(prefix.astype(jnp.float32))).bfloat16()
    settings = TE.GenerationSettings(max_new_tokens=GOLDEN["new_tokens"], greedy=True)
    cfg = TC.GPTJConfig(**GOLDEN["gptj_cfg"])
    from_jax = convert.load(TG.GPTJInt8(cfg, device="cpu", dtype=torch.float32),
                            convert.gptj_state_dict(_np(JG.quantize_params(jp))))
    flt = convert.load(TG.GPTJ(cfg, device="cpu"), convert.gptj_state_dict(_np(jp)))
    for lm in (from_jax, TG.quantize_params(flt)):
        out = TE.generate(lm, prompt, settings, device="cpu")
        assert out["tokens"].tolist() == GOLDEN["gptj_greedy_int8"]
