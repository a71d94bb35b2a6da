"""The port's BLIP text model (models/blip_text) against the JAX package's.

- `BlipText.forward` against `apply`, causal and bidirectional, with and
  without encoder states and a padding mask (f32, rtol 1e-5);
- `decoder_lm`'s prefill (every position) and decode steps against JAX's
  (f32, rtol 1e-5), and with repeat=3 the grouped cross-attention against
  JAX's grouped path and against the port's own repeated-rows path;
- the int8 decoder: q and s equal to JAX's `quantize_params`, the logits
  within 4 bf16 steps of their scale of JAX's int8 logits (the bound
  tests/test_torch_gpt2_int8.py sets for GPT-2);
- the golden `blip_grouped_sampled`/`blip_grouped_lengths`
  (tests/fixtures/golden_tokens.json) token for token, on JAX's init
  converted to the port and fed JAX's per-step Gumbel draws.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import blip_text as JB
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.models import blip_text as TB
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_tokens.json").read_text())
CFG = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
           max_position_embeddings=32, encoder_width=24, embed_dim=16)
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


def port_text(params, cfg=CFG, lm_head=True) -> TB.BlipText:
    return convert.load(TB.BlipText(TC.BlipTextConfig(**cfg), lm_head=lm_head, device="cpu"),
                        convert.blip_text_state_dict(_np(params)))


@pytest.fixture(scope="module")
def world():
    params = JB.init(jax.random.PRNGKey(0), JC.BlipTextConfig(**CFG))
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 5, CFG["encoder_width"])).astype(np.float32)
    tokens = rng.integers(0, CFG["vocab_size"], (2, 7))
    return params, port_text(params), img, tokens


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_image", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_apply_matches_jax(world, causal, with_image, masked):
    params, text, img, tokens = world
    mask = np.array([[1] * 7, [1] * 4 + [0] * 3]) if masked else None
    enc_mask = np.array([[1] * 5, [1] * 3 + [0] * 2]) if with_image and masked else None
    kw = dict(causal=causal, with_lm_head=True)
    want = JB.apply(params, JC.BlipTextConfig(**CFG), jnp.asarray(tokens),
                    attention_mask=None if mask is None else jnp.asarray(mask),
                    encoder_hidden_states=jnp.asarray(img) if with_image else None,
                    encoder_attention_mask=None if enc_mask is None else jnp.asarray(enc_mask),
                    **kw)
    with torch.no_grad():
        got = text(torch.from_numpy(tokens),
                   attention_mask=None if mask is None else torch.from_numpy(mask),
                   encoder_hidden_states=torch.from_numpy(img) if with_image else None,
                   encoder_attention_mask=None if enc_mask is None else torch.from_numpy(enc_mask),
                   **kw)
    _close(got, want, "logits")


def _jax_steps(lm, params, cfg, prompt, steps):
    """JAX decoder_lm: full prefill logits, then the last logits of each step."""
    cache = lm.init_cache(cfg, batch=prompt.shape[0], max_len=prompt.shape[1] + len(steps) + 1)
    logits, cache = lm.prefill(params, cfg, jnp.asarray(prompt), cache)
    out = [np.asarray(logits)]
    for ids in steps:
        step, cache = lm.decode_step(params, cfg, jnp.asarray(ids)[:, None], cache)
        out.append(np.asarray(step))
    return out


def _port_steps(lm, prompt, steps):
    cache = lm.init_cache(prompt.shape[0], prompt.shape[1] + len(steps) + 1)
    logits, cache = lm.prefill(torch.from_numpy(prompt), cache, full_logits=True)
    out = [logits]
    for ids in steps:
        step, cache = lm.decode_step(torch.from_numpy(ids)[:, None], cache)
        out.append(step)
    return out


@pytest.mark.parametrize("repeat", [1, 3])
def test_cached_decode_matches_jax(world, repeat):
    params, text, img, _ = world
    rng = np.random.default_rng(repeat)
    rows = 2 * repeat
    prompt = rng.integers(0, CFG["vocab_size"], (rows, 4))
    steps = [rng.integers(0, CFG["vocab_size"], rows) for _ in range(3)]
    jcfg = JC.BlipTextConfig(**CFG)
    want = _jax_steps(JB.decoder_lm(params, jcfg, jnp.asarray(img), repeat=repeat), params,
                      jcfg, prompt, steps)
    got = _port_steps(TB.decoder_lm(text, torch.from_numpy(img), repeat=repeat), prompt, steps)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"step {i}")
    if repeat > 1:  # the grouped path against the port's own repeated image rows
        rows_lm = TB.decoder_lm(text, torch.from_numpy(img).repeat_interleave(repeat, 0))
        for i, (g, w) in enumerate(zip(got, _port_steps(rows_lm, prompt, steps))):
            _close(g, w.numpy(), f"grouped against repeated rows, step {i}")


def test_decoder_lm_checks_the_batch(world):
    _, text, img, _ = world
    lm = TB.decoder_lm(text, torch.from_numpy(img), repeat=3)
    assert lm.takes_token_ids and lm.init_cache(6, 8).cross_k.shape[1] == 2
    with pytest.raises(ValueError, match="decode batch 4 != images 2 x repeat 3"):
        lm.init_cache(4, 8)


def test_int8_decoder_matches_jax(world):
    params, text, img, _ = world
    jcfg = JC.BlipTextConfig(**CFG)
    jq = JB.quantize_params(params)
    q8 = TB.quantize_params(text)
    want_sd = convert.blip_text_state_dict(_np(jq))
    got_sd = q8.state_dict()
    assert sorted(want_sd) == sorted(got_sd)
    for name, value in want_sd.items():  # q, s (and the padded head) bit for bit
        np.testing.assert_array_equal(got_sd[name].numpy(), value, err_msg=name)
    assert got_sd["cls_decoder.q"].shape[0] % 8 == 0
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG["vocab_size"], (4, 3))
    steps = [rng.integers(0, CFG["vocab_size"], 4) for _ in range(3)]
    want = _jax_steps(JB.decoder_lm(jq, jcfg, jnp.asarray(img), repeat=2), jq, jcfg, prompt,
                      steps)
    got = _port_steps(TB.decoder_lm(q8, torch.from_numpy(img), repeat=2), prompt, steps)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = INT8_STEPS * BF16_STEP * float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert g.shape[-1] == CFG["vocab_size"] and err <= tol, (i, err, tol)


def _jax_step_gumbel(seed: int, n: int, shape) -> np.ndarray:
    """The per-step draws of JAX generate: rng, key = split(rng); gumbel(key)."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(key, shape, dtype=jnp.float32)))
    return np.stack(out)


def test_golden_blip_grouped_with_jax_draws():
    """tests/test_golden_fixtures.py::test_blip_grouped_tokens_frozen in
    the port: JAX's init converted, repeat=2, top-p 0.8, penalty 1.3."""
    jcfg = JC.BlipTextConfig(**GOLDEN["blip_cfg"])
    params = JB.init(jax.random.PRNGKey(5), jcfg)
    img = np.array(jax.random.normal(jax.random.PRNGKey(6), (2, 8, jcfg.encoder_width),
                                       jnp.float32))
    text = port_text(params, GOLDEN["blip_cfg"])
    lm = TB.decoder_lm(text, torch.from_numpy(img), repeat=2)
    prompt = torch.tensor(np.tile(np.asarray([[101, 1037, 3861, 1997]]), (4, 1)))
    noise = torch.from_numpy(_jax_step_gumbel(9, 16, (4, jcfg.vocab_size)))
    before = dict(FS.LAUNCHES)
    out = TE.generate(lm, prompt, TE.GenerationSettings(
        max_new_tokens=16, top_p=0.8, repetition_penalty=1.3, eos_token_id=102, min_length=4,
        vocab_prefilter=512), gumbel_noise=noise, prompt_tokens=prompt, device="cpu")
    assert out["tokens"].tolist() == GOLDEN["blip_grouped_sampled"]
    assert out["lengths"].tolist() == GOLDEN["blip_grouped_lengths"]
    assert FS.LAUNCHES == before  # the CPU takes the plain threshold path
