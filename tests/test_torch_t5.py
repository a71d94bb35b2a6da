"""The port's T5/T0 (models/t5.py) against the JAX package's, on tiny
configs on the CPU, with JAX's parameters carried across through
convert.t5_state_dict.

Tolerances:
- relative position buckets: bit-equal over distances -300..300;
- f32 logits (full forward, prefill, cached and ring steps): atol 1e-5,
  rtol 1e-5 (two BLAS libraries sum in different orders; measured ~5e-6);
- bf16 logits: within BF16_STEPS bf16 steps (2^-8) of the logits' largest
  magnitude. Compiled XLA keeps a bf16 residual that feeds a norm, and a
  gated MLP's chain, in f32 where eager torch rounds, so the two drift a
  few steps apart (measured 5 of them);
- int8: q equal to JAX's and the scales equal to eager JAX's bit for bit;
  against JAX's jitted quantization (what enable_int8_decode runs) s
  within an f32 ulp; the int8 greedy tokens of a peaked T5 (its
  embeddings and prompts x 50) equal to jitted JAX's;
- HF import: the port's t5_from_state_dict equal to JAX's, and its logits
  within 3e-5 / 1e-4 of HF's (tests/test_t5_parity.py's tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import engine as JE
from clipcap_tpu.models import t5 as JT
from clipcap_tpu.tools import import_weights as JIW
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.models import t5 as TT
from clipcap_tpu_torch.tools import import_weights as TIW

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_STEPS = 16
RELU = dict(vocab_size=97, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_decoder_layers=2,
            num_heads=4, relative_attention_num_buckets=8, relative_attention_max_distance=32)
GATED = dict(RELU, d_model=64, d_kv=16, d_ff=128, feed_forward_proj="gated-gelu",
             tie_word_embeddings=False, relative_attention_num_buckets=32,
             relative_attention_max_distance=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and torch's default pool (one thread per core) in each
    would oversubscribe the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(kw: dict, dtype=jnp.float32, seed: int = 0, peaked: bool = False):
    """(JAX params, JAX config, the port's T5 on the same weights). A peaked
    T5's embedding table is scaled x 50, so a token's embedding dominates
    the decoder's residual stream and the greedy choices are not near
    ties."""
    jc, tc = JC.T5Config(**kw), TC.T5Config(**kw)
    params = JT.init(jax.random.PRNGKey(seed), jc)
    if peaked:
        params["shared"] = params["shared"] * 50.0
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    model = convert.load(TT.T5(tc, device="cpu"),
                         convert.t5_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return params, jc, model.requires_grad_(False)


@pytest.fixture(scope="module")
def relu_pair():
    return _pair(RELU)


@pytest.fixture(scope="module")
def gated_pair():
    return _pair(GATED)


def _embeds(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 32), (32, 20)])
def test_relative_position_buckets_bit_equal(bidirectional, buckets, max_distance):
    rel = np.arange(-300, 301)
    want = np.asarray(JT._relative_position_bucket(jnp.asarray(rel, jnp.int32), bidirectional,
                                                   buckets, max_distance))
    got = TT.relative_position_bucket(torch.from_numpy(rel), bidirectional, buckets,
                                      max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("which", ["relu_tied", "gated_untied"])
def test_forward_matches_jax(which, masked, relu_pair, gated_pair):
    params, jc, model = relu_pair if which == "relu_tied" else gated_pair
    x = _embeds((2, 7, jc.d_model), 1)
    mask = np.ones((2, 7), bool)
    mask[1, 4:] = False
    m = mask if masked else None
    want = JT.apply(params, jc, jnp.asarray(x), None if m is None else jnp.asarray(m))
    got = model(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # logits_slice and decoder_inputs_embeds, as the loss and the cached path use them
    dec = _embeds((2, 9, jc.d_model), 2)
    want = JT.apply(params, jc, jnp.asarray(x), decoder_inputs_embeds=jnp.asarray(dec),
                    logits_slice=(2, 8))
    got = model(torch.from_numpy(x), decoder_inputs_embeds=torch.from_numpy(dec),
                logits_slice=(2, 8))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("which", ["relu_tied", "gated_untied"])
def test_prefill_and_cached_decode_match_full_forward_and_jax(which, relu_pair, gated_pair):
    """tests/test_t5_parity.py::test_cached_decode_matches_full's contract,
    and every step against JAX's prefill and decode_step."""
    params, jc, model = relu_pair if which == "relu_tied" else gated_pair
    emb = _embeds((2, 11, jc.d_model), 3)
    full = model(torch.from_numpy(emb[:, :6]), decoder_inputs_embeds=torch.from_numpy(emb))
    cache = model.init_cache(2, 16)
    assert cache.enc_hidden.shape == (2, 1, jc.d_model) and cache.enc_bias is None
    logits, cache = model.prefill(torch.from_numpy(emb[:, :6]), cache, full_logits=True)
    assert cache.enc_hidden.shape == (2, 6, jc.d_model) and cache.index == 6
    np.testing.assert_allclose(_np(logits), _np(full[:, :6]), atol=1e-4, rtol=1e-4)
    jcache = JT.init_cache(jc, 2, 16)
    jlogits, jcache = JT.prefill(params, jc, jnp.asarray(emb[:, :6]), jcache)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    for t in range(6, 11):
        step, cache = model.decode_step(torch.from_numpy(emb[:, t:t + 1]), cache)
        jstep, jcache = JT.decode_step(params, jc, jnp.asarray(emb[:, t:t + 1]), jcache)
        np.testing.assert_allclose(_np(step), _np(full[:, t]), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(step), _np(jstep), **TOL)
    np.testing.assert_allclose(_np(cache.k[:, :, :11]), _np(jcache.k[:, :, :11]), **TOL)
    np.testing.assert_allclose(_np(cache.v[:, :, :11]), _np(jcache.v[:, :, :11]), **TOL)


def test_masked_prefill_keeps_the_encoder_mask_for_the_steps(relu_pair):
    params, jc, model = relu_pair
    emb = _embeds((2, 6, jc.d_model), 4)
    mask = np.array([[1] * 6, [1] * 4 + [0] * 2], bool)
    logits, cache = model.prefill(torch.from_numpy(emb), model.init_cache(2, 9),
                                  attention_mask=torch.from_numpy(mask))
    jl, jcache = JT.prefill(params, jc, jnp.asarray(emb), JT.init_cache(jc, 2, 9),
                            attention_mask=jnp.asarray(mask))
    np.testing.assert_allclose(_np(logits[:, -1]), _np(jl[:, -1]), **TOL)
    step_in = model.embed_tokens(torch.tensor([3, 5]))[:, None]
    step, _ = model.decode_step(step_in, cache)
    jstep, _ = JT.decode_step(params, jc, jnp.asarray(step_in.numpy()), jcache)
    np.testing.assert_allclose(_np(step), _np(jstep), **TOL)


def test_ring_steps_and_scatter_refill_match_jax(gated_pair):
    """Serving's device steps: a ring cache of 9 positions prefilled for 3
    rows, ring steps, a refill of rows [1, 3) by scatter_refill (each
    request's encoder output swapped in by a row paste), and more ring steps
    past the ring's wrap, each step's logits against JAX's."""
    params, jc, model = gated_pair
    p, ring = 4, 9
    pre = _embeds((3, p, jc.d_model), 5)
    new = _embeds((2, p, jc.d_model), 6)
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, size=(12, 3))
    _, cache = model.prefill(torch.from_numpy(pre), model.init_cache(3, ring))
    _, jcache = JT.prefill(params, jc, jnp.asarray(pre), JT.init_cache(jc, 3, ring))
    pos, start = np.full(3, p), np.zeros(3, np.int64)
    for s in range(12):
        if s == 3:
            _, small = model.prefill(torch.from_numpy(new), model.init_cache(2, p))
            cache = TT.T5.scatter_refill(cache, small, 1)
            _, jsmall = JT.prefill(params, jc, jnp.asarray(new), JT.init_cache(jc, 2, p))
            jcache = JT.scatter_refill(jcache, jsmall, 1)
            np.testing.assert_allclose(_np(cache.enc_hidden), _np(jcache.enc_hidden), **TOL)
            start[1:] = cache.index - p
            pos[1:] = p
        emb = model.embed_tokens(torch.from_numpy(toks[s]))[:, None]
        got, cache = model.decode_step_ring(emb, cache, torch.from_numpy(pos),
                                            torch.from_numpy(start))
        want, jcache = JT.decode_step_ring(params, jc, jnp.asarray(emb.numpy()), jcache,
                                           jnp.asarray(pos), jnp.asarray(start))
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"step {s}")
        pos += 1
    assert cache.index == int(jcache.index) == p + 12 > ring


def test_scatter_refill_refuses_a_masked_cache(relu_pair):
    _, jc, model = relu_pair
    emb = torch.from_numpy(_embeds((1, 3, jc.d_model), 8))
    _, big = model.prefill(emb, model.init_cache(1, 6), attention_mask=torch.ones(1, 3))
    _, small = model.prefill(emb, model.init_cache(1, 3))
    with pytest.raises(ValueError, match="enc_bias"):
        TT.T5.scatter_refill(big, small, 0)


def test_bf16_logits_within_bf16_bound():
    params, jc, model = _pair(GATED, dtype=jnp.bfloat16)
    assert model.shared.dtype == torch.bfloat16
    x = _embeds((2, 6, jc.d_model), 9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax.jit(lambda p, e: JT.apply(p, jc, e))(params, xb)
    got = model(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    bound = BF16_STEPS * 2.0**-8 * float(np.abs(_np(want)).max())
    assert np.abs(_np(got) - _np(want)).max() <= bound
    # the cached path: prefill and two steps, in a bf16 cache
    logits, cache = model.prefill(torch.from_numpy(x).to(torch.bfloat16), model.init_cache(2, 9))
    jl, jcache = JT.prefill(params, jc, xb, JT.init_cache(jc, 2, 9, dtype=jnp.bfloat16))
    assert cache.k.dtype == torch.bfloat16
    assert np.abs(_np(logits[:, -1]) - _np(jl[:, -1])).max() <= bound
    for tok in ([4, 9], [11, 2]):
        emb = model.embed_tokens(torch.tensor(tok))[:, None]
        got, cache = model.decode_step(emb, cache)
        want, jcache = JT.decode_step(params, jc, jnp.asarray(_np(emb)).astype(jnp.bfloat16),
                                      jcache)
        assert np.abs(_np(got) - _np(want)).max() <= bound


def _int8_state(model8) -> dict:
    return {k: convert.to_numpy(v) for k, v in model8.state_dict().items()}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":  # bf16 as |V2 or ml_dtypes
        a, b = a.view(np.int16), b.view(np.int16)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_params_matches_jax(dtype):
    """q equal and s bit-equal to eager JAX's quantize_params, the dense
    leaves kept; against JAX's jitted quantization (enable_int8_decode's)
    of the f32 model, q equal and s within an f32 ulp."""
    params, jc, model = _pair(GATED, dtype=dtype)
    q8 = TT.quantize_params(model)
    assert isinstance(q8, TT.T5Int8) and not hasattr(q8, "chunked_forward")
    got = _int8_state(q8)
    want = convert.t5_state_dict(jax.tree_util.tree_map(np.asarray, JT.quantize_params(params)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same_bits(got[k], want[k]), k
    assert got["lm_head.q"].dtype == np.int8 and "shared" in got
    if dtype == jnp.float32:
        jitted = convert.t5_state_dict(jax.tree_util.tree_map(
            np.asarray, jax.jit(JT.quantize_params)(params)))
        for k in jitted:
            if k.endswith(".s"):
                np.testing.assert_allclose(got[k], jitted[k], rtol=2.5e-7, atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], jitted[k], err_msg=k)
    # the converters read JAX's int8 tree into an allocated T5Int8, and back
    loaded = convert.load(TT.T5Int8(TC.T5Config(**GATED), device="cpu",
                                    dtype=q8.shared.dtype), want)
    assert all(_same_bits(v, got[k]) for k, v in _int8_state(loaded).items())
    back = convert.t5_params(got)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(JT.quantize_params(params))):
        assert _same_bits(a, b)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_int8_greedy_matches_jitted_jax(dtype):
    """A peaked T5 quantized in both packages (JAX's under jit, as
    enable_int8_decode does), greedy decode of 4 prompts x 16 tokens with
    jitted JAX's engine. f32 activations: the tokens are equal. bf16: the
    prefill logits lie within the bf16 bound of JAX's, and each row's
    tokens are equal up to the first that differs, where JAX's own top-2
    gap must be under the bound (compiled XLA's f32 chains, see above)."""
    params, jc, model = _pair(GATED, dtype=dtype, seed=1, peaked=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    q = jax.jit(JT.quantize_params)(params)
    q8 = TT.quantize_params(model)
    prompt = _embeds((4, 5, jc.d_model), 10) * 50.0
    pj, pt = jnp.asarray(prompt).astype(dtype), torch.from_numpy(prompt).to(tdt)
    settings = dict(max_new_tokens=16, greedy=True)
    want = np.asarray(JE.generate(JT, q, jc, pj, JE.GenerationSettings(**settings))["tokens"])
    got = TE.generate(q8, pt, TE.GenerationSettings(**settings), device="cpu")["tokens"].numpy()
    jl, jcache = jax.jit(lambda p, e, c: JT.prefill(p, jc, e, c))(
        q, pj, JT.init_cache(jc, 4, 21, dtype=dtype))
    logits, _ = q8.prefill(pt, q8.init_cache(4, 21))
    assert logits.dtype == tdt  # an int8 linear returns its input's dtype
    bound = BF16_STEPS * 2.0**-8 * float(np.abs(_np(jl)).max())
    assert np.abs(_np(logits[:, -1]) - _np(jl[:, -1])).max() <= bound
    if dtype == jnp.float32:
        np.testing.assert_array_equal(got, want)
        return
    # JAX's top-2 gap at each of its own greedy steps
    step = jax.jit(JT.decode_step, static_argnums=1)
    last, gaps = _np(jl[:, -1]), []
    for t in range(16):
        top2 = np.sort(last, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        emb = JT.embed_tokens(q, jnp.asarray(want[:, t]))[:, None]
        out, jcache = step(q, jc, emb, jcache)
        last = _np(out)
    for r in range(4):
        diff = np.flatnonzero(got[r] != want[r])
        if diff.size:
            assert gaps[diff[0]][r] < bound, (r, diff[0], gaps[diff[0]][r], bound)
    assert (got == want).mean() > 0.5


def test_embed_tokens_and_embedding_size(relu_pair):
    params, jc, model = relu_pair
    assert model.embedding_size() == JT.embedding_size(params) == jc.d_model
    toks = np.array([[1, 2, 96, 200]])  # past the vocabulary: clamped, as JAX gathers
    np.testing.assert_array_equal(_np(model.embed_tokens(torch.from_numpy(toks))),
                                  _np(JT.embed_tokens(params, jnp.asarray(toks))))


@pytest.mark.parametrize("proj,tie", [("relu", True), ("gated-gelu", False)])
def test_t5_from_state_dict_matches_jax_and_hf(proj, tie):
    from transformers import T5Config as HFT5Config, T5ForConditionalGeneration

    kw = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=3,
              num_heads=4, relative_attention_num_buckets=8, relative_attention_max_distance=32,
              feed_forward_proj=proj, tie_word_embeddings=tie)
    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(HFT5Config(dropout_rate=0.0, attn_implementation="eager",
                                               **kw)).eval()
    sd = hf.state_dict()
    got = TIW.t5_from_state_dict(sd, TC.T5Config(**kw))
    want = convert.t5_state_dict(jax.tree_util.tree_map(
        np.asarray, JIW.t5_from_state_dict(sd, JC.T5Config(**kw))))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = convert.load(TT.T5(TC.T5Config(**kw), device="cpu"), got)
    emb = torch.randn(2, 9, 32)
    with torch.no_grad():
        ref = hf(inputs_embeds=emb, decoder_inputs_embeds=emb).logits
        out = model(emb)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-5, rtol=1e-4)


def test_t0_11b_preset_geometry():
    """T5Config.variant("t0-11b"): bigscience/T0, the T5 v1.1 XXL geometry,
    ~11.1B parameters (counted from the shapes, nothing allocated)."""
    cfg = TC.T5Config.variant("t0-11b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JC.T5Config.variant("t0-11b"))
    d, f, inner = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.d_kv
    attn, mlp = 4 * d * inner, 3 * d * f
    n = (2 * cfg.vocab_size * d + cfg.num_layers * (attn + mlp + 2 * d)
         + cfg.num_decoder_layers * (2 * attn + mlp + 3 * d)
         + 2 * cfg.relative_attention_num_buckets * cfg.num_heads + 2 * d)
    assert (d, f, cfg.num_heads, cfg.d_kv, cfg.vocab_size) == (4096, 10240, 64, 64, 32128)
    assert 11.0e9 < n < 11.2e9
