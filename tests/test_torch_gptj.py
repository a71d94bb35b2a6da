"""The port's float GPT-J (models/gptj.GPTJ) against the JAX package's
models/gptj.py and HF's GPTJForCausalLM, on the CPU.

- f32: apply (with a padding mask, a logits slice and remat), prefill,
  decode_step, a multi-token continuation of the cache (speculative
  verification's chunk), decode_step_ring at per-row positions across
  refills and wraps, and scatter_refill, at atol/rtol 1e-5 against JAX;
- bf16: the same surfaces within 4 bf16 steps of the logits' scale (the
  rule of tests/test_torch_gpt2_dtypes.py). JAX's f32 rotary table
  promotes q and k to f32; the full forward attends them so, the cached
  path rounds k to the cache's bf16, and the port does each the same way;
- HF's GPTJForCausalLM with a padding mask, in f32, through the port's HF
  converter, which equals JAX's converter through convert.py;
- the converter both ways, the embedding's clamp of out-of-range ids
  (JAX's gather clamps them), the registry and GPT-J's tokenizer wrapper.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import gpt2 as JG2
from clipcap_tpu.models import gptj as JG
from clipcap_tpu.tokenizers import api as JTOK
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Int8
from clipcap_tpu_torch.models.gptj import GPTJ, GPTJInt8
from clipcap_tpu_torch.tokenizers import api as TTOK
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode
from clipcap_tpu_torch.tools import import_weights as TW

LM = dict(vocab_size=211, n_positions=64, n_embd=48, n_layer=3, n_head=4, rotary_dim=8)
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_STEP = 2.0 ** -8
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# JAX's cached entry points, compiled once per shape (eager calls retrace
# their layer scan every time); the config is static
J_PREFILL = jax.jit(JG.prefill, static_argnums=1)
J_STEP = jax.jit(JG.decode_step, static_argnums=1)
J_RING = jax.jit(JG.decode_step_ring, static_argnums=1)


@pytest.fixture(scope="module")
def pair():
    """JAX's init of the tiny GPT-J, and the port's module loaded from it."""
    cfg = JC.GPTJConfig(**LM)
    params = JG.init(jax.random.PRNGKey(3), cfg)
    model = convert.load(GPTJ(TC.GPTJConfig(**LM), device="cpu"),
                         convert.gptj_state_dict(_np(params)))
    return cfg, params, model


def _close_bf16(got, want, what: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = STEPS * BF16_STEP * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs err {err:.4g} > {STEPS} bf16 steps {tol:.4g}"


@pytest.mark.parametrize("masked,sliced,remat", [(False, False, False), (True, True, False),
                                                 (True, False, True)])
def test_apply_matches_jax(pair, masked, sliced, remat):
    cfg, params, model = pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, LM["n_embd"])).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    kw, jkw = {}, {}
    if masked:
        kw["attention_mask"], jkw["attention_mask"] = torch.from_numpy(mask), jnp.asarray(mask)
    if sliced:
        kw["logits_slice"] = jkw["logits_slice"] = (3, 8)
    want = JG.apply(params, cfg, jnp.asarray(x), **jkw)
    with torch.no_grad():
        got = model(torch.from_numpy(x), remat=remat, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_decode_and_continuation_match_jax(pair):
    """prefill (every position), three decode steps, then a 4-token
    continuation of the cache through forward_cached (JAX's _forward_cached
    at index > 0, speculative verification's chunk)."""
    cfg, params, model = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 13, LM["n_embd"])).astype(np.float32)
    jc = JG.init_cache(cfg, 2, 16)
    want, jc = JG.prefill(params, cfg, jnp.asarray(x[:, :6]), jc)
    cache = model.init_cache(2, 16)
    with torch.no_grad():
        got, cache = model.prefill(torch.from_numpy(x[:, :6]), cache, full_logits=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for t in range(6, 9):
            want, jc = J_STEP(params, cfg, jnp.asarray(x[:, t:t + 1]), jc)
            got, cache = model.decode_step(torch.from_numpy(x[:, t:t + 1]), cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        want, jc = JG._forward_cached(params, cfg, jnp.asarray(x[:, 9:13]), jc)
        got, cache = model.forward_cached(torch.from_numpy(x[:, 9:13]), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache.index == int(jc.index) == 13
    np.testing.assert_allclose(cache.k[:, :, :13].numpy(), np.asarray(jc.k)[:, :, :13], **TOL)
    # the chunk equals the full forward over all 13 positions, as JAX's does
    full = JG.apply(params, cfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(full)[:, 9:13], atol=1e-4, rtol=1e-4)


def test_bf16_matches_jax(pair):
    """apply, prefill and decode steps on the bf16 weights within 4 bf16
    steps of the logits' scale."""
    cfg, params, model = pair
    pb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    mb = convert.load(GPTJ(TC.GPTJConfig(**LM), device="cpu"), convert.gptj_state_dict(_np(pb)))
    assert mb.wte.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, LM["n_embd"])).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    mask = np.ones((2, 10), np.int32)
    mask[0, 7:] = 0
    with torch.no_grad():
        got = mb(xb, attention_mask=torch.from_numpy(mask))
    _close_bf16(got, JG.apply(pb, cfg, xj, attention_mask=jnp.asarray(mask)), "bf16 apply")
    jc = JG.init_cache(cfg, 2, 12, jnp.bfloat16)
    want, jc = JG.prefill(pb, cfg, xj[:, :6], jc)
    cache = mb.init_cache(2, 12)
    assert cache.k.dtype == torch.bfloat16
    with torch.no_grad():
        got, cache = mb.prefill(xb[:, :6], cache, full_logits=True)
        _close_bf16(got, want, "bf16 prefill")
        for t in range(6, 10):
            want, jc = J_STEP(pb, cfg, xj[:, t:t + 1], jc)
            got, cache = mb.decode_step(xb[:, t:t + 1], cache)
            _close_bf16(got, want, f"bf16 decode step {t}")


T = 9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_ring_and_scatter_refill_match_jax(pair, dtype):
    """Three rows on a 9-slot ring: prefill P=5, decode with every row at its
    own logical position (rotary per row), refill rows [1, 3) twice, and
    run until the ring has wrapped twice. f32 at 1e-5, bf16 within 4 steps;
    the pasted window equal to JAX's."""
    cfg, params, model = pair
    jdt = jnp.dtype(dtype)
    pj = jax.tree_util.tree_map(lambda a: a.astype(jdt), params)
    m = convert.load(GPTJ(TC.GPTJConfig(**LM), device="cpu"), convert.gptj_state_dict(_np(pj)))
    rng = np.random.default_rng(4)
    b, p, d = 3, 5, LM["n_embd"]

    def close(got, want, what):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)
        else:
            _close_bf16(got, want, what)

    prefix = rng.normal(size=(b, p, d)).astype(np.float32)
    jc = JG.init_cache(cfg, b, T, jdt)
    want, jc = JG.prefill(pj, cfg, jnp.asarray(prefix).astype(jdt), jc)
    cache = m.init_cache(b, T)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got, cache = m.prefill(torch.from_numpy(prefix).to(tdt), cache, full_logits=True)
    close(got, want, "ring prefill")
    pos = np.full(b, p, np.int64)
    start = np.zeros(b, np.int64)
    for step in range(22):
        if step in (4, 11):
            q = 1 if step == 4 else 2
            new = rng.normal(size=(b - q, p, d)).astype(np.float32)
            js = JG.init_cache(cfg, b - q, p, jdt)
            _, js = J_PREFILL(pj, cfg, jnp.asarray(new).astype(jdt), js)
            jc = JG.scatter_refill(jc, js, jnp.int32(q))
            small = m.init_cache(b - q, p)
            with torch.no_grad():
                _, small = m.prefill(torch.from_numpy(new).to(tdt), small)
            cache = GPTJ.scatter_refill(cache, small, q)
            win = ((cache.index - p + np.arange(p)) % T)
            assert torch.equal(cache.k[:, q:, win], small.k)
            pasted = np.asarray(jc.k.astype(jnp.float32))[:, q:, win]
            np.testing.assert_allclose(cache.k[:, q:, win].float().numpy(), pasted,
                                       atol=1e-5 if dtype == "float32" else
                                       2 * BF16_STEP * float(np.abs(pasted).max()))
            start[q:] = cache.index - p
            pos[q:] = p
        tok = rng.integers(0, LM["vocab_size"], b)
        want, jc = J_RING(pj, cfg, JG.embed_tokens(pj, jnp.asarray(tok))[:, None],
                                       jc, jnp.asarray(pos, jnp.int32),
                                       jnp.asarray(start, jnp.int32))
        with torch.no_grad():
            got, cache = m.decode_step_ring(m.embed_tokens(torch.from_numpy(tok))[:, None], cache,
                                            torch.from_numpy(pos), torch.from_numpy(start))
        assert cache.index == int(jc.index)
        close(got, want, f"ring step {step}")
        pos = np.minimum(pos + 1, LM["n_positions"] - 1)
    assert cache.index > 2 * T


@pytest.fixture(scope="module")
def hf_pair():
    from transformers import GPTJConfig as HFConfig
    from transformers import GPTJForCausalLM

    cfg = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4, rotary_dim=8)
    torch.manual_seed(0)
    hf = GPTJForCausalLM(HFConfig(**cfg, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
                                  attn_implementation="eager")).eval()
    with torch.no_grad():  # HF zero-inits biases: make them count
        for name, p in hf.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02)
    model = convert.load(GPTJ(TC.GPTJConfig(**cfg), device="cpu"),
                         TW.gptj_from_state_dict(hf.state_dict(), TC.GPTJConfig(**cfg)))
    return hf, model, cfg


def test_f32_forward_with_mask_matches_hf(hf_pair):
    hf, model, _ = hf_pair
    torch.manual_seed(2)
    embeds = torch.randn(2, 8, 64)
    mask = torch.ones(2, 8, dtype=torch.long)
    mask[1, 6:] = 0
    with torch.no_grad():
        want = hf(inputs_embeds=embeds, attention_mask=mask).logits
        got = model(embeds, attention_mask=mask)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got[1, :6].numpy(), want[1, :6].numpy(), atol=1e-5, rtol=1e-4)


def test_hf_converter_matches_jax(hf_pair):
    """The port's HF converter equals JAX's gptj_from_state_dict, leaf for
    leaf, through convert.gptj_state_dict; bare GPTJModel keys convert too."""
    hf, _, cfg = hf_pair
    sd = hf.state_dict()
    got = TW.gptj_from_state_dict(sd, TC.GPTJConfig(**cfg))
    want = convert.gptj_state_dict(_np(JW.gptj_from_state_dict(sd, JC.GPTJConfig(**cfg))))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bare = {k.removeprefix("transformer."): v for k, v in sd.items()}
    again = TW.gptj_from_state_dict(bare, TC.GPTJConfig(**cfg))
    assert all(np.array_equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips(pair, dtype):
    """convert.gptj_params inverts gptj_state_dict, float and int8 trees,
    and a Captioner with a GPT-J LM converts both ways by its lm_type."""
    from clipcap_tpu.models import captioner as JCAP
    from clipcap_tpu_torch.models.captioner import Captioner

    cfg, params, _ = pair
    tree = _np(jax.tree_util.tree_map(lambda a: a.astype(jnp.dtype(dtype)), params))
    for t in (tree, _np(JG.quantize_params(tree))):
        back = convert.gptj_params(convert.gptj_state_dict(t), LM["n_layer"])
        flat_a, flat_b = jax.tree_util.tree_leaves(t), jax.tree_util.tree_leaves(back)
        assert jax.tree_util.tree_structure(t) == jax.tree_util.tree_structure(back)
        assert all(np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))
                   for a, b in zip(flat_a, flat_b))
    mapper = dict(dim_clip=16, dim_embedding=LM["n_embd"], prefix_length=3, clip_length=3,
                  num_layers=1, num_heads=2)
    cap_t = TC.CaptionerConfig(lm_type="gptj", mapper=TC.MapperConfig(**mapper))
    seeded = Captioner(cap_t, TC.GPTJConfig(**LM), device="cpu", seed=5)
    jparams = convert.captioner_params(seeded)  # JAX's layout
    model = convert.load(Captioner(cap_t, TC.GPTJConfig(**LM), device="cpu", seed=6),
                         convert.captioner_state_dict(jparams, "gptj"))
    assert isinstance(model.lm, GPTJ)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 seeded.state_dict().values()))
    back = convert.captioner_params(model)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(jparams),
                                                    jax.tree_util.tree_leaves(back)))
    cap_j = JC.CaptionerConfig(lm_type="gptj", mapper=JC.MapperConfig(**mapper))
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    feats = np.random.default_rng(6).normal(size=(2, 16)).astype(np.float32)
    tokens = np.random.default_rng(7).integers(0, LM["vocab_size"], (2, 4)).astype(np.int32)
    want = jax.jit(JCAP.forward, static_argnums=(1, 2))(jparams, cap_j, cfg, jnp.asarray(tokens),
                                                        jnp.asarray(feats))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_tokens_clamp_out_of_range_ids_as_jax(pair):
    """JAX's gather clamps an id past the vocabulary to the last row; each LM
    of the port does the same on the device, where it raised IndexError
    before (a GPT-2 draft of a wider GPT-J)."""
    cfg, params, model = pair
    v = LM["vocab_size"]
    ids = np.asarray([[3, v - 1, v, v + 40, 0]])
    want = np.asarray(JG.embed_tokens(params, jnp.asarray(ids)))
    np.testing.assert_array_equal(model.embed_tokens(torch.from_numpy(ids)).detach().numpy(),
                                  want)
    g2 = dict(vocab_size=97, n_positions=32, n_embd=16, n_layer=1, n_head=2)
    p2 = JG2.init(jax.random.PRNGKey(1), JC.GPT2Config(**g2))
    m2 = convert.load(GPT2(TC.GPT2Config(**g2), device="cpu"), convert.gpt2_state_dict(_np(p2)))
    ids2 = np.asarray([[0, 96, 97, 500]])
    np.testing.assert_array_equal(m2.embed_tokens(torch.from_numpy(ids2)).detach().numpy(),
                                  np.asarray(JG2.embed_tokens(p2, jnp.asarray(ids2))))
    q8 = GPT2Int8(TC.GPT2Config(**g2), device="cpu")
    q8.wte.data.normal_()
    assert torch.equal(q8.embed_tokens(torch.tensor([500])), q8.wte[96][None])
    j8 = GPTJInt8(TC.GPTJConfig(**LM), device="cpu")
    assert torch.equal(j8.embed_tokens(torch.tensor([v + 7])), j8.wte[v - 1][None])


def test_registry_and_config_resolve_gptj():
    from clipcap_tpu_torch.lm import registry

    assert registry.get_lm("gpt-j") is GPTJ and registry.get_lm("GPTJ") is GPTJ
    assert registry.get_lm_config("gptj", "EleutherAI/gpt-j-6B") == TC.GPTJConfig()
    c = TC.GPTJConfig()
    assert (c.vocab_size, c.n_embd, c.n_layer, c.n_head, c.rotary_dim) == (50400, 4096, 28, 16, 64)
    assert GPTJ.chunked_forward and not GPTJInt8.chunked_forward
    # the int8 module has no multi-token or shared-prefix beam path, as JAX's
    assert not hasattr(GPTJInt8, "forward_cached") and not hasattr(GPTJInt8, "beam_prefix_cache")


def test_gptj_tokenizer_truncates_only_and_drops_padding_ids(tmp_path):
    base = list(bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("h", "e")]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        base + ["".join(m) for m in merges] + ["<|endoftext|>"]))}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(f"{a} {b}" for a, b in merges) + "\n")
    got = TTOK.create_tokenizer("gpt-j", str(tmp_path))
    want = JTOK.create_tokenizer("gptj", str(tmp_path))
    assert isinstance(got, TTOK.GPTJTokenizerWrapper)
    text = "the cat the hat"
    for n in (None, 2):
        assert got.encode_text(text, max_token_length=n) == want.encode_text(
            text, max_token_length=n)
    # the specials the validator asks for, which JAX's GPT-J wrapper refuses
    with pytest.raises(TypeError):
        want.encode_text(text, add_bos=True)
    eot = got.bos_token_id
    assert got.encode_text(text, 2, add_bos=True, add_eos=True) == [eot] + got.encode(text)[:4] \
        + [eot]
    ids = got.encode_text(text)
    assert got.decode_tokens(ids + [len(vocab) + 5, 50399]) == want.decode_tokens(ids) == text
    assert (got.bos_token_id, got.all_special_ids) == (want.bos_token_id, want.all_special_ids)
