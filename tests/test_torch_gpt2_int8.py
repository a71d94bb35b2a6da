"""GPT-2's int8 decode module (models/gpt2.GPT2Int8) against the JAX
package's gpt2_int8 on the CPU.

- quantize_params: the port's quantization of a float GPT-2 equals JAX's
  quantize_params leaf for leaf, through the converter both ways (lm_head
  padded to a multiple of 8 channels in the port, sliced back for JAX);
- prefill (full logits) and 6 decode_steps against prefill_q8 and
  decode_step_q8 within 4 bf16 steps of the logits' scale (the rule of
  tests/test_torch_gpt2_dtypes.py: activations are bf16 in both, rounded at
  different points); the int8 cache's layer-0 K/V equal JAX's wherever the
  bf16 activations they quantize are equal;
- decode_step_ring and scatter_refill against decode_step_ring_q8 and
  scatter_refill_q8 (the pasted window bit for bit);
- the golden `greedy_int8` tokens (tests/fixtures/golden_tokens.json, on
  JAX's captioner.init converted to the port) token for token;
- at the golden config, prefill and decode logits equal jax.jit's bit for
  bit (XLA's fusions keep two bf16 roundings out, and the port does too);
- the shared-prefix beam step bit-equal to decode_step on the
  beam-replicated cache, through index_select reorders, and close to
  JAX's decode_step_beam_q8.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu.ops import layernorm as JLN
from clipcap_tpu.ops import quant as JQ
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode.beam import _expand_beams, _reorder_cache_tail
from clipcap_tpu_torch.models import gpt2 as TG
from clipcap_tpu_torch.models.captioner import Captioner

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_tokens.json").read_text())
BF16_STEP = 2.0 ** -8
STEPS = 4
LM = dict(vocab_size=97, n_positions=64, n_embd=64, n_layer=2, n_head=4)


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
    """A tiny GPT-2 from JAX's init: JAX's quantize_params tree, and the
    port's int8 module loaded from it through the converter."""
    cfg = JC.GPT2Config(**LM)
    params = JG.init(jax.random.PRNGKey(0), cfg)
    qparams = JG.quantize_params(params)
    model = convert.load(TG.GPT2Int8(TC.GPT2Config(**LM), device="cpu"),
                         convert.gpt2_state_dict(_np(qparams)))
    return params, qparams, model


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _close_bf16(got, want, what: str):
    got, want = _f32(got), _f32(want)
    tol = STEPS * BF16_STEP * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs err {err:.4g} > {tol:.4g}"


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind == "V" else a


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def test_quantize_params_matches_jax_through_the_converter(pair):
    params, qparams, model = pair
    fmodel = convert.load(TG.GPT2(TC.GPT2Config(**LM), device="cpu"),
                          convert.gpt2_state_dict(_np(params)))
    ported = TG.quantize_params(fmodel)
    # the port's own quantization is JAX's tree, converted
    a, b = ported.state_dict(), model.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert a["lm_head.q"].shape == (104, 64) and a["wte"].dtype == torch.bfloat16
    # and back: the JAX layout, leaf for leaf (lm_head sliced to the vocabulary)
    back = convert.gpt2_params({k: convert.to_numpy(v) for k, v in a.items()}, LM["n_layer"])
    want = _np(qparams)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_prefill_and_decode_steps_match_jax(pair):
    _, qparams, model = pair
    cfg = JC.GPT2Config(**LM)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jl, jc = JG.prefill_q8(qparams, cfg, jnp.asarray(x), JG.init_cache_q8(cfg, 2, 12),
                           full_logits=True)
    with torch.no_grad():
        tl, tc = model.prefill(_torch(x), model.init_cache(2, 12, dtype=torch.float64),
                               full_logits=True)
    assert tl.shape == (2, 5, LM["vocab_size"]) and tl.dtype == torch.float32
    assert tc.k.dtype == torch.int8 and tc.ks.dtype == torch.float32
    _close_bf16(tl, jl, "prefill logits")

    # layer 0: equal bf16 K/V activations quantize to equal int8 cache entries
    layer0 = jax.tree_util.tree_map(lambda a: a[0], qparams["blocks"])
    h = jnp.asarray(x, jnp.bfloat16) + qparams["wpe"][:5][None]
    h = JLN.layer_norm(h, layer0["ln1"]["g"], layer0["ln1"]["b"])
    qkv = JQ.int8_linear(h, layer0["attn"]["c_attn"]["w"], layer0["attn"]["c_attn"]["b"])
    with torch.no_grad():
        xt = _torch(x).to(torch.bfloat16) + model.wpe[:5][None]
        _, kt, vt = model.blocks[0].qkv(xt)
    for j, (mine, slab) in enumerate(((kt, "k"), (vt, "v"))):
        theirs = np.asarray(jnp.split(qkv, 3, axis=-1)[j + 1]).reshape(2, 5, 4, 16)
        same = (_bits(convert.to_numpy(mine)) == _bits(theirs)).all(-1)  # [B, T, H]
        assert same.mean() > 0.9
        got = getattr(tc, slab)[0, :, :, :5].numpy().transpose(0, 2, 1, 3)  # [B, T, H, Dh]
        want = np.asarray(getattr(jc, slab)[0, :, :, :5]).transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(got[same], want[same])
    assert (tc.k.numpy() == np.asarray(jc.k)).mean() > 0.95

    for s in range(6):
        e = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jl, jc = JG.decode_step_q8(qparams, cfg, jnp.asarray(e), jc)
        with torch.no_grad():
            tl, tc = model.decode_step(_torch(e), tc)
        assert tl.shape == (2, LM["vocab_size"]) and tc.index == 6 + s == int(jc.index)
        _close_bf16(tl, jl, f"decode step {s}")


def test_decode_step_ring_and_scatter_refill_match_jax(pair):
    """Three ring rows, a one-row refill of row 1 and a ring wrap (maxT 10)."""
    _, qparams, model = pair
    cfg = JC.GPT2Config(**LM)
    rng = np.random.default_rng(1)
    p, a_len = 4, 10
    x = rng.normal(size=(3, p, 64)).astype(np.float32)
    _, jc = JG.prefill_q8(qparams, cfg, jnp.asarray(x), JG.init_cache_q8(cfg, 3, a_len))
    with torch.no_grad():
        _, tc = model.prefill(_torch(x), model.init_cache(3, a_len))
    pos, start = np.full(3, p), np.zeros(3, np.int64)
    for s in range(9):
        if s == 3:  # refill row 1 with a fresh 4-position prompt
            y = rng.normal(size=(1, p, 64)).astype(np.float32)
            _, js = JG.prefill_q8(qparams, cfg, jnp.asarray(y), JG.init_cache_q8(cfg, 1, p))
            jc = JG.scatter_refill_q8(jc, js, jnp.int32(1))
            small = TG.Int8KVCache(*(torch.from_numpy(np.array(a)) for a in js[:4]), index=p)
            tc = model.scatter_refill(tc, small, 1)
            rp = np.asarray(JG.refill_positions(jc.index, p, a_len))
            for name in ("k", "v", "ks", "vs"):
                got = getattr(tc, name).numpy()[:, 1][:, :, rp]
                np.testing.assert_array_equal(got, np.asarray(getattr(jc, name))[:, 1][:, :, rp])
            pos[1], start[1] = p, tc.index - p
        e = rng.normal(size=(3, 1, 64)).astype(np.float32)
        jl, jc = JG.decode_step_ring_q8(qparams, cfg, jnp.asarray(e), jc, jnp.asarray(pos),
                                        jnp.asarray(start))
        with torch.no_grad():
            tl, tc = model.decode_step_ring(_torch(e), tc, torch.from_numpy(pos),
                                            torch.from_numpy(start))
        _close_bf16(tl, jl, f"ring step {s}")
        pos = pos + 1
    assert tc.index == int(jc.index) == p + 9  # past maxT: the ring wrapped


@pytest.mark.parametrize("refill_at", [3, 9], ids=["refill_before_wrap", "refill_after_wrap"])
def test_decode_step_ring_device_index_is_bit_equal_to_the_host_index(pair, refill_at):
    """decode_step_ring with `index` (the ring index as a device tensor, as
    serving's CUDA graph replays it) gives the host-index step's logits and
    cache bit for bit: three rows on a 10-slot ring, a one-row
    scatter_refill, 18 steps that wrap the ring twice."""
    _, _, model = pair
    rng = np.random.default_rng(2)
    p, a_len, b = 4, 10, 3
    x = _torch(rng.normal(size=(b, p, 64)).astype(np.float32))
    with torch.no_grad():
        _, host = model.prefill(x, model.init_cache(b, a_len))
    dev = host._replace(**{f: getattr(host, f).clone() for f in ("k", "v", "ks", "vs")})
    pos, start = torch.full((b,), p), torch.zeros(b, dtype=torch.int64)
    for s in range(18):
        with torch.no_grad():
            if s == refill_at:
                y = _torch(rng.normal(size=(1, p, 64)).astype(np.float32))
                _, small = model.prefill(y, model.init_cache(1, p))
                host = model.scatter_refill(host, small, 1)
                dev = model.scatter_refill(dev, small, 1)
                pos[1], start[1] = p, host.index - p
            e = _torch(rng.normal(size=(b, 1, 64)).astype(np.float32))
            want, host = model.decode_step_ring(e, host, pos, start)
            got, dev = model.decode_step_ring(e, dev, pos, start, index=torch.tensor(dev.index))
        assert dev.index == host.index
        assert torch.equal(got, want), f"step {s}"
        for f in ("k", "v", "ks", "vs"):
            assert torch.equal(getattr(dev, f), getattr(host, f)), (s, f)
        pos = pos + 1
    assert host.index == p + 18 > 2 * a_len


def test_golden_greedy_int8():
    lm_cfg = JC.GPT2Config(**GOLDEN["lm_cfg"])
    cap_cfg = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**GOLDEN["map_cfg"]))
    params = JCAP.init(jax.random.PRNGKey(0), cap_cfg, lm_cfg)
    clip_embed = jax.random.normal(jax.random.PRNGKey(1), (GOLDEN["batch"], 512), jnp.float32)
    model = Captioner(TC.CaptionerConfig(mapper=TC.MapperConfig(**GOLDEN["map_cfg"])),
                      TC.GPT2Config(**GOLDEN["lm_cfg"]), device="cpu")
    convert.load(model, convert.captioner_state_dict(_np(params)))
    lm = TG.quantize_params(model.lm)
    with torch.no_grad():
        prefix = model.project_prefix(_torch(clip_embed))
    out = TE.generate(lm, prefix, TE.GenerationSettings(max_new_tokens=GOLDEN["new_tokens"],
                                                        greedy=True), device="cpu")
    assert out["tokens"].tolist() == GOLDEN["greedy_int8"]


def test_logits_equal_jitted_jax_at_the_golden_config():
    """At the golden config (GPT-2's vocabulary, 256 wide, 6 layers) the
    port's int8 prefill and decode steps give jax.jit's logits bit for bit:
    ln2 reads the attention residual's unrounded f32 sum and the MLP's int8
    input is gelu_new's unrounded f32 product, as XLA fuses them
    (_Int8Block.finish). Eager JAX rounds both to bf16."""
    cfg = JC.GPT2Config(**GOLDEN["lm_cfg"])
    lm = TG.GPT2(TC.GPT2Config(**GOLDEN["lm_cfg"]), device="cpu", seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, convert.gpt2_params(
        {k: convert.to_numpy(v) for k, v in lm.state_dict().items()}, cfg.n_layer))
    qparams = JG.quantize_params(params)
    model = convert.load(TG.GPT2Int8(TC.GPT2Config(**GOLDEN["lm_cfg"]), device="cpu"),
                         convert.gpt2_state_dict(_np(qparams)))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, cfg.n_embd)).astype(np.float32)
    jl, jc = jax.jit(JG.prefill_q8, static_argnums=(1, 4))(
        qparams, cfg, jnp.asarray(x), JG.init_cache_q8(cfg, 2, 14), True)
    with torch.no_grad():
        tl, tc = model.prefill(_torch(x), model.init_cache(2, 14), full_logits=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    step = jax.jit(JG.decode_step_q8, static_argnums=1)
    for s in range(3):
        e = rng.normal(size=(2, 1, cfg.n_embd)).astype(np.float32)
        jl, jc = step(qparams, cfg, jnp.asarray(e), jc)
        with torch.no_grad():
            tl, tc = model.decode_step(_torch(e), tc)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).reshape(tl.shape),
                                      err_msg=f"decode step {s}")


@pytest.fixture(scope="module")
def beam_world(pair):
    """Two images' prefilled int8 caches (P=4, 5 tail positions), beam 3."""
    _, qparams, model = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 64)).astype(np.float32)
    with torch.no_grad():
        _, cache = model.prefill(_torch(x), model.init_cache(2, 9))
    return qparams, model, x, cache


def test_shared_prefix_beam_step_is_bit_equal_to_the_replicated_cache(beam_world):
    _, model, _, cache = beam_world
    beam, p = 3, 4
    rep = _expand_beams(TG.Int8KVCache(*(a.clone() for a in cache[:4]), index=p), beam)
    bc = model.beam_prefix_cache(cache, beam, p)
    assert bc.pk.shape == (2, 2, 4, 4, 16) and bc.k.shape == (2, 6, 4, 5, 16)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for s in range(5):
            e = _torch(rng.normal(size=(6, 1, 64)).astype(np.float32))
            want, rep = model.decode_step(e, rep)
            got, bc = model.decode_step_beam(e, bc)
            assert torch.equal(got, want), s
            assert bc.index == rep.index == p + s + 1
            src = torch.from_numpy(np.concatenate([rng.permutation(3), 3 + rng.permutation(3)]))
            rep = _reorder_cache_tail(rep, src, p)
            bc = model.reorder_beam_tail(bc, src)
            for name in ("k", "v", "ks", "vs"):
                assert torch.equal(getattr(bc, name)[:, :, :, : s + 1],
                                   getattr(rep, name)[:, :, :, p: p + s + 1]), name


def test_shared_prefix_beam_step_matches_jax(beam_world):
    qparams, model, x, cache = beam_world
    cfg = JC.GPT2Config(**LM)
    _, jc = JG.prefill_q8(qparams, cfg, jnp.asarray(x), JG.init_cache_q8(cfg, 2, 9))
    jbc = JG.beam_prefix_cache_q8(cfg, jc, 3, 4)
    bc = model.beam_prefix_cache(cache, 3, 4)
    rng = np.random.default_rng(4)
    for s in range(3):
        e = rng.normal(size=(6, 1, 64)).astype(np.float32)
        jl, jbc = JG.decode_step_beam_q8(qparams, cfg, jnp.asarray(e), jbc)
        with torch.no_grad():
            tl, bc = model.decode_step_beam(_torch(e), bc)
        _close_bf16(tl, jl, f"beam step {s}")
