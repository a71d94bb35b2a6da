"""The port's models on parameters converted from the JAX package's init
(convert.py), against the JAX models on the same numpy inputs.

Tolerance: f32 at atol 1e-4 / rtol 1e-4 — two BLAS libraries sum the
matmuls in different orders, and the error grows through the layers
(measured max differences are ~1e-5 at these widths).
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu.models import mapper as JM
from clipcap_tpu.models import vit as JV
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models import vit as TV
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.models.mapper import Mapper

TOL = dict(atol=1e-4, rtol=1e-4)


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


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


VIT_CASES = [
    (dict(image_size=64, patch_size=16, width=64, layers=2, heads=2, output_dim=32), "pooled"),
    (dict(image_size=64, patch_size=16, width=64, layers=2, heads=2, output_dim=32),
     "tokens_proj"),
    (dict(image_size=48, patch_size=16, width=64, layers=2, heads=2, output_dim=None,
          style="blip", layer_norm_epsilon=1e-6), "tokens"),
]


@pytest.mark.parametrize("kw,mode", VIT_CASES)
def test_vit_matches_jax(kw, mode, rng):
    params = JV.init(jax.random.PRNGKey(1), JC.ViTConfig(**kw))
    model = convert.load(TV.ViT(TC.ViTConfig(**kw), device="cpu"),
                         convert.vit_state_dict(_tree(params)))
    px = rng.normal(size=(2, 3, kw["image_size"], kw["image_size"])).astype(np.float32)
    want = JV.apply(params, JC.ViTConfig(**kw), jnp.asarray(px), output=mode)
    with torch.no_grad():
        got = model(torch.from_numpy(px), output=mode)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_patchify_matches_jax(rng):
    px = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    np.testing.assert_array_equal(_np(TV.patchify(torch.from_numpy(px), 8)),
                                  _np(JV.patchify(jnp.asarray(px), 8)))


MAPPER_CASES = [
    dict(dim_clip=24, dim_embedding=32, prefix_length=4, clip_length=3, num_layers=2,
         num_heads=4),
    dict(dim_clip=24, dim_embedding=32, prefix_length=4, clip_length=3, num_layers=2,
         num_heads=4, act_fn="geglu"),
    dict(dim_clip=24, dim_embedding=32, prefix_length=4, clip_length=5, num_layers=2,
         num_heads=4, use_all_features=True, use_pos_embeddings=True, act_fn="gelu"),
]


@pytest.mark.parametrize("kw", MAPPER_CASES)
def test_mapper_matches_jax(kw, rng):
    params = JM.init(jax.random.PRNGKey(2), JC.MapperConfig(**kw))
    model = convert.load(Mapper(TC.MapperConfig(**kw), device="cpu"),
                         convert.mapper_state_dict(_tree(params)))
    shape = (3, kw["clip_length"], 24) if kw.get("use_all_features") else (3, 24)
    x = rng.normal(size=shape).astype(np.float32)
    want = JM.apply(params, jnp.asarray(x), JC.MapperConfig(**kw))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


LM = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def gpt2_pair():
    params = JG.init(jax.random.PRNGKey(3), JC.GPT2Config(**LM))
    model = convert.load(GPT2(TC.GPT2Config(**LM), device="cpu"),
                         convert.gpt2_state_dict(_tree(params)))
    return params, model


def test_gpt2_apply_with_mask_and_slice(gpt2_pair, rng):
    params, model = gpt2_pair
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    for kw in (dict(), dict(attention_mask=mask), dict(logits_slice=(3, 8))):
        jkw = {k: (jnp.asarray(v) if k == "attention_mask" else v) for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if k == "attention_mask" else v) for k, v in kw.items()}
        want = JG.apply(params, JC.GPT2Config(**LM), jnp.asarray(x), **jkw)
        with torch.no_grad():
            got = model(torch.from_numpy(x), **tkw)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_gpt2_prefill_and_decode_steps(gpt2_pair, rng):
    params, model = gpt2_pair
    cfg_j = JC.GPT2Config(**LM)
    prompt = rng.normal(size=(2, 6, 32)).astype(np.float32)
    steps = rng.normal(size=(3, 2, 1, 32)).astype(np.float32)
    jl, jc = JG.prefill(params, cfg_j, jnp.asarray(prompt), JG.init_cache(cfg_j, 2, 10))
    with torch.no_grad():
        tl, tc = model.prefill(torch.from_numpy(prompt), model.init_cache(2, 10))
    assert tuple(tl.shape) == (2, 1, 97) and tc.index == 6
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tc.k[:, :, :6]), _np(jc.k[:, :, :6]), **TOL)
    for s in steps:
        jl, jc = JG.decode_step(params, cfg_j, jnp.asarray(s), jc)
        with torch.no_grad():
            tl, tc = model.decode_step(torch.from_numpy(s), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert tc.index == int(jc.index) == 9
    # the cached path equals one full forward over the whole sequence
    full = np.concatenate([prompt, steps[:, :, 0].transpose(1, 0, 2)], axis=1)
    with torch.no_grad():
        whole = model(torch.from_numpy(full))
    np.testing.assert_allclose(_np(whole[:, -1]), _np(tl), **TOL)


def test_embed_tokens(gpt2_pair):
    params, model = gpt2_pair
    tok = np.asarray([[1, 5, 96], [0, 2, 3]], np.int32)
    np.testing.assert_array_equal(_np(model.embed_tokens(torch.from_numpy(tok))),
                                  _np(JG.embed_tokens(params, jnp.asarray(tok))))


@pytest.mark.parametrize("normalize_prefix", [False, True])
def test_captioner_project_prefix_and_forward(normalize_prefix, rng):
    map_kw = dict(dim_clip=24, dim_embedding=32, prefix_length=4, clip_length=3, num_layers=1,
                  num_heads=4)
    cap_j = JC.CaptionerConfig(mapper=JC.MapperConfig(**map_kw), normalize_prefix=normalize_prefix)
    cap_t = TC.CaptionerConfig(mapper=TC.MapperConfig(**map_kw), normalize_prefix=normalize_prefix)
    params = JCAP.init(jax.random.PRNGKey(4), cap_j, JC.GPT2Config(**LM))
    model = convert.load(Captioner(cap_t, TC.GPT2Config(**LM), device="cpu"),
                         convert.captioner_state_dict(_tree(params)))
    feats = rng.normal(size=(2, 24)).astype(np.float32)
    tokens = rng.integers(0, 97, (2, 5)).astype(np.int32)
    want = JCAP.project_prefix(params, cap_j, jnp.asarray(feats))
    with torch.no_grad():
        got = model.project_prefix(torch.from_numpy(feats))
        logits = model(torch.from_numpy(tokens), torch.from_numpy(feats))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    want = JCAP.forward(params, cap_j, JC.GPT2Config(**LM), jnp.asarray(tokens),
                        jnp.asarray(feats))
    np.testing.assert_allclose(_np(logits), _np(want), **TOL)


def test_convert_rejects_mismatched_params():
    params = _tree(JG.init(jax.random.PRNGKey(3), JC.GPT2Config(**LM)))
    model = GPT2(TC.GPT2Config(**dict(LM, n_layer=3)), device="cpu")
    with pytest.raises(KeyError):
        convert.load(model, convert.gpt2_state_dict(params))


def test_registry_is_gpt2_only():
    """The registry resolves every family JAX's does (the name stays from
    when gpt2 was all it had): gpt2, gptj, and t5/t0, each with its
    converters, quantizer and HF importer; t5/t0's config is the default
    T5Config whatever the variant, as JAX's registry gives it; an unknown
    family is refused."""
    from clipcap_tpu.lm import registry as jax_registry
    from clipcap_tpu_torch.lm import registry
    from clipcap_tpu_torch.models.gptj import GPTJ
    from clipcap_tpu_torch.models.t5 import T5

    assert registry.get_lm("GPT2") is GPT2
    assert registry.get_lm_config("gpt2", "gpt2-xl").n_embd == 1600
    for name in ("gptj", "gpt-j"):
        assert registry.get_lm(name) is GPTJ
        assert (dataclasses.asdict(registry.get_lm_config(name, "EleutherAI/gpt-j-6B"))
                == dataclasses.asdict(jax_registry.get_lm_config(name, "EleutherAI/gpt-j-6B")))
    for name in ("t5", "t0", "T0"):
        assert registry.get_lm(name) is T5
        for variant in ("t0-11b", "bigscience/T0pp", "gpt2"):
            got = registry.get_lm_config(name, variant)
            assert isinstance(got, TC.T5Config) and got == TC.T5Config()
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jax_registry.get_lm_config(name, variant))
    from clipcap_tpu_torch import convert
    from clipcap_tpu_torch.models import gpt2, gptj, t5
    from clipcap_tpu_torch.tools import import_weights

    for name, mod in (("gpt2", gpt2), ("gpt-j", gptj), ("t0", t5)):
        fam, t = registry.family(name), registry.normalize_lm_type(name)
        assert fam.quantize_params is mod.quantize_params
        assert fam.state_dict is getattr(convert, f"{t}_state_dict")
        assert fam.params is getattr(convert, f"{t}_params")
        assert fam.from_hf is getattr(import_weights, f"{t}_from_state_dict")
    with pytest.raises(ValueError):
        registry.get_lm("bert")
