"""Checkpoints keep their stored dtypes, on the CPU: a bf16 checkpoint that
the JAX package writes (save_checkpoint, then consolidate, whose np.savez
of ml_dtypes bf16 leaves loads back as 2-byte `|V2` records) loads into a
bf16 port model bit for bit, and the port writes it back with the same
values; an f32 mapper beside a bf16 LM keeps each dtype; a submodule whose
leaves mix dtypes runs in f32; load_captioner_bundle takes JAX's
`prefix_only` keyword. A bf16 bundle captions f32 pixels. A half-precision
CLIP state dict still gives f32 towers, as the JAX converters' default
dtype does."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu.train import checkpoints as JCK
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import loading
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode
from clipcap_tpu_torch.train import checkpoints as TCK

VIT = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
MAPPER = dict(dim_clip=16, dim_embedding=32, prefix_length=3, clip_length=3, num_layers=1,
              num_heads=2)


@pytest.fixture(autouse=True)
def _tiny_clip_variant(monkeypatch):
    """The loader builds the ViT the checkpoint names (ViT-B/32); a tiny one
    of the same style stands in for it on the CPU."""
    monkeypatch.setattr(TC.ViTConfig, "clip_variant",
                        classmethod(lambda cls, name: cls(style="clip", **VIT)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Configs, a GPT-2 vocabulary, and the f32 JAX-layout params of a
    captioner seeded in the port."""
    d = tmp_path_factory.mktemp("dtypes")
    base = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(base + ["<|endoftext|>"])}
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (d / "vocab" / "merges.txt").write_text("#version: 0.2\n")
    lm = JC.GPT2Config(vocab_size=len(vocab), n_positions=64, n_embd=32, n_layer=2, n_head=2)
    cap = JC.CaptionerConfig(lm_type="gpt2", visual_encoder_type="CLIP",
                             visual_encoder_variant="ViT-B/32", mapper=JC.MapperConfig(**MAPPER))
    model = Captioner(TC.CaptionerConfig.from_dict(dataclasses.asdict(cap)),
                      TC.GPT2Config(**dataclasses.asdict(lm)),
                      vit_cfg=TC.ViTConfig(style="clip", **VIT), device="cpu")
    return d, cap, lm, convert.captioner_params(model)


def _jax_checkpoint(path, cap, lm, params, dtypes):
    """The JAX package's save_checkpoint + consolidate of `params`, each
    submodule cast to dtypes[name] (a JAX dtype) first."""
    tree = {name: jax.tree_util.tree_map(lambda a, dt=dtypes[name]: jnp.asarray(a, dt), sub)
            for name, sub in params.items()}
    JCK.save_checkpoint(str(path), {"params": tree}, cap_cfg=cap, lm_cfg=lm)
    JCK.consolidate(str(path), str(path / "consolidated.npz"))
    return path


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def test_fault_bf16_consolidated_checkpoint_loads_bit_for_bit(world, tmp_path):
    d, cap, lm, params = world
    bf16 = {name: jnp.bfloat16 for name in params}
    ckpt = _jax_checkpoint(tmp_path / "jax_bf16", cap, lm, params, bf16)
    with np.load(ckpt / "consolidated.npz") as z:
        written = {k: z[k] for k in z.files}
    assert {a.dtype.str for a in written.values()} == {"|V2"}  # what consolidate leaves

    model, cap_t, lm_t, vit_t = loading.load_captioner(str(ckpt), device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    # the loaded model, written back in the JAX layout, holds the same bits
    again: dict = {}
    TCK._flatten("", {"params": convert.captioner_params(model)}, again)
    assert sorted(again) == sorted(written)
    for k, v in written.items():
        assert again[k].dtype == convert.BF16_RECORD and again[k].shape == v.shape, k
        np.testing.assert_array_equal(_bits(again[k]), _bits(v), err_msg=k)
    # and equal to JAX's own bf16 rounding of the f32 params
    jax_bits = np.asarray(jnp.asarray(params["lm"]["wte"], jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(model.lm.wte.detach().view(torch.int16).numpy(), jax_bits)


def test_port_bf16_checkpoint_round_trips(world, tmp_path):
    d, cap, lm, params = world
    ckpt = _jax_checkpoint(tmp_path / "jax_bf16", cap, lm, params,
                           {name: jnp.bfloat16 for name in params})
    model, cap_t, lm_t, _ = loading.load_captioner(str(ckpt), device="cpu")
    TCK.save_checkpoint(str(tmp_path / "port"), model, cap_t, lm_t)
    with np.load(tmp_path / "port" / "consolidated.npz") as a, \
            np.load(ckpt / "consolidated.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == convert.BF16_RECORD, k
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    back, *_ = loading.load_captioner(str(tmp_path / "port"), device="cpu")
    for (ka, va), (kb, vb) in zip(model.state_dict().items(), back.state_dict().items()):
        assert ka == kb and va.dtype == vb.dtype == torch.bfloat16
        assert torch.equal(va.view(torch.int16), vb.view(torch.int16)), ka


def test_mixed_checkpoint_keeps_each_submodule_dtype(world, tmp_path):
    d, cap, lm, params = world
    ckpt = _jax_checkpoint(tmp_path / "mixed", cap, lm, params,
                           {"mapper": jnp.float32, "lm": jnp.bfloat16, "visual": jnp.float32})
    model, *_ = loading.load_captioner(str(ckpt), device="cpu")
    assert {p.dtype for p in model.mapper.parameters()} == {torch.float32}
    assert {p.dtype for p in model.lm.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in model.visual.parameters()} == {torch.float32}
    # the f32 mapper's prefix feeds the bf16 LM
    feats = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32))
    with torch.no_grad():
        logits = model(torch.tensor([[5, 6, 7], [8, 9, 10]]), feats)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits.float()).all())


def test_submodule_with_mixed_leaves_runs_in_f32(world, tmp_path):
    d, cap, lm, params = world
    half = dict(params, lm=dict(params["lm"], wte=np.asarray(
        jnp.asarray(params["lm"]["wte"], jnp.bfloat16))))
    ckpt = _jax_checkpoint(tmp_path / "half", cap, lm, half,
                           {name: None for name in params})
    with np.load(ckpt / "consolidated.npz") as z:
        assert z["params.lm.wte"].dtype == convert.BF16_RECORD
        assert z["params.lm.wpe"].dtype == np.float32
    model, *_ = loading.load_captioner(str(ckpt), device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    # the bf16 leaf widened exactly
    want = torch.from_numpy(np.array(jnp.asarray(half["lm"]["wte"], jnp.float32)))
    assert torch.equal(model.lm.wte.detach(), want)


def test_fault_load_captioner_bundle_takes_prefix_only(world, tmp_path):
    d, cap, lm, params = world
    ckpt = _jax_checkpoint(tmp_path / "f32", cap, lm, params,
                           {name: jnp.float32 for name in params})
    plain = loading.load_captioner_bundle(str(ckpt), str(d / "vocab"), device="cpu")
    bundle = loading.load_captioner_bundle(str(ckpt), str(d / "vocab"), prefix_only=True,
                                           device="cpu")
    for (ka, va), (kb, vb) in zip(plain.model.state_dict().items(),
                                  bundle.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_bf16_bundle_captions_f32_pixels(world, tmp_path):
    d, cap, lm, params = world
    ckpt = _jax_checkpoint(tmp_path / "bf16", cap, lm, params,
                           {name: jnp.bfloat16 for name in params})
    bundle = loading.load_captioner_bundle(str(ckpt), str(d / "vocab"), device="cpu")
    pixels = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, 32, 32))
                              .astype(np.float32))
    prefix = bundle.prefix_from_pixels(pixels)
    assert prefix.dtype == torch.bfloat16 and tuple(prefix.shape) == (2, 3, 32)
    caps = NoBeamCaptionSampler(top_p_values=[0.5], max_decode_length=6,
                                device="cpu").sample_batch(bundle, pixels)
    assert len(caps) == 2 and all(len(c) == 1 for c in caps)
    # the CPU takes the plain versions: no launch is counted, in either dtype
    assert FA.LAUNCHES_BY_DTYPE == {"float32": 0, "bfloat16": 0}


def test_half_precision_clip_state_dict_loads_in_f32(tmp_path):
    """Checkpoints keep their dtypes, torch state dicts do not: the JAX
    converters cast to their default f32, and so do the port's."""
    from test_torch_import_weights import openai_clip_state_dict

    text = dict(vocab_size=64, context_length=77, width=64, layers=1, heads=1, output_dim=16)
    sd = {k: torch.from_numpy(v).half() for k, v in openai_clip_state_dict(VIT, text).items()}
    torch.save(sd, tmp_path / "clip16.pt")
    visual, txt = loading.load_clip_towers("ViT-B/32", str(tmp_path / "clip16.pt"), device="cpu")
    assert {p.dtype for m in (visual, txt) for p in m.parameters()} == {torch.float32}
    want = JW.clip_vit_from_openai_state_dict(sd, JC.ViTConfig(style="clip", **VIT))
    assert want["cls"].dtype == jnp.float32
    np.testing.assert_array_equal(visual.cls.detach().numpy(), np.asarray(want["cls"]))
