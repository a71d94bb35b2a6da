"""The port's ops/quant.py against the JAX package's, on the CPU, and the
int8 ViT against JAX's vit.apply on quantize_params.

quantize_weight and quantize_rows give JAX's q and s bit for bit (the
port's weights are [out, in], JAX's [in, out], so they are compared
transposed); int8_linear's f32 output equals JAX's to rtol 1e-6 (the
int32 product is exact in both; the dequantization keeps JAX's order;
a bias add may differ by an f32 ulp of the product, see below).
The activation side is held against JAX compiled (jax.jit), as every int8
activation of JAX's decode runs: there XLA turns `amax / 127.0` into
`amax * f32(1/127)`, which moves a scale by an ulp in about one row in ten.
Weights are held against quantize_weight run eagerly, as the golden
fixtures' generator runs quantize_params.
torch._int_mm's CUDA shape rules (more than 16 rows, K and N multiples of
8) are met by zero padding, which changes no bit: the padded product
equals an int64 product. The int8 ViT keeps its linears int8 and its
attention f32; its pooled features are held against JAX's at rtol 1e-5
and against the float encoder by JAX's own cosine bound (0.995,
tests/test_quant.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import vit as JV
from clipcap_tpu.ops import quant as JQ
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models import vit as TV
from clipcap_tpu_torch.ops import quant as TQ
from clipcap_tpu_torch.ops.kernels import fused_attention as FA

VIT = dict(image_size=32, patch_size=8, width=32, layers=2, heads=4, mlp_ratio=2.0,
           output_dim=16, style="clip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _weights(shape, seed, dtype=np.float32):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.05
    w[..., 3] = 0.0  # an all-zero input channel
    return w.astype(dtype)


@pytest.mark.parametrize("shape", [(16, 32), (3, 24, 40), (64, 8)])
def test_quantize_weight_matches_jax(shape):
    w = _weights(shape, 0)  # JAX layout [..., in, out]
    w[..., :, 5] = 0.0  # an all-zero output channel: the 1e-12 scale floor
    want = JQ.quantize_weight(jnp.asarray(w))
    got = TQ.quantize_weight(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(got["q"].numpy(), -1, -2), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert float(got["s"][..., 5].min()) == np.float32(1e-12)


def test_quantize_weight_from_bf16_matches_jax():
    w = jnp.asarray(_weights((24, 16), 1), jnp.bfloat16)
    want = JQ.quantize_weight(w)
    got = TQ.quantize_weight(convert.to_torch(np.asarray(w)).t())
    np.testing.assert_array_equal(got["q"].t().numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax(dtype):
    x = np.random.default_rng(2).normal(size=(3, 5, 64)).astype(np.float32) * 3.0
    x[1, 2] = 0.0  # a zero row
    xj = jnp.asarray(x, dtype)
    q_want, s_want = jax.jit(JQ.quantize_rows)(xj)
    q_got, s_got = TQ.quantize_rows(convert.to_torch(np.asarray(xj)))
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))
    assert tuple(s_got.shape) == (3, 5, 1)


@pytest.mark.parametrize("rows", [1, 9, 16, 17, 40])
@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear_matches_jax(rows, bias):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, 48)).astype(np.float32)
    w = _weights((48, 40), 3)
    b = rng.normal(size=(40,)).astype(np.float32) * 0.1 if bias else None
    want = np.asarray(jax.jit(JQ.int8_linear)(jnp.asarray(x), JQ.quantize_weight(jnp.asarray(w)),
                                              None if b is None else jnp.asarray(b)))
    wq = TQ.quantize_weight(torch.from_numpy(w.T.copy()))
    got = TQ.int8_linear(torch.from_numpy(x), wq, None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 40)
    # compiled, XLA fuses the bias add into a multiply-add (one rounding
    # where torch rounds twice): an f32 ulp of the product, which is large
    # relative only where the bias cancels it
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()) if bias else 0)


def test_int8_linear_bf16_activations_and_out_dtype_match_jax():
    """GPT-2's int8 linears: bf16 activations and bias, bf16 out; lm_head:
    f32 out. Both equal JAX's bit for bit after the cast."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(2, 3, 32)), jnp.bfloat16)
    w = _weights((32, 24), 5)
    b = jnp.asarray(rng.normal(size=(24,)) * 0.1, jnp.bfloat16)
    wq_j = JQ.quantize_weight(jnp.asarray(w))
    wq_t = TQ.quantize_weight(torch.from_numpy(w.T.copy()))
    xt, bt = convert.to_torch(np.asarray(x)), convert.to_torch(np.asarray(b))
    want = jax.jit(JQ.int8_linear)(x, wq_j, b)
    got = TQ.int8_linear(xt, wq_t, bt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy(got).view(np.int16),
                                  np.asarray(want).view(np.int16))
    want32 = np.asarray(jax.jit(lambda a, w: JQ.int8_linear(a, w, out_dtype=jnp.float32))(
        x, wq_j))
    np.testing.assert_allclose(TQ.int8_linear(xt, wq_t, out_dtype=torch.float32).numpy(),
                               want32, rtol=1e-6, atol=0)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 33])
def test_int_mm_pads_rows_exactly(m):
    """torch._int_mm on CUDA wants more than 16 rows: the zero-padded
    product is the exact int64 one, whatever the row count."""
    g = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, 64), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (24, 64), generator=g, dtype=torch.int8)
    got = TQ.int_mm(a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, 24)
    assert torch.equal(got.long(), a.long() @ b.long().t())


def test_pad_channels_and_linear_dispatch():
    w = torch.from_numpy(_weights((13, 16), 6))
    padded = TQ.pad_channels(w)
    assert tuple(padded.shape) == (16, 16) and torch.equal(padded[:13], w)
    wq = TQ.quantize_weight(padded)
    assert int(wq["q"][13:].abs().max()) == 0
    assert torch.equal(wq["s"][13:], torch.full((3,), 1e-12))
    x = torch.ones(2, 16)
    np.testing.assert_allclose(TQ.linear(x, w).numpy(), (x @ w.t()).numpy(), rtol=1e-6)
    lin = TQ.Int8Linear.quantize(w, torch.zeros(13))
    assert TQ.is_quantized(lin.weight) and not TQ.is_quantized(w)
    np.testing.assert_array_equal(TQ.linear(x, lin.weight, lin.bias).numpy(), lin(x).numpy())
    np.testing.assert_allclose(lin(x).numpy(), (x @ w.t()).numpy(), atol=2e-3)


@pytest.fixture(scope="module")
def vit_pair():
    cfg_j = JC.ViTConfig(**VIT)
    params = JV.init(jax.random.PRNGKey(0), cfg_j)
    model = convert.load(TV.ViT(TC.ViTConfig(**VIT), device="cpu"),
                         convert.vit_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return params, model


def test_vit_quantize_params_matches_jax_through_the_converter(vit_pair):
    params, model = vit_pair
    want = jax.tree_util.tree_map(np.asarray, JV.quantize_params(params))
    qmodel = TV.quantize_params(model)
    got = {k: convert.to_numpy(v) for k, v in qmodel.state_dict().items()}
    # JAX's quantized tree, converted, is the port's int8 ViT leaf for leaf, and back
    sd = convert.vit_state_dict(want)
    assert sorted(sd) == sorted(got)
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k], err_msg=k)
    back = convert.vit_params(got, VIT["layers"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, want)
    # the float encoder is untouched
    assert all(isinstance(b.qkv, torch.nn.Linear) for b in model.blocks)


def test_int8_vit_matches_jax_apply(vit_pair):
    params, model = vit_pair
    cfg_j = JC.ViTConfig(**VIT)
    qparams = JV.quantize_params(params)
    pixels = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 3, 32, 32)))
    qmodel = TV.quantize_params(model)
    with torch.no_grad():
        for output in ("pooled", "tokens_proj"):
            want = np.asarray(JV.apply(qparams, cfg_j, jnp.asarray(pixels), output=output))
            got = qmodel(torch.from_numpy(pixels), output=output).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        fp = model(torch.from_numpy(pixels), output="pooled").numpy()
        q = qmodel(torch.from_numpy(pixels), output="pooled").numpy()
    cos = (fp * q).sum(-1) / (np.linalg.norm(fp, axis=-1) * np.linalg.norm(q, axis=-1))
    assert cos.min() > 0.995, cos
    assert FA.LAUNCHES == {"fused_attention": 0}
