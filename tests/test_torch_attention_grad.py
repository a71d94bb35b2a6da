"""K1's gradient: `fused_attention` is an autograd Function whose backward
is `fused_attention_backward_plain`, on the CPU as on the card. On the CPU
(where the forward is the plain version) its dq, dk and dv equal autograd
through `fused_attention_plain` at atol 1e-5 in f32 and within one bf16
step (rtol 2^-8, atol 1e-2 of the unit-scale gradients) in bf16, and JAX's
jax.grad of the encoder's attention (ops/attention.dot_product_attention,
what vit._block takes off the TPU) at atol 1e-5 in f32. Gradients reach a
packed qkv projection through its views, and the frozen encoder's forward
under torch.no_grad builds no graph."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.ops.attention import dot_product_attention as jax_attention
from clipcap_tpu_torch.core.config import ViTConfig
from clipcap_tpu_torch.models.vit import ViT
from clipcap_tpu_torch.ops.kernels import fused_attention as FA

TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 2.0 ** -8)}


def _packed(b, t, h, dh, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * dh, generator=gen).to(dtype).requires_grad_()
    q, k, v = (y.reshape(b, t, h, dh) for y in qkv.chunk(3, dim=-1))
    dout = torch.randn(b, t, h, dh, generator=gen).to(dtype)
    return qkv, (q, k, v), dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,dh", [(2, 50, 2, 64), (1, 17, 3, 128)])
def test_function_backward_equals_autograd_through_plain(b, t, h, dh, dtype):
    qkv, qkv_views, dout = _packed(b, t, h, dh, dtype, seed=t + dh)
    out = FA.fused_attention(*qkv_views)
    assert out.grad_fn is not None and "FusedAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, qkv_views, dout)
    want = torch.autograd.grad(FA.fused_attention_plain(*qkv_views), qkv_views, dout)
    twin = FA.fused_attention_backward_plain(*(x.detach() for x in qkv_views), dout)
    atol, rtol = TOL[dtype]
    for g, w, p in zip(got, want, twin):
        assert g.dtype == dtype and torch.equal(g, p)
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)
    # the views stay views: the gradient lands in the packed projection
    (gq,) = torch.autograd.grad(FA.fused_attention(*qkv_views), qkv, dout)
    torch.testing.assert_close(gq, torch.cat([g.reshape(b, t, h * dh) for g in got], dim=-1))


def test_function_backward_equals_jax_grad():
    qkv, (q, k, v), dout = _packed(2, 50, 2, 64, torch.float32, seed=5)
    got = torch.autograd.grad(FA.fused_attention(q, k, v), (q, k, v), dout)
    arrays = [jnp.asarray(x.detach().numpy()) for x in (q, k, v)]
    _, vjp = jax.vjp(jax_attention, *arrays)
    for g, w in zip(got, vjp(jnp.asarray(dout.numpy()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_frozen_encoder_forward_builds_no_graph():
    vit = ViT(ViTConfig(image_size=32, patch_size=16, width=128, layers=1, heads=2,
                        output_dim=16), device="cpu", seed=0)
    pixels = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        assert vit(pixels, remat=True).grad_fn is None
    assert vit(pixels, remat=True).grad_fn is not None
