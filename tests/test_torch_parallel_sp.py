"""Sequence parallelism (parallel/sp.py) over a model axis of 1, 2 and 4
gloo processes, and data x model = 2 x 2: ring attention against dense
attention with a key-padding bias (the port's and JAX's) at 2e-6; the
ring-attention ViT against the port's ViT.forward and JAX's vit.apply at
1e-5 relative, for CLIP (pooled, tokens_proj, tokens) and BLIP (tokens)
styles, and its gradients against the one-process ViT's at 1e-5; a batch
that `data` does not divide raises JAX's ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from clipcap_tpu.core import config as JC
from clipcap_tpu.models import vit as JV
from clipcap_tpu.ops.attention import dot_product_attention as jdense
from clipcap_tpu.ops.attention import padding_bias as jpadding_bias
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.vit import ViT
from clipcap_tpu_torch.ops.attention import dot_product_attention, padding_bias
from clipcap_tpu_torch.tools.dryrun_multichip import run_spawned

LAYOUTS = ["1x1", "1x2", "1x4", "2x2"]
OUTPUTS = [("clip", "pooled"), ("clip", "tokens_proj"), ("clip", "tokens"), ("blip", "tokens")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The parent's one-process runs on one thread, beside the suite's
    other workers and the spawned ranks (each on one thread too)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    got = {}
    for world in (1, 2, 4):
        run_spawned(W.sp_worker, world, (str(out),), timeout=60, workdir=out)
        got[world] = [W.load(out, "sp", world, r) for r in range(world)]
    return got


def _rank_results(runs, layout):
    data, model = (int(x) for x in layout.split("x"))
    return runs[data * model]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ring_attention_matches_dense(runs, world):
    q, k, v, t = W.ring_inputs()
    mask = (torch.arange(q.shape[1]) < t)[None].expand(q.shape[0], -1)
    want = dot_product_attention(q, k, v, bias=padding_bias(mask))[:, :t].numpy()
    want_jax = np.asarray(jdense(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                 jnp.asarray(v.numpy()),
                                 bias=jpadding_bias(jnp.asarray(mask.numpy()))))[:, :t]
    for rank_res in runs[world]:
        got = rank_res["ring"][:, :t].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(got, want_jax, rtol=2e-6, atol=2e-6)


def _vit(style):
    cfg = W.CLIP_VIT if style == "clip" else W.BLIP_VIT
    return ViT(TC.ViTConfig(**cfg), device="cpu", seed=3), cfg


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("style,output", OUTPUTS)
def test_sp_vit_matches_one_process_and_jax(runs, layout, style, output):
    vit, cfg = _vit(style)
    pixels = W.sp_pixels(cfg)
    with torch.no_grad():
        want = vit(pixels, output=output).numpy()
    sd = {k: convert.to_numpy(t) for k, t in vit.state_dict().items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.vit_params(sd, cfg["layers"]))
    want_jax = np.asarray(JV.apply(jparams, JC.ViTConfig(**cfg), jnp.asarray(pixels.numpy()),
                                   output=output))
    for rank_res in _rank_results(runs, layout):
        got = rank_res[f"{layout}_{style}_{output}"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("style", ["clip", "blip"])
def test_sp_vit_gradients_match_one_process(runs, layout, style):
    vit, cfg = _vit(style)
    loss = vit(W.sp_pixels(cfg)).square().mean()
    names = [n for n, _ in vit.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(loss, list(vit.parameters()))))
    for rank_res in _rank_results(runs, layout):
        got = rank_res[f"{layout}_{style}_grads"]
        for name in names:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_sp_vit_rejects_a_batch_data_does_not_divide(runs):
    assert all(r["bad_batch"] == "batch 3 not divisible by data=2" for r in runs[4])
