"""Prefix-only training over a frozen int8 GPT-J (BASELINE config #4's
single-card recipe): the twin of
tests/test_gptj_int8.py::test_prefix_only_train_step_over_int8_frozen_lm.

JAX's int8 tree and mapper init are carried into a port Captioner that
holds a GPTJInt8 as its LM; the port's make_train_step drives the LM's
W8A16 forward through `lm_apply=model.lm.apply_q8`, as JAX's test drives
`gptj.apply_q8`. Checks: the int8 LM's buffers and parameters never reach
autograd or the optimizer and are bit-identical after two steps (with
bf16_compute the frozen float leaves are stored in bf16 first, the scales
and biases too, exactly as JAX's create_train_state stores them); the
mapper moves; the two losses and the mapper after two steps match JAX's.

Tolerances: bf16 compute runs the forward in bf16, where the two packages
round at different points, so the losses agree to rtol 1e-3 (measured
1.1e-4). The learning rate is 0 at step 0 (warm-up), so the mapper moves
once, by AdamW's first update: about lr times the sign of each gradient.
Where a gradient is near 0 its sign can differ between the packages, and
the two mappers then sit up to 2 x lr apart: so 98 % of each tensor's
elements must agree to 1e-5 (measured at least 98.4 %) and every one to
2 x lr plus an f32 margin (measured 1.9998e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import gptj as JG
from clipcap_tpu.models import mapper as JM
from clipcap_tpu.train import create_train_state as j_create_train_state
from clipcap_tpu.train import make_train_step as j_make_train_step
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.models.gptj import GPTJInt8
from clipcap_tpu_torch.train.train_step import create_train_state, make_train_step

LM = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=3, n_head=4, rotary_dim=8)
MAP = dict(dim_clip=16, dim_embedding=64, prefix_length=4, clip_length=3, num_layers=1,
           num_heads=2)
TRAIN = dict(optimizer_lr=1e-3, scheduler_warmup_steps=1, total_steps=10, gradient_clip_val=-1.0,
             bf16_compute=True, remat=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = convert.to_numpy(t)
    return a.view(np.int16) if a.dtype.kind == "V" else a


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind not in "iu" else a


def test_prefix_only_train_step_over_int8_frozen_lm():
    jcfg = JC.GPTJConfig(**LM)
    q = JG.quantize_params(JG.init(jax.random.PRNGKey(0), jcfg))
    jparams = {"mapper": JM.init(jax.random.PRNGKey(2), JC.MapperConfig(**MAP)), "lm": q}
    jcap = JC.CaptionerConfig(lm_type="gpt-j", mapper=JC.MapperConfig(**MAP), prefix_only=True)
    jtc = JC.TrainConfig(**TRAIN)
    state, tx = j_create_train_state(jax.random.PRNGKey(0), jcap, jcfg, jtc, params=jparams)

    def lm_apply(pl, e, attention_mask=None, logits_slice=None):
        return JG.apply_q8(pl, jcfg, e, attention_mask=attention_mask, remat=True,
                           logits_slice=logits_slice)

    jstep = j_make_train_step(jcap, jcfg, jtc, tx, donate=False, lm_apply=lm_apply)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, LM["vocab_size"], size=(2, 6)).astype(np.int64)
    toks[:, -2:] = -1
    prefix = rng.normal(size=(2, 16)).astype(np.float32)
    j1, jm1 = jstep(state, {"tokens": jnp.asarray(toks), "prefix": jnp.asarray(prefix)})
    j2, jm2 = jstep(j1, {"tokens": jnp.asarray(toks), "prefix": jnp.asarray(prefix)})

    tcfg = TC.GPTJConfig(**LM)
    lm8 = convert.load(GPTJInt8(tcfg, device="cpu", dtype=torch.float32),
                       convert.gptj_state_dict(jax.tree_util.tree_map(np.asarray, q)))
    cap = TC.CaptionerConfig(lm_type="gpt-j", mapper=TC.MapperConfig(**MAP), prefix_only=True)
    model = Captioner(cap, tcfg, lm=lm8, device="cpu")
    assert model.lm is lm8
    convert.load(model.mapper, convert.mapper_state_dict(
        jax.tree_util.tree_map(np.array, jparams["mapper"])))
    tc = TC.TrainConfig(**TRAIN)
    tstate, ttx = create_train_state(0, cap, tcfg, tc, model=model, device="cpu")
    assert all(n.startswith("mapper.") for n in ttx.names)
    # the frozen int8 LM as JAX's create_train_state stores it: floats in bf16
    want_lm = convert.gptj_state_dict(jax.tree_util.tree_map(np.asarray, state.params["lm"]))
    before = {k: _bits(v).copy() for k, v in model.lm.state_dict().items()}
    assert sorted(before) == sorted(want_lm)
    for k in want_lm:
        np.testing.assert_array_equal(before[k], _jbits(want_lm[k]), err_msg=k)
    assert model.lm.blocks[0].wq.s.dtype == torch.bfloat16 and model.lm.wte.dtype == torch.bfloat16
    mapper0 = {k: v.detach().clone() for k, v in model.mapper.state_dict().items()}

    step = make_train_step(cap, tcfg, tc, ttx, lm_apply=model.lm.apply_q8)
    batch = {"tokens": torch.from_numpy(toks), "prefix": torch.from_numpy(prefix)}
    tstate, m1 = step(tstate, batch)
    tstate, m2 = step(tstate, batch)

    for k, v in model.lm.state_dict().items():
        np.testing.assert_array_equal(_bits(v), before[k], err_msg=k)
    assert all(p.grad is None for p in model.lm.parameters())
    moved = sum(float((v.float() - mapper0[k].float()).abs().sum())
                for k, v in model.mapper.state_dict().items())
    assert moved > 0.0
    for got, want in ((m1, jm1), (m2, jm2)):
        assert np.isfinite(float(got["loss"]))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-3)
    want_mapper = convert.mapper_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                   j2.params["mapper"]))
    lr = TRAIN["optimizer_lr"]
    for k, v in model.mapper.state_dict().items():
        diff = np.abs(v.float().numpy() - np.asarray(want_mapper[k], np.float32))
        assert (diff < 1e-5).mean() >= 0.98 and diff.max() <= 2 * lr + 1e-5, (k, diff.max())
