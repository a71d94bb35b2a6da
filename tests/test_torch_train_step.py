"""The port's train step against the JAX package's make_train_step, from
one set of weights seeded in the port and handed to JAX in its layout
(convert.captioner_params). Tolerances:

- one f32 step: the loss at rtol 1e-5; the gradients and the updated
  parameters at atol 1e-5;
- three f32 steps through a warmup of 2: the step-0 rate is 0 (the
  parameters do not move), then losses at rtol 1e-5 and parameters at
  atol 1e-5;
- AdamW against optax.adamw in multi_transform, on the same gradients,
  over 3 steps: rtol 1e-6 (atol 1e-9 for parameters that start at 0);
- gradient accumulation over 2 micro-batches equals the full batch
  (loss rtol 1e-5, parameters atol 1e-6) and JAX's accumulation;
- prefix_only: the LM bit for bit unchanged, no Adam moments for it;
- the bf16 policy: every stored dtype equal to JAX's, and the loss within
  2 x 8 bf16 steps (2^-8) of the f32 logits' scale of JAX's bf16 loss
  (|d CE| <= 2 max|d logit|, a bf16 forward of the mapper and GPT-2 within
  8 steps, twice PR 7's bound for GPT-2 alone);
- the encoder under the bf16 policy computes in f32 on bf16-rounded
  weights, as JAX promotes f32 pixels against bf16 weights: its features
  equal JAX's at atol 1e-5, and differ from an encoder run on bf16 pixels;
- remat on and off: equal gradients, bit for bit;
- AutoClip: its clip value equals np.percentile of the ring at rtol 1e-5,
  its ring, count and position equal JAX's (rtol 1e-6), non-finite norms
  are skipped; fixed_clip equals JAX's at rtol 1e-6;
- a trainable visual encoder on pixels (K1's Function on the CPU): one
  step's loss at rtol 1e-5 and the encoder's gradients and updates at atol
  1e-5; a frozen one does not move.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.models import vit as JVIT
from clipcap_tpu.train import autoclip as JA
from clipcap_tpu.train import optim as JO
from clipcap_tpu.train import train_step as JTS
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.train import autoclip as TA
from clipcap_tpu_torch.train import optim as TO
from clipcap_tpu_torch.train import train_step as TTS

LM = dict(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4)
MAPPER = dict(dim_clip=16, dim_embedding=32, prefix_length=4, clip_length=2, num_layers=1,
              num_heads=2)
VIT = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
BF16_STEP = 2.0 ** -8
BF16_LOGIT_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**cap):
    cap_t = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAPPER), **cap)
    cap_j = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**MAPPER), **cap)
    return cap_t, cap_j, TC.GPT2Config(**LM), JC.GPT2Config(**LM)


def _train_cfgs(**kw):
    base = dict(optimizer_lr=1e-3, scheduler_warmup_steps=0, total_steps=20,
                gradient_clip_val=-1.0, autoclip_history=16, remat=False, bf16_compute=False,
                weight_decay=0.01)
    base.update(kw)
    return TC.TrainConfig(**base), JC.TrainConfig(**base)


def _batch(seed=0, b=8, t=8, pixels=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 64, size=(b, t)).astype(np.int64)
    tokens[:, -2:] = -1
    out = {"tokens": tokens}
    if pixels:
        out["pixels"] = rng.normal(size=(b, 3, VIT["image_size"], VIT["image_size"])
                                   ).astype(np.float32)
    else:
        out["prefix"] = rng.normal(size=(b, MAPPER["dim_clip"])).astype(np.float32)
    return out


def _jax_array(a):
    """A host leaf as a JAX array, copied (the port updates its parameters
    in place; JAX must not see them change); bf16 records as bf16."""
    a = np.array(a)
    return jnp.asarray(a.view(jnp.bfloat16) if a.dtype.kind == "V" else a)


def _jax_params(model):
    """The port model's parameters in JAX's layout."""
    return jax.tree_util.tree_map(_jax_array, convert.captioner_params(model))


def _f32(leaf):
    leaf = np.asarray(leaf)
    if convert.is_bf16_record(leaf) and leaf.dtype.kind == "V":
        return convert.to_torch(leaf).float().numpy()
    return leaf.astype(np.float32)


def _leaves(tree):
    return [_f32(x) for x in jax.tree_util.tree_leaves(tree)]


def _setup(cap=None, train=None, pixels=False, seed=0, with_jax=True):
    cap_t, cap_j, lm_t, lm_j = _cfgs(**(cap or {}))
    tc_t, tc_j = _train_cfgs(**(train or {}))
    vit_t = TC.ViTConfig(style="clip", **VIT) if pixels else None
    vit_j = JC.ViTConfig(style="clip", **VIT) if pixels else None
    model = Captioner(cap_t, lm_t, vit_cfg=vit_t, device="cpu", seed=seed)
    jparams = _jax_params(model)
    state, tx = TTS.create_train_state(seed, cap_t, lm_t, tc_t, model=model, device="cpu")
    step = TTS.make_train_step(cap_t, lm_t, tc_t, tx, visual_cfg=vit_t)
    jstate, jtx = JTS.create_train_state(jax.random.PRNGKey(0), cap_j, lm_j, tc_j,
                                         params=jparams)
    jstep = (JTS.make_train_step(cap_j, lm_j, tc_j, jtx, donate=False, visual_cfg=vit_j)
             if with_jax else lambda st, b: (st, {}))
    return dict(state=state, step=step, jstate=jstate, jstep=jstep, tx=tx, cap_j=cap_j,
                lm_j=lm_j, jparams=jparams, vit_j=vit_j)


def _run(s, batch, n=1):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n):
        s["state"], m = s["step"](s["state"], tb)
        s["jstate"], jm = s["jstep"](s["jstate"], jb)
        out.append(({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in jm.items()}))
    return out


def _assert_params(s, atol):
    ours = _leaves(convert.captioner_params(s["state"].model))
    ref = _leaves(jax.device_get(s["jstate"].params))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _port_grads(model, batch):
    """d caption_loss / d parameters of the port in f32, in JAX's layout."""
    loss, _ = model.caption_loss(torch.from_numpy(batch["tokens"]),
                                 torch.from_numpy(batch["prefix"]))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for (n, p), g in zip(holder.named_parameters(), grads):
            p.copy_(g)
    return float(loss.detach()), convert.captioner_params(holder)


def test_one_f32_step_matches_jax():
    s = _setup()
    batch = _batch(0)
    loss, grads = _port_grads(s["state"].model, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JCAP.caption_loss(
        p, s["cap_j"], s["lm_j"], jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["prefix"]))[0]))(s["jparams"])
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for a, b in zip(_leaves(grads), _leaves(jgrads)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    (m, jm), = _run(s, batch)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm_pre_clip"], jm["grad_norm_pre_clip"], rtol=1e-5)
    assert sorted(m) == sorted(jm)
    _assert_params(s, atol=1e-5)


def test_three_steps_through_warmup_match_jax():
    s = _setup(train=dict(scheduler_warmup_steps=2))
    batch = _batch(1)
    before = _leaves(convert.captioner_params(s["state"].model))
    out = _run(s, batch)
    # the schedule is read at the count before the increment: step 0 has lr 0
    for a, b in zip(before, _leaves(convert.captioner_params(s["state"].model))):
        np.testing.assert_array_equal(a, b)
    out += _run(s, batch, n=2)
    assert int(s["state"].step) == int(s["jstate"].step) == 3
    np.testing.assert_allclose([m["loss"] for m, _ in out], [jm["loss"] for _, jm in out],
                               rtol=1e-5)
    _assert_params(s, atol=1e-5)
    sched = TO.linear_warmup_schedule(2e-5, 10, 110)
    jsched = JO.linear_warmup_schedule(2e-5, 10, 110)
    for step in (0, 5, 10, 60, 110, 200):
        np.testing.assert_allclose(float(sched(torch.tensor(step))), float(jsched(step)),
                                   rtol=1e-6)


def test_adamw_matches_optax_over_three_steps():
    """optax.adamw in multi_transform with a frozen leaf: eps outside the
    root, decoupled decay on every trainable leaf (the bias too), the
    schedule at the count before the increment, frozen leaves untouched."""
    rng = np.random.default_rng(2)
    tree = {"a": {"w": rng.normal(size=(4, 3)), "b": np.zeros(3)},
            "frozen": {"w": rng.normal(size=(3,))}}
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    mask = {"a": {"w": True, "b": True}, "frozen": {"w": False}}
    jtx = JO.make_optimizer(1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
                            trainable_mask=mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = jtx.init(jparams)
    names = ["a.w", "a.b", "frozen.w"]
    tx = TO.make_optimizer(1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
                           trainable_mask={"a.w": True, "a.b": True, "frozen.w": False})
    assert tx.names == ["a.w", "a.b"]
    params = {n: torch.from_numpy(np.array(tree[n.split(".")[0]][n.split(".")[1]]))
              for n in names}
    opt = tx.init([params[n] for n in tx.names])
    for i in range(3):
        g = {"a": {"w": rng.normal(size=(4, 3)), "b": rng.normal(size=3)},
             "frozen": {"w": rng.normal(size=3)}}
        g = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), g)
        upd, jopt = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt = tx.update([torch.from_numpy(g["a"]["w"]), torch.from_numpy(g["a"]["b"])], opt,
                        [params["a.w"], params["a.b"]])
        for n in names:
            top, leaf = n.split(".")
            np.testing.assert_allclose(params[n].numpy(), np.asarray(jparams[top][leaf]),
                                       rtol=1e-6, atol=1e-9)
    assert int(opt.count) == 3 and len(opt.mu) == len(opt.nu) == 2
    np.testing.assert_array_equal(params["frozen.w"].numpy(), tree["frozen"]["w"])


def test_accumulation_equals_full_batch_and_jax():
    batch = _batch(3)
    micro = {k: np.stack([v[:4], v[4:]]) for k, v in batch.items()}
    full = _setup(train=dict(gradient_clip_val=10.0), with_jax=False)
    acc = _setup(train=dict(gradient_clip_val=10.0, accumulate_grad_batches=2))
    (mf, _), = _run(full, batch)
    (ma, jma), = _run(acc, micro)
    # equal valid counts per row (the padding is the same in every row)
    np.testing.assert_allclose(ma["loss"], mf["loss"], rtol=1e-5)
    np.testing.assert_allclose(ma["loss"], jma["loss"], rtol=1e-5)
    for a, b in zip(_leaves(convert.captioner_params(acc["state"].model)),
                    _leaves(convert.captioner_params(full["state"].model))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    _assert_params(acc, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_prefix_only_freezes_lm_bit_for_bit(bf16):
    s = _setup(cap=dict(prefix_only=True), train=dict(bf16_compute=bf16), with_jax=bf16)
    model = s["state"].model
    lm_before = {n: p.detach().clone() for n, p in model.lm.named_parameters()}
    map_before = {n: p.detach().clone() for n, p in model.mapper.named_parameters()}
    _run(s, _batch(4), n=3)
    for n, p in model.lm.named_parameters():
        assert p.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert torch.equal(p, lm_before[n]), n
    assert any(not torch.equal(p, map_before[n]) for n, p in model.mapper.named_parameters())
    # frozen leaves hold no moments: the optimizer covers the mapper alone
    assert s["tx"].names == [f"mapper.{n}" for n, _ in model.mapper.named_parameters()]
    assert len(s["state"].opt_state.mu) == len(s["tx"].names)
    if bf16:  # JAX stores the frozen LM in bf16 too, and leaves it as it was
        assert (_dtypes(convert.captioner_params(model))
                == _dtypes(jax.device_get(s["jstate"].params)))
        for a, b in zip(_leaves(jax.device_get(s["jstate"].params["lm"])),
                        _leaves(convert.captioner_params(model)["lm"])):
            np.testing.assert_array_equal(a, b)


def _dtypes(tree):
    return [("bfloat16" if convert.is_bf16_record(x) else str(np.asarray(x).dtype))
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("cap,pixels,step", [
    ({}, False, True), ({"prefix_only": True}, False, False),
    ({"visual_encoder_type": "CLIP"}, True, False),
    ({"visual_encoder_type": "CLIP", "train_visual_encoder": True}, True, True)])
def test_bf16_policy_dtypes_and_loss(cap, pixels, step):
    """Stored dtypes equal JAX's for every partition; one bf16 step's loss
    within the bound of JAX's where `step`."""
    s = _setup(cap=cap, train=dict(bf16_compute=True), pixels=pixels, with_jax=step)
    assert (_dtypes(convert.captioner_params(s["state"].model))
            == _dtypes(jax.device_get(s["jstate"].params)))
    if not step:
        return
    batch = _batch(5, pixels=pixels)
    model = s["state"].model
    with torch.no_grad():
        f32 = copy.deepcopy(model).float()
        prefix = (f32.visual(torch.from_numpy(batch["pixels"])) if pixels
                  else torch.from_numpy(batch["prefix"]))
        scale = float(f32(torch.from_numpy(np.maximum(batch["tokens"], 0)), prefix)
                      .abs().max())
    (m, jm), = _run(s, batch)
    bound = 2 * BF16_LOGIT_STEPS * BF16_STEP * scale
    assert abs(m["loss"] - jm["loss"]) <= bound, (m["loss"], jm["loss"], bound)
    assert (_dtypes(convert.captioner_params(s["state"].model))
            == _dtypes(jax.device_get(s["jstate"].params)))


def test_bf16_encoder_computes_in_f32_as_jax_promotes():
    """JAX's step: f32 pixels against bf16 encoder weights promote to f32,
    so the encoder computes in f32 on the bf16-rounded weights."""
    cap_t, cap_j, lm_t, _ = _cfgs(visual_encoder_type="CLIP")
    vit_t, vit_j = TC.ViTConfig(style="clip", **VIT), JC.ViTConfig(style="clip", **VIT)
    tc_t, _ = _train_cfgs(bf16_compute=True)
    model = Captioner(cap_t, lm_t, vit_cfg=vit_t, device="cpu", seed=7)
    state, _ = TTS.create_train_state(7, cap_t, lm_t, tc_t, model=model, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.visual.parameters())
    pixels = _batch(6, pixels=True)["pixels"]
    fwd = TTS.forward_params(model, model.trainable_filter(), True)
    feats = TTS.encode_pixels(model, fwd, torch.from_numpy(pixels), cap_t, vit_t, remat=True)
    assert feats.dtype == torch.float32 and feats.grad_fn is None
    jvis = _jax_params(model)["visual"]
    want = JVIT.apply(jvis, vit_j, jnp.asarray(pixels), output="pooled")
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # the inference bundle's rule (pixels cast to the encoder's dtype) is another function
    with torch.no_grad():
        bf16_pixels = model.visual(torch.from_numpy(pixels).to(torch.bfloat16)).float()
    assert float((bf16_pixels - feats).abs().max()) > 1e-4


def test_remat_gives_equal_grads():
    """Checkpointed GPT-2 and ViT blocks (the ViT trainable, K1's Function
    inside) give the gradients of the plain forward, bit for bit, in f32
    and under the bf16 casts of functional_call; so do the mapper's
    checkpointed layers (which JAX's loss does not remat)."""
    cap_t, _, lm_t, _ = _cfgs(visual_encoder_type="CLIP", train_visual_encoder=True)
    vit_t = TC.ViTConfig(style="clip", **VIT)
    model = Captioner(cap_t, lm_t, vit_cfg=vit_t, device="cpu", seed=3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(7, pixels=True).items()}
    names = [n for n, _ in model.named_parameters()]
    for bf16 in (False, True):
        grads = []
        for remat in (False, True):
            tc, _ = _train_cfgs(bf16_compute=bf16, remat=remat)
            loss, g, _ = TTS.compute_grads(model, batch, names, cap_t, tc, vit_t)
            grads.append(g)
        for a, b in zip(*grads):
            assert torch.equal(a, b)
    prefix = torch.from_numpy(_batch(7)["prefix"])
    params = list(model.mapper.parameters())
    g = [torch.autograd.grad(model.mapper(prefix, remat=r).square().sum(), params)
         for r in (False, True)]
    for a, b in zip(*g):
        assert torch.equal(a, b)


def test_autoclip_matches_numpy_and_jax():
    state, jstate = TA.autoclip_init(16, device="cpu"), JA.autoclip_init(16)
    rng = np.random.default_rng(8)
    history = []
    for i in range(20):  # past the ring's size: the oldest norms drop out
        g = (rng.normal(size=(5, 5)) * (i + 1)).astype(np.float32)
        clipped, state, m = TA.autoclip_update(state, [torch.from_numpy(g)], 10.0)
        jclipped, jstate, jm = JA.autoclip_update(jstate, {"w": jnp.asarray(g)}, 10.0)
        history.append(float(m["grad_norm_pre_clip"]))
        np.testing.assert_allclose(float(m["autoclip_value"]),
                                   np.percentile(history[-16:], 10.0), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm_post_clip"]),
                                   min(history[-1], float(m["autoclip_value"])), rtol=1e-5)
        np.testing.assert_allclose(clipped[0].numpy(), np.asarray(jclipped["w"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(state.history.numpy(), np.asarray(jstate.history),
                                   rtol=1e-6)
        assert (int(state.count), int(state.pos)) == (int(jstate.count), int(jstate.pos))
    # a non-finite norm is not recorded, and the step after clips as before
    count, pos = int(state.count), int(state.pos)
    _, state, _ = TA.autoclip_update(state, [torch.tensor([[1.0, float("inf")]])], 10.0)
    assert (int(state.count), int(state.pos)) == (count, pos)
    fresh = TA.autoclip_init(8, device="cpu")
    _, fresh, _ = TA.autoclip_update(fresh, [torch.tensor([1.0, float("nan")])], 10.0)
    assert int(fresh.count) == 0
    _, fresh, m = TA.autoclip_update(fresh, [torch.tensor([3.0, 4.0])], 10.0)
    assert int(fresh.count) == 1 and float(m["autoclip_value"]) == pytest.approx(5.0)


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_fixed_clip_matches_jax(clip):
    rng = np.random.default_rng(9)
    g = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    ours, norm = TA.fixed_clip([torch.from_numpy(x) for x in g], clip)
    ref, jnorm = JA.fixed_clip({"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}, clip)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref["a"]), rtol=1e-6)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref["b"]), rtol=1e-6)


@pytest.mark.parametrize("train_visual", [True, False])
def test_visual_encoder_on_pixels_matches_jax(train_visual):
    s = _setup(cap=dict(visual_encoder_type="CLIP", train_visual_encoder=train_visual),
               train=dict(remat=True), pixels=True)
    before = {n: p.detach().clone() for n, p in s["state"].model.visual.named_parameters()}
    (m, jm), = _run(s, _batch(10, pixels=True))
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm_pre_clip"], jm["grad_norm_pre_clip"], rtol=1e-5)
    _assert_params(s, atol=1e-5)
    moved = [not torch.equal(p, before[n])
             for n, p in s["state"].model.visual.named_parameters()]
    assert any(moved) if train_visual else not any(moved)
