"""Rank bodies of the multi-process tests (tests/test_torch_parallel_*.py).

Each runs in a process spawned by clipcap_tpu_torch.tools.dryrun_multichip's
`run_spawned` (gloo, a `file://` rendezvous), imports torch and the port
only, drives every case of one test file at this world size and saves what
it got with torch.save under `out`, one file per rank. The tests compute
the JAX references and the one-process runs in the parent and compare.
Models are drawn from seeds on the CPU, so every rank and the parent hold
the same weights.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.core.mesh import MeshSpec, make_mesh

GPT2_DP = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4)
GPTJ_TP = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=8, rotary_dim=8)
# wide enough that ZeRO shards (2^16 elements) wte, c_attn, c_fc and mlp_proj
GPT2_TRAIN = dict(vocab_size=512, n_positions=64, n_embd=128, n_layer=4, n_head=4)
MAPPER_TRAIN = dict(dim_clip=16, dim_embedding=128, prefix_length=4, clip_length=4,
                    num_layers=1, num_heads=4)
TRAIN = dict(optimizer_lr=1e-3, scheduler_warmup_steps=2, total_steps=100,
             gradient_clip_val=-1.0, autoclip_history=16, remat=False, bf16_compute=False)
GPTJ_INT8 = dict(vocab_size=512, n_positions=64, n_embd=32, n_layer=2, n_head=4, rotary_dim=8)
MAPPER_INT8 = dict(dim_clip=16, dim_embedding=32, prefix_length=4, clip_length=2,
                   num_layers=1, num_heads=2)
CLIP_VIT = dict(image_size=28, patch_size=4, width=32, layers=3, heads=4, output_dim=16,
                style="clip")
BLIP_VIT = dict(image_size=24, patch_size=4, width=32, layers=3, heads=4, output_dim=None,
                style="blip")
MOE_MAPPER = dict(dim_clip=16, dim_embedding=32, prefix_length=6, clip_length=4, num_layers=2,
                  num_heads=4)
DP_ROWS = 8
TRAIN_STEPS = 3


def _save(out, name: str, obj) -> None:
    torch.save(obj, Path(out) / f"{name}_w{dist.get_world_size()}_r{dist.get_rank()}.pt")


def load(out, name: str, world: int, rank: int = 0):
    return torch.load(Path(out) / f"{name}_w{world}_r{rank}.pt", weights_only=False)


# --- data-parallel decode, serving and the samplers' row_base ------------------------------


def dp_inputs():
    rng = np.random.default_rng(1)
    prefix = torch.from_numpy(rng.normal(size=(DP_ROWS, 5, GPT2_DP["n_embd"])).astype(np.float32))
    noise = torch.from_numpy(rng.gumbel(size=(10, DP_ROWS, GPT2_DP["vocab_size"]))
                             .astype(np.float32))
    logits = torch.from_numpy(rng.normal(size=(DP_ROWS, 300)).astype(np.float32) * 3)
    appears = torch.from_numpy(rng.random((DP_ROWS, 300)) < 0.05)
    return prefix, noise, logits, appears


SAMPLED = dict(max_new_tokens=10, top_k=20, top_p=0.8, temperature=0.9, eos_token_id=3,
               min_length=2, repetition_penalty=1.3)


def dp_cases(cache_constraint=None) -> dict:
    """Every data-parallel decode case; with no constraint, the one-process run."""
    from clipcap_tpu_torch.decode.beam import beam_search_batched
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.decode.serving import Request, ServingEngine
    from clipcap_tpu_torch.models.gpt2 import GPT2, quantize_params
    from clipcap_tpu_torch.ops.kernels.fused_sampler import (fused_filter_sample,
                                                              fused_step_sample)
    from clipcap_tpu_torch.parallel.dp import layout_of

    cfg = TC.GPT2Config(**GPT2_DP)
    lm = GPT2(cfg, device="cpu", seed=0)
    prefix, noise, logits, appears = dp_inputs()
    kw = dict(device="cpu", cache_constraint=cache_constraint)
    greedy = GenerationSettings(max_new_tokens=10, greedy=True)
    res = {"greedy": generate(lm, prefix, greedy, **kw),
           "int8": generate(quantize_params(lm), (prefix * 0.1).bfloat16(), greedy, **kw),
           "sampled": generate(lm, prefix, GenerationSettings(**SAMPLED), seed=11, **kw),
           "injected": generate(lm, prefix, GenerationSettings(**SAMPLED), seed=11,
                                gumbel_noise=noise, **kw),
           "beam": beam_search_batched(lm, prefix[:4], beam_size=3, max_new_tokens=6,
                                       stop_token_id=5, **kw)}
    # K2 and K3 (their plain versions on the CPU) on this rank's rows
    dp = layout_of(cache_constraint)
    lo, hi = (0, DP_ROWS) if dp is None else dp.rows(DP_ROWS)
    gather = (lambda x: x) if dp is None else dp.gather
    k2 = fused_filter_sample(logits[lo:hi], 20.0, 0.9, 5, row_base=lo)
    k3 = fused_step_sample(logits[lo:hi], 20.0, 0.9, 5, appears=appears[lo:hi], penalty=1.3,
                           temperature=0.8, eos_token_id=7,
                           suppress_eos=torch.arange(lo, hi) % 2 == 0, want_eos_lp=True,
                           row_base=lo)
    res["k2"] = [gather(x) for x in k2]
    res["k3"] = [gather(x) for x in k3]
    for name, settings in (("serve", dict(max_new_tokens=8, greedy=True, eos_token_id=1)),
                           ("serve_sampled", dict(max_new_tokens=8, top_p=0.9, eos_token_id=1,
                                                  filter_method="fused_step"))):
        eng = ServingEngine(lm, cfg, prefix_len=5, settings=GenerationSettings(**settings),
                            slots=DP_ROWS, steps_per_sync=3, refill_sizes=[1, 2, 4],
                            **kw)
        reqs = [Request(i, i % DP_ROWS, max_length=2 + i % 5) for i in range(20)]
        served = eng.serve(reqs, seed=3, prefix_pool=prefix)
        res[name] = {k: v["tokens"] for k, v in served.items()}
    return res


def dp_worker(out) -> None:
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.parallel.dp import dp_decode_shardings

    mesh = make_mesh(MeshSpec(data=dist.get_world_size()), device_type="cpu")
    res = dp_cases(dp_decode_shardings(mesh).constrain_cache)
    # the bundle's switch composes with int8 and refuses a second layout
    cap_cfg = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(
        dim_clip=16, dim_embedding=GPT2_DP["n_embd"], prefix_length=4, clip_length=4,
        num_layers=1, num_heads=2))
    bundle = CaptionerBundle.create(cap_cfg, TC.GPT2Config(**GPT2_DP), None, device="cpu")
    bundle.enable_int8_decode()
    bundle_mesh = bundle.enable_data_parallel_decode()
    for name, enable in (("second_enable", bundle.enable_data_parallel_decode),
                         ("tp_enable", lambda: bundle.enable_tensor_parallel(2))):
        try:
            enable()
            res[name] = None
        except ValueError as e:
            res[name] = str(e)
    res["bundle_data"] = bundle_mesh.size(0)
    res["bundle_layout"] = bundle._decode_sharding
    _save(out, "dp", res)


# --- tensor-parallel GPT-J ------------------------------------------------------------------


def tp_inputs():
    rng = np.random.default_rng(2)
    return torch.from_numpy(rng.normal(size=(4, 6, GPTJ_TP["n_embd"])).astype(np.float32))


def tp_cases(model, cache_constraint=None) -> dict:
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.decode.serving import Request, ServingEngine

    prefix = tp_inputs()
    kw = dict(device="cpu", cache_constraint=cache_constraint)
    with torch.no_grad():
        res = {"logits": model(prefix),
               "prefill": model.prefill(prefix, model.init_cache(4, 8))[0]}
    res["greedy"] = generate(model, prefix, GenerationSettings(max_new_tokens=10, greedy=True),
                             **kw)["tokens"]
    res["sampled"] = generate(model, prefix, GenerationSettings(**SAMPLED), seed=4, **kw)["tokens"]
    eng = ServingEngine(model, model.cfg, prefix_len=6,
                        settings=GenerationSettings(max_new_tokens=6, greedy=True,
                                                    eos_token_id=1),
                        slots=2, steps_per_sync=2, device="cpu")
    served = eng.serve([Request(i, i % 4, max_length=2 + i % 4) for i in range(6)],
                       prefix_pool=prefix)
    res["serve"] = {k: v["tokens"] for k, v in served.items()}
    return res


def tp_bf16_model():
    """GPTJ_TP in bf16 with seeded biases: the init's are zero, and with a
    zero b_out the place where it is added cannot show."""
    from clipcap_tpu_torch.models.gptj import GPTJ

    model = GPTJ(TC.GPTJConfig(**GPTJ_TP), device="cpu", seed=0)
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") and "ln" not in name:
                p.copy_(torch.from_numpy(rng.normal(0.0, 0.5, p.shape).astype(np.float32)))
    return model.to(torch.bfloat16)


def tp_bf16_cases(model, cache_constraint=None) -> dict:
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate

    prefix = tp_inputs().to(torch.bfloat16)
    with torch.no_grad():
        res = {"logits": model(prefix),
               "prefill": model.prefill(prefix, model.init_cache(4, 8))[0]}
    res["greedy"] = generate(model, prefix, GenerationSettings(max_new_tokens=10, greedy=True),
                             device="cpu", cache_constraint=cache_constraint)["tokens"]
    return res


def tp_worker(out) -> None:
    from clipcap_tpu_torch.models.gptj import GPTJ
    from clipcap_tpu_torch.parallel.tp import apply_gptj_decode_shardings, gptj_decode_shardings

    world = dist.get_world_size()
    if world == 2:  # bf16 at model 2, held against JAX's enable_tensor_parallel(2)
        mesh = make_mesh(MeshSpec(data=1, model=2), device_type="cpu")
        gptj = tp_bf16_model()
        sh = gptj_decode_shardings(mesh, gptj)
        gptj.shard_heads(sh.model_group)
        _save(out, "tp_bf16_1x2", tp_bf16_cases(gptj, sh.constrain_cache))
    layouts = [(1, world)] + ([(2, 2)] if world == 4 else [])
    for data, model_axis in layouts:
        mesh = make_mesh(MeshSpec(data=data, model=model_axis), device_type="cpu")
        gptj = GPTJ(TC.GPTJConfig(**GPTJ_TP), device="cpu", seed=0)
        sh = gptj_decode_shardings(mesh, gptj)
        gptj.shard_heads(sh.model_group)
        res = tp_cases(gptj, sh.constrain_cache)
        res["shards"] = {n: p.detach().clone() for n, p in gptj.named_parameters()}
        # apply_gptj_decode_shardings on a model and a whole cache
        fresh = GPTJ(TC.GPTJConfig(**GPTJ_TP), device="cpu", seed=0)
        fresh, cache, _ = apply_gptj_decode_shardings(fresh, fresh.init_cache(4, 8), mesh)
        lo, hi = sh.rows(4)
        with torch.no_grad():
            res["apply_prefill"] = sh.gather(fresh.prefill(tp_inputs()[lo:hi], cache)[0])
        _save(out, f"tp_{data}x{model_axis}", res)


# --- training: data parallel, ZeRO, pipeline ------------------------------------------------


def train_batches(a: int = 1):
    """TRAIN_STEPS global batches of 8 rows (an [A] axis with accumulation)."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(TRAIN_STEPS):
        tokens = rng.integers(1, GPT2_TRAIN["vocab_size"], size=(a, 8, 10)).astype(np.int64)
        tokens[..., -2:] = -1
        tokens[:, 1, 3:] = -1  # rows of unequal length: the global token count matters
        prefix = rng.normal(size=(a, 8, MAPPER_TRAIN["dim_clip"])).astype(np.float32)
        batch = {"tokens": tokens, "prefix": prefix}
        out.append({k: v[0] for k, v in batch.items()} if a == 1 else batch)
    return out


def train_run(mesh=None, zero=False, pipe_micro=0, accumulate=1, int8_prefix=False,
              ckpt=None) -> dict:
    """TRAIN_STEPS steps of the port's train step: the losses, the final
    parameters and, with `ckpt`, a checkpoint written there."""
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.parallel.pp import make_gpt2_pp_apply
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint
    from clipcap_tpu_torch.train.train_step import create_train_state, make_train_step

    train_cfg = TC.TrainConfig(accumulate_grad_batches=accumulate, **TRAIN)
    lm_apply = None
    if int8_prefix:
        from clipcap_tpu_torch.models.gptj import GPTJ, quantize_params

        lm_cfg = TC.GPTJConfig(**GPTJ_INT8)
        cap_cfg = TC.CaptionerConfig(lm_type="gptj", prefix_only=True,
                                     mapper=TC.MapperConfig(**MAPPER_INT8))
        q8 = quantize_params(GPTJ(lm_cfg, device="cpu", seed=1))
        model = Captioner(cap_cfg, lm_cfg, device="cpu", seed=0, lm=q8)
        lm_apply = q8.apply_q8
    else:
        lm_cfg = TC.GPT2Config(**GPT2_TRAIN)
        cap_cfg = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAPPER_TRAIN))
        model = Captioner(cap_cfg, lm_cfg, device="cpu", seed=0)
    state, tx = create_train_state(0, cap_cfg, lm_cfg, train_cfg, model=model, device="cpu",
                                   mesh=mesh, zero=zero)
    if pipe_micro:
        lm_apply = functools.partial(make_gpt2_pp_apply(lm_cfg, mesh, n_micro=pipe_micro),
                                     model.lm)
    step = make_train_step(cap_cfg, lm_cfg, train_cfg, tx, lm_apply=lm_apply, mesh=mesh)
    losses = []
    for batch in train_batches(accumulate):
        if mesh is not None:
            batch = {k: _rows(mesh, v, 0 if accumulate == 1 else 1) for k, v in batch.items()}
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    if ckpt is not None:
        save_checkpoint(ckpt, state, cap_cfg, lm_cfg, train_cfg)
    res = {"losses": losses,
           "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    if zero:
        res["zero_axes"] = dict(zip(state.shards.names, state.shards.axes))
        res["zero_masters"] = dict(zip(state.shards.names,
                                       [m.clone() for m in state.shards.masters]))
        res["zero_mu"] = dict(zip(state.shards.names, [m.clone() for m in state.opt_state.mu]))
    return res


def traced_fit(mesh) -> dict:
    """trainer.fit over the TRAIN_STEPS global batches under a tracer: the
    final parameters, and (name, enclosing span's name) of each call-stack
    span it recorded."""
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.train.train_step import create_train_state
    from clipcap_tpu_torch.train.trainer import fit
    from clipcap_tpu_torch.utils import profiling as P
    from clipcap_tpu_torch.utils.logging import MetricLogger

    train_cfg = TC.TrainConfig(epochs=1, **TRAIN)
    lm_cfg = TC.GPT2Config(**GPT2_TRAIN)
    cap_cfg = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAPPER_TRAIN))
    model = Captioner(cap_cfg, lm_cfg, device="cpu", seed=0)
    state, tx = create_train_state(0, cap_cfg, lm_cfg, train_cfg, model=model, device="cpu",
                                   mesh=mesh)
    with P.tracing() as tr:
        fit(state, tx, cap_cfg, lm_cfg, train_cfg, train_batches(), TRAIN_STEPS,
            logger=MetricLogger(echo=False), mesh=mesh)
    spans = [(s.name, None if s.parent is None else tr.spans[s.parent].name) for s in tr.spans]
    return {"spans": spans,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def _rows(mesh, v: np.ndarray, axis: int) -> np.ndarray:
    from clipcap_tpu_torch.core.mesh import data_rows

    lo, hi = data_rows(mesh, v.shape[axis])
    return np.take(v, np.arange(lo, hi), axis=axis)


def pp_forward(mesh, n_micro: int) -> dict:
    """The pipelined forward's logits (with a mask, and a logits slice) and
    its gradients, on this rank's rows of one batch."""
    from clipcap_tpu_torch.models.gpt2 import GPT2
    from clipcap_tpu_torch.parallel.pp import make_gpt2_pp_apply

    lm = GPT2(TC.GPT2Config(**GPT2_TRAIN), device="cpu", seed=2)
    embeds, mask = pp_inputs()
    embeds, mask = (torch.from_numpy(_rows(mesh, x, 0)) for x in (embeds, mask))
    embeds.requires_grad_(True)
    apply = make_gpt2_pp_apply(lm.cfg, mesh, n_micro=n_micro)
    logits = apply(lm, embeds, mask)
    wrt = [embeds] + list(lm.parameters())
    grads = torch.autograd.grad(logits.square().mean(), wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)]
    with torch.no_grad():
        sliced = apply(lm, embeds, logits_slice=(3, 9))
    return {"logits": logits.detach(), "sliced": sliced,
            "grads": dict(zip(["embeds"] + [n for n, _ in lm.named_parameters()], grads))}


def pp_inputs():
    rng = np.random.default_rng(6)
    embeds = rng.normal(size=(8, 10, GPT2_TRAIN["n_embd"])).astype(np.float32)
    mask = rng.integers(0, 2, size=(8, 10)).astype(np.int64)
    mask[:, 0] = 1
    return embeds, mask


def zero_resume(mesh, path: str) -> dict:
    """The checkpoint at `path` restored into a ZeRO train state of the
    GPT2_TRAIN captioner: the step and, by name, this rank's master and
    moment shards with their axes."""
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.train.checkpoints import restore_checkpoint
    from clipcap_tpu_torch.train.train_step import create_train_state

    lm_cfg = TC.GPT2Config(**GPT2_TRAIN)
    cap_cfg = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAPPER_TRAIN))
    template, _ = create_train_state(5, cap_cfg, lm_cfg, TC.TrainConfig(**TRAIN),
                                     model=Captioner(cap_cfg, lm_cfg, device="cpu", seed=5),
                                     device="cpu", mesh=mesh, zero=True)
    state = restore_checkpoint(path, template)
    names = state.shards.names
    return {"step": int(state.step), "axes": dict(zip(names, state.shards.axes)),
            "masters": dict(zip(names, [m.clone() for m in state.shards.masters])),
            "mu": dict(zip(names, [m.clone() for m in state.opt_state.mu])),
            "nu": dict(zip(names, [m.clone() for m in state.opt_state.nu]))}


def train_worker(out, jax_state: str) -> None:
    from clipcap_tpu_torch.models.gpt2 import GPT2
    from clipcap_tpu_torch.parallel.pp import make_gpt2_pp_apply, pp_param_shardings

    world = dist.get_world_size()
    data = make_mesh(MeshSpec(data=world), device_type="cpu")
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.parallel.sharding import shard_params

    cap = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**MAPPER_TRAIN))
    model = Captioner(cap, TC.GPT2Config(**GPT2_TRAIN), device="cpu", seed=0)
    res = {"shard_params": {n: t.clone() for n, t in shard_params(model, data, zero=True).items()}}
    res.update({"dp": train_run(data), "fit": traced_fit(data),
           "zero": train_run(data, zero=True, ckpt=str(Path(out) / f"zero_ckpt_w{world}")),
           "zero_acc": train_run(data, zero=True, accumulate=2),
           "int8_prefix": train_run(data, zero=True, int8_prefix=True)})
    res["jax_resume"] = zero_resume(data, jax_state)  # a JAX TrainState into ZeRO shards
    pipe = make_mesh(MeshSpec(pipe=world), device_type="cpu")
    res["pp_shardings"] = pp_param_shardings(GPT2(TC.GPT2Config(**GPT2_TRAIN), device="cpu"), pipe)
    res["pp"] = train_run(pipe, pipe_micro=2)
    res["pp_forward"] = pp_forward(pipe, 2)
    if world == 4:
        both = make_mesh(MeshSpec(data=2, pipe=2), device_type="cpu")
        res["dp_pp"] = train_run(both, pipe_micro=2)
        res["dp_pp_forward"] = pp_forward(both, 2)
    if world > 1:
        try:
            make_gpt2_pp_apply(TC.GPT2Config(**dict(GPT2_TRAIN, n_layer=3)), pipe, n_micro=2)
            res["bad_layers"] = None
        except ValueError as e:
            res["bad_layers"] = str(e)
    try:
        lm = GPT2(TC.GPT2Config(**GPT2_TRAIN), device="cpu", seed=0)
        make_gpt2_pp_apply(lm.cfg, pipe, n_micro=3)(lm, torch.zeros(8, 4, GPT2_TRAIN["n_embd"]))
        res["bad_micro"] = None
    except ValueError as e:
        res["bad_micro"] = str(e)
    _save(out, "train", res)


# --- sequence parallelism -------------------------------------------------------------------


def ring_inputs():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 16, 3, 8)).astype(np.float32))
               for _ in range(3))
    return q, k, v, 13


def sp_pixels(cfg: dict, b: int = 4):
    rng = np.random.default_rng(8)
    return torch.from_numpy(rng.normal(size=(b, 3, cfg["image_size"], cfg["image_size"]))
                            .astype(np.float32))


def sp_worker(out) -> None:
    from clipcap_tpu_torch.core.mesh import MODEL_AXIS, axis_group, axis_rank
    from clipcap_tpu_torch.models.vit import ViT
    from clipcap_tpu_torch.parallel.sp import make_vit_sp_apply, ring_attention_shard

    world = dist.get_world_size()
    res = {}
    mesh = make_mesh(MeshSpec(model=world), device_type="cpu")
    q, k, v, t = ring_inputs()
    tl = q.shape[1] // world
    r = axis_rank(mesh, MODEL_AXIS)
    part = slice(r * tl, (r + 1) * tl)
    valid = torch.arange(q.shape[1]) < t
    with torch.no_grad():
        local = ring_attention_shard(q[:, part], k[:, part], v[:, part], valid[part],
                                     group=axis_group(mesh, MODEL_AXIS), n_shards=world)
    from clipcap_tpu_torch.core.mesh import all_gather

    res["ring"] = all_gather(local, axis_group(mesh, MODEL_AXIS), dim=1)
    layouts = [(1, world)] + ([(2, 2)] if world == 4 else [])
    for data, model_axis in layouts:
        m = make_mesh(MeshSpec(data=data, model=model_axis), device_type="cpu")
        for style, cfg in (("clip", CLIP_VIT), ("blip", BLIP_VIT)):
            vit = ViT(TC.ViTConfig(**cfg), device="cpu", seed=3)
            apply = make_vit_sp_apply(vit.cfg, m)
            pixels = sp_pixels(cfg)
            modes = ["pooled", "tokens_proj", "tokens"] if style == "clip" else ["tokens"]
            with torch.no_grad():
                for mode in modes:
                    res[f"{data}x{model_axis}_{style}_{mode}"] = apply(vit, pixels, output=mode)
            loss = apply(vit, pixels).square().mean()
            grads = torch.autograd.grad(loss, list(vit.parameters()))
            res[f"{data}x{model_axis}_{style}_grads"] = dict(
                zip([n for n, _ in vit.named_parameters()], grads))
        if data > 1:
            try:
                make_vit_sp_apply(vit.cfg, m)(vit, sp_pixels(BLIP_VIT, b=3))
                res["bad_batch"] = None
            except ValueError as e:
                res["bad_batch"] = str(e)
    _save(out, "sp", res)


# --- the MoE mapper and expert parallelism --------------------------------------------------


MOE = dict(n_experts=8, n_top=2, capacity_factor=1.25)


def moe_prefix():
    rng = np.random.default_rng(9)
    return torch.from_numpy(rng.normal(size=(4, MOE_MAPPER["dim_clip"])).astype(np.float32))


def moe_run(mapper, constraint=None) -> dict:
    from clipcap_tpu_torch.models import moe

    out, aux = moe.apply(mapper, moe_prefix(), expert_constraint=constraint)
    loss = out.square().sum() + 0.01 * aux
    names = [n for n, _ in mapper.named_parameters()]
    grads = torch.autograd.grad(loss, list(mapper.parameters()))
    return {"out": out.detach(), "aux": aux.detach(), "grads": dict(zip(names, grads))}


def moe_worker(out) -> None:
    from clipcap_tpu_torch.models import moe
    from clipcap_tpu_torch.parallel.ep import expert_constraint, shard_experts

    world = dist.get_world_size()
    mesh = make_mesh(MeshSpec(model=world), device_type="cpu")
    cfg = TC.MapperConfig(**MOE_MAPPER)
    sharded = shard_experts(moe.init(cfg, moe.MoEConfig(**MOE), device="cpu", seed=4), mesh)
    replicated = moe.init(cfg, moe.MoEConfig(**MOE), device="cpu", seed=4)
    res = {"sharded": moe_run(sharded, expert_constraint(mesh)),
           "replicated": moe_run(replicated, expert_constraint(mesh))}
    _save(out, "moe", res)
