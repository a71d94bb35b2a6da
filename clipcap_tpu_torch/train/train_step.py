"""The training step: loss -> grads -> AutoClip -> AdamW (port of
clipcap_tpu/train/train_step.py).

Replaces the reference's Lightning training loop plumbing (model.py:187-216
training_step + :151-161 configure_gradient_clipping + the Trainer's
precision flags, train.py:275-289) with one function on the card. JAX
compiles it whole; here it is eager torch ops that read nothing back to
the host, so steps queue on the device without waiting (JAX's buffer
donation has no counterpart: the step updates in place).

Under a mesh (`mesh=`, one process per card) the step is JAX's pjit'ed
step with explicit collectives:
- data: each rank takes its rows of the global batch; its loss divides by
  the global token count (all-reduced), and the ranks' gradients are
  summed over `data`, so AutoClip's norm history sees the global gradient;
- ZeRO (`state.shards`, parallel/sharding.ZeroShards): the gradients are
  reduce-scattered, the global norm is an all-reduce of the shards'
  squared norms, AdamW updates this rank's shard of the f32 masters and of
  its moments, and the parameters are all-gathered for the next forward;
- pipe (with the pipelined `lm_apply` of parallel/pp.py): each stage has
  the gradients of its own chunk of `lm.blocks` only, summed over `pipe`;
- model: the ranks are replicas.

The compute policy is JAX's:
- bf16_compute: frozen parameters are stored in bf16 outright; trainable
  ones keep f32 masters and the forward sees bf16 casts of them (through
  torch.func.functional_call, so the gradients flow back through the cast
  to the masters); the CE is in f32.
- The visual encoder takes f32 pixels. In JAX, f32 pixels against bf16
  encoder weights promote to f32 op by op, so the encoder computes in f32
  on weights rounded to bf16 and only its features are cast to bf16. The
  port gives the encoder those weights as f32 (the bf16 values, exactly)
  and casts its features; the inference bundle instead casts the pixels to
  the encoder's dtype (models/bundle.py).
- The frozen encoder runs under torch.no_grad (JAX's stop_gradient);
  train_visual_encoder differentiates through it, K1's backward included.
- Gradients are taken for the trainable parameters only; the global norm
  and the optimizer see those alone (frozen leaves would add zeros). A
  frozen LM may hold non-float tensors (a GPTJInt8's int8 weights, driven
  through `lm_apply=lm.apply_q8`): they are buffers, so they never reach
  autograd or the optimizer, as JAX's partitioned compute_grads keeps
  non-float frozen leaves out of value_and_grad. With bf16_compute their
  float buffers (the scales, the biases) are stored in bf16 like every
  frozen float leaf of JAX's tree.
- Gradient accumulation (reference acc_grad_batches, train.py:93,288):
  the batch carries a leading [A] axis, and grads and loss are the mean
  over the micro-batches.
- With a tracer active (utils/profiling.py), the data group's all-reduce
  loop over the gradients is the call-stack span `train.grad_sync` (the
  host time that issues it).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import CaptionerConfig, TrainConfig
from ..core.mesh import all_reduce_
from ..models.captioner import Captioner
from ..utils import profiling as P
from .autoclip import AutoClipState, autoclip_init, autoclip_update, fixed_clip
from .optim import AdamW, AdamWState, make_optimizer


class TrainState(NamedTuple):
    model: Captioner  # the parameters: trainable f32 masters, frozen ones as stored
    opt_state: AdamWState
    autoclip: AutoClipState
    step: torch.Tensor  # scalar int32 on the model's device
    shards: Any = None  # ZeRO: parallel/sharding.ZeroShards (the masters' shards)


def create_train_state(seed: int, cap_cfg: CaptionerConfig, lm_cfg: Any,
                       train_cfg: TrainConfig, model: Optional[Captioner] = None, *,
                       vit_cfg=None, device: str = "cuda", mesh=None,
                       zero: bool = False) -> Tuple[TrainState, AdamW]:
    """A fresh train state around `model` (or a Captioner drawn from
    `seed` on `device`), and its optimizer. With bf16_compute the frozen
    floating parameters are cast to bf16 in place, as JAX stores them.
    `zero` (with a mesh) keeps this data rank's ZeRO shards of the
    trainable masters and makes the moments of those shards."""
    if model is None:
        model = Captioner(cap_cfg, lm_cfg, vit_cfg=vit_cfg, device=device, seed=seed)
    mask = model.trainable_filter()
    if train_cfg.bf16_compute:
        # f32 master copies exist for the optimizer's benefit; frozen
        # subtrees (the LM in prefix-only mode, the visual encoder) never see
        # an update, so they live in bf16 outright, as the reference holds
        # them in fp16 under AMP (train.py:280)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if not mask[name] and p.is_floating_point():
                    p.data = p.data.to(torch.bfloat16)
            for mod in model.modules():  # buffers are frozen leaves too (Int8Linear's)
                for name, b in mod.named_buffers(recurse=False):
                    if b.is_floating_point():
                        setattr(mod, name, b.to(torch.bfloat16))
    tx = make_optimizer(lr=train_cfg.optimizer_lr,
                        warmup_steps=train_cfg.scheduler_warmup_steps,
                        total_steps=train_cfg.total_steps,
                        weight_decay=train_cfg.weight_decay, trainable_mask=mask)
    params = dict(model.named_parameters())
    dev = next(model.parameters()).device
    shards = None
    if zero:
        from ..parallel.sharding import ZeroShards

        if mesh is None:
            raise ValueError("ZeRO sharding needs a mesh")
        shards = ZeroShards(model, tx.names, mesh)
    masters = shards.masters if shards is not None else [params[n] for n in tx.names]
    state = TrainState(model=model, opt_state=tx.init(masters),
                       autoclip=autoclip_init(train_cfg.autoclip_history, device=dev),
                       step=torch.zeros((), dtype=torch.int32, device=dev), shards=shards)
    return state, tx


class _CaptionLoss(nn.Module):
    """Captioner.caption_loss as a module's forward, for functional_call."""

    def __init__(self, model: Captioner):
        super().__init__()
        self.model = model

    def forward(self, tokens, prefix, remat: bool, lm_apply=None):
        return self.model.caption_loss(tokens, prefix, remat=remat, lm_apply=lm_apply)


def forward_params(model: Captioner, mask: Dict[str, bool],
                   bf16_compute: bool) -> Dict[str, torch.Tensor]:
    """What the forward sees of each parameter: trainable ones are the
    masters (bf16 casts of them with bf16_compute, differentiable), frozen
    ones detached; the visual encoder's as f32 (JAX's promotion of bf16
    weights against f32 pixels: the bf16 values, exactly)."""
    out = {}
    for name, p in model.named_parameters():
        x = p if mask[name] else p.detach()
        if bf16_compute and x.is_floating_point():
            x = x.to(torch.bfloat16)
        if name.startswith("visual.") and x.is_floating_point():
            x = x.float()
        out[name] = x
    return out


def encode_pixels(model: Captioner, fwd: Dict[str, torch.Tensor], pixels: torch.Tensor,
                  cap_cfg: CaptionerConfig, visual_cfg, remat: bool) -> torch.Tensor:
    """The visual features of f32 `pixels` with the encoder's parameters
    taken from `fwd` (forward_params): BLIP tokens, or CLIP's pooled or
    projected tokens for the mapper; under torch.no_grad unless
    cap_cfg.train_visual_encoder (JAX's stop_gradient)."""
    mode = "tokens" if visual_cfg.style == "blip" else (
        "tokens_proj" if cap_cfg.mapper.use_all_features else "pooled")
    vis = {n[len("visual."):]: t for n, t in fwd.items() if n.startswith("visual.")}
    with torch.set_grad_enabled(cap_cfg.train_visual_encoder and torch.is_grad_enabled()):
        return torch.func.functional_call(model.visual, vis, (pixels.float(),),
                                          {"output": mode, "remat": remat})


def caption_loss(model: Captioner, fwd: Dict[str, torch.Tensor], mb: dict,
                 cap_cfg: CaptionerConfig, train_cfg: TrainConfig,
                 visual_cfg=None, lm_apply=None) -> torch.Tensor:
    """The micro-batch's CE loss with the parameters `fwd`
    (forward_params): the visual features (from `mb["prefix"]`, or encoded
    from `mb["pixels"]`) cast to bf16 under bf16_compute, then
    Captioner.caption_loss with the LM's blocks checkpointed under remat,
    or with `lm_apply` in place of the LM's forward."""
    if "prefix" in mb:
        prefix = mb["prefix"]
    else:
        prefix = encode_pixels(model, fwd, mb["pixels"], cap_cfg, visual_cfg, train_cfg.remat)
    prefix = prefix.to(torch.bfloat16) if train_cfg.bf16_compute else prefix
    lm_fwd = {f"model.{n}": t for n, t in fwd.items() if not n.startswith("visual.")}
    loss, _ = torch.func.functional_call(_CaptionLoss(model), lm_fwd,
                                         (mb["tokens"], prefix, train_cfg.remat, lm_apply))
    return loss


def compute_grads(model: Captioner, batch: dict, names: List[str], cap_cfg: CaptionerConfig,
                  train_cfg: TrainConfig, visual_cfg=None, lm_apply=None, data_group=None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """(loss, the gradients of the parameters `names`, those parameters):
    the mean over the micro-batches of the [A] axis with
    accumulate_grad_batches > 1. Only those parameters are differentiated,
    so the backward never forms the frozen ones' gradients.

    With a `data_group` the batch is this rank's rows of the global one:
    each micro-batch's loss is rescaled from its own token count to the
    global count, so the ranks' gradients sum to the global batch's, and
    the returned loss is the global loss (the gradients are this rank's
    part, to be summed over the group)."""
    mask = model.trainable_filter()
    params = dict(model.named_parameters())
    diff = [params[n] for n in names]
    a = train_cfg.accumulate_grad_batches
    micro = [batch] if a <= 1 else [{k: v[i] for k, v in batch.items()} for i in range(a)]
    grads, loss_sum = None, None
    for mb in micro:
        fwd = forward_params(model, mask, train_cfg.bf16_compute)
        loss = caption_loss(model, fwd, mb, cap_cfg, train_cfg, visual_cfg, lm_apply)
        if data_group is not None:
            loss = _global_share(loss, mb["tokens"], data_group)
        g = torch.autograd.grad(loss, diff, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(diff, g)]
        loss = loss.detach()
        if grads is None:
            grads, loss_sum = g, loss
        else:
            torch._foreach_add_(grads, g)
            loss_sum = loss_sum + loss
    if a > 1:
        torch._foreach_div_(grads, a)
        loss_sum = loss_sum / a
    if data_group is not None:
        all_reduce_(loss_sum, data_group)
    return loss_sum, grads, diff


def _global_share(loss: torch.Tensor, tokens: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the global batch's loss: its mean over its own
    valid tokens (caption_loss's, id 0 and padding dropped) times
    its count over the group's. Summed over the ranks, the global mean."""
    n_local = (tokens > 0).sum()
    n_global = all_reduce_(n_local.clone(), group)
    return loss * (n_local.clamp(min=1).float() / n_global.clamp(min=1).float())


def make_train_step(cap_cfg: CaptionerConfig, lm_cfg: Any, train_cfg: TrainConfig,
                    tx: AdamW, visual_cfg: Any = None, lm_apply=None, mesh=None):
    """Build the (state, batch) -> (state, metrics) function.

    batch = {"tokens": int [B, T] (-1 padded)} plus either
      "prefix": f32 visual features (precomputed-shard path), or
      "pixels": f32 [B, 3, H, W] (visual_cfg given): the visual encoder
      runs inside the step, frozen unless cap_cfg.train_visual_encoder
      (reference model.py:196-201).
    With accumulate_grad_batches > 1, every array carries a leading [A]
    axis. Arrays are tensors on the model's device. The parameters and the
    moments are updated in place; the returned state holds the new
    AutoClip ring and step, and the metrics are device tensors. lm_apply
    overrides the LM's forward (Captioner.forward), e.g. the model's own
    `lm.apply_q8` for a frozen GPTJInt8 (JAX's lm_apply), or a pipelined
    forward (parallel/pp.py's, bound to the LM).

    `mesh`: the batch is this rank's rows of the global batch (the arrays
    it is given are those rows: core.mesh.shard_batch), and the collectives
    of the module doc run."""
    from ..core.mesh import DATA_AXIS, PIPE_AXIS, axis_group, axis_size

    data_group = pipe_group = None
    if mesh is not None:
        data_group = axis_group(mesh, DATA_AXIS)
        if axis_size(mesh, PIPE_AXIS) > 1:
            pipe_group = axis_group(mesh, PIPE_AXIS)
    # each pipeline stage differentiates its own chunk of the LM's blocks
    staged = [n.startswith("lm.blocks.") for n in tx.names]

    def train_step(state: TrainState, batch: dict) -> Tuple[TrainState, dict]:
        loss, grads, params = compute_grads(state.model, batch, tx.names, cap_cfg, train_cfg,
                                            visual_cfg, lm_apply, data_group)
        if pipe_group is not None:
            for g, st in zip(grads, staged):
                if st:
                    all_reduce_(g, pipe_group)
        norm = None
        if state.shards is not None:
            grads = state.shards.reduce(grads)
            norm = state.shards.global_norm(grads)
        elif data_group is not None:
            with P.span("train.grad_sync"):
                for g in grads:
                    all_reduce_(g, data_group)
        if train_cfg.gradient_clip_val < 0:
            grads, ac_state, clip_metrics = autoclip_update(
                state.autoclip, grads, train_cfg.autoclip_percentile, norm=norm)
        else:
            grads, pre_norm = fixed_clip(grads, train_cfg.gradient_clip_val, norm=norm)
            ac_state = state.autoclip
            clip_metrics = {"grad_norm_pre_clip": pre_norm}
        with torch.no_grad():
            if state.shards is None:
                opt_state = tx.update(grads, state.opt_state, params)
            else:
                opt_state = tx.update(grads, state.opt_state, state.shards.masters)
                state.shards.gather_into(params)
        new_state = TrainState(model=state.model, opt_state=opt_state, autoclip=ac_state,
                               step=state.step + 1, shards=state.shards)
        metrics = {"loss": loss, "step": state.step, **clip_metrics}
        return new_state, metrics

    return train_step
