"""AutoClip — adaptive gradient clipping (arXiv:2007.14469; port of
clipcap_tpu/train/autoclip.py).

Rebuild of the reference's AutoClip (reference auto_clip.py:7-31): keep a
bounded history of global gradient norms and clip each step to the
`percentile`-th percentile of that history (the current step's norm is
appended *before* the percentile is taken, matching the reference's
__call__ order).

The history is a fixed-size ring buffer of device tensors, so a step
reads nothing back to the host (the reference syncs norms to the CPU
every step, auto_clip.py:21). Non-finite norms are not recorded
(reference :26-27). The percentile sorts the buffer with +inf past the
recorded count and interpolates linearly, as np.percentile over the
valid prefix does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class AutoClipState(NamedTuple):
    history: torch.Tensor  # [max_history] f32 ring buffer
    count: torch.Tensor  # scalar int32: total norms recorded (saturates at max)
    pos: torch.Tensor  # scalar int32: next write position


def autoclip_init(max_history: int = 50000, device="cuda") -> AutoClipState:
    return AutoClipState(
        history=torch.zeros((max_history,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all the gradients: the reference's norm of per-tensor
    norms (auto_clip.py:21-22), which equals the flat global L2 norm, in
    f32 on the gradients' device."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def _percentile_of_valid(history: torch.Tensor, count: torch.Tensor,
                         percentile: float) -> torch.Tensor:
    """np.percentile(history[:count], percentile) with static shapes."""
    max_h = history.shape[0]
    valid = torch.arange(max_h, device=history.device) < count
    inf = torch.full((), float("inf"), dtype=history.dtype, device=history.device)
    sorted_hist = torch.sort(torch.where(valid, history, inf)).values
    rank = (count.float() - 1.0) * (percentile / 100.0)
    lo = torch.clamp(torch.floor(rank).long(), 0, max_h - 1)
    hi = torch.clamp(torch.ceil(rank).long(), 0, max_h - 1)
    frac = rank - torch.floor(rank)
    # gathers at device indices: a 0-dim index tensor would be read to the host
    at_lo, at_hi = sorted_hist.gather(0, lo.view(1))[0], sorted_hist.gather(0, hi.view(1))[0]
    return at_lo * (1.0 - frac) + at_hi * frac


def _scaled(grads: Sequence[torch.Tensor], scale: torch.Tensor) -> List[torch.Tensor]:
    """Each gradient times the f32 scalar tensor `scale`, in its own dtype."""
    return list(torch._foreach_mul(list(grads), scale))


def autoclip_update(state: AutoClipState, grads: Sequence[torch.Tensor],
                    percentile: float, norm: Optional[torch.Tensor] = None
                    ) -> Tuple[List[torch.Tensor], AutoClipState, dict]:
    """Record the norm, clip grads to the percentile. Returns
    (clipped_grads, new_state, {pre/post norms, clip value}), all on the
    device. `norm` is the global norm where `grads` are shards of the
    gradient (ZeRO); by default it is global_norm(grads)."""
    norm = global_norm(grads) if norm is None else norm
    finite = torch.isfinite(norm)
    max_h = state.history.shape[0]

    pos = state.pos.long().view(1)
    old = state.history.gather(0, pos)
    history = state.history.scatter(0, pos, torch.where(finite, norm, old[0]).view(1))
    new_pos = torch.where(finite, torch.remainder(state.pos + 1, max_h), state.pos)
    count = torch.where(finite, torch.clamp(state.count + 1, max=max_h), state.count)

    clip_value = _percentile_of_valid(history, count, percentile)
    # torch.nn.utils.clip_grad_norm_ semantics: scale by clip/(norm+eps) if norm > clip
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    scale = torch.where((count > 0) & (norm > clip_value), clip_value / (norm + 1e-6), one)
    new_state = AutoClipState(history=history, count=count.to(torch.int32),
                              pos=new_pos.to(torch.int32))
    metrics = {
        "grad_norm_pre_clip": norm,
        "grad_norm_post_clip": norm * scale,
        "autoclip_value": clip_value,
    }
    return _scaled(grads, scale), new_state, metrics


def fixed_clip(grads: Sequence[torch.Tensor], clip_value: float,
               norm: Optional[torch.Tensor] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Standard global-norm clipping for gradient_clip_val >= 0 (`norm` as
    autoclip_update's)."""
    norm = global_norm(grads) if norm is None else norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    scale = torch.where(norm > clip_value, clip_value / (norm + 1e-6), one)
    return _scaled(grads, scale), norm
