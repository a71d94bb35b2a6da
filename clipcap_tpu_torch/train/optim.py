"""Optimizer + LR schedule (port of clipcap_tpu/train/optim.py).

The JAX package runs `optax.adamw(b1=0.9, b2=0.999, eps=1e-8)` inside
`optax.multi_transform`, frozen leaves getting `set_to_zero`; this is the
same update written in torch ops on the device, in optax's order of
operations:

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu;  n = count + 1
    u  = (mu / (1 - b1ⁿ)) / (sqrt(nu / (1 - b2ⁿ)) + eps)   # eps outside the root
    u  = u + wd p                                          # every trainable leaf
    p  = p + (-lr(count)) u                                # schedule before the increment

Weight decay applies to every trainable parameter, biases and LayerNorm
gains included (optax's mask is None), unlike HF's no-decay list. Frozen
parameters hold no moments and never move. The step count, the schedule
and the bias corrections stay on the device: a step reads nothing back to
the host. `torch._foreach_*` ops keep the launches per step few.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int):
    """HF get_linear_schedule_with_warmup: 0->lr over warmup, lr->0 after.
    Takes the step as an int tensor and gives the f32 rate on its device."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = max(warmup_steps, 1)
        up = step / warm
        down = torch.clamp(total_steps - step, min=0.0) / max(total_steps - warmup_steps, 1)
        return lr * torch.where(step < warmup_steps, up, down)

    return schedule


class AdamWState(NamedTuple):
    count: torch.Tensor  # scalar int32: updates applied (optax's adam and schedule counts)
    mu: List[torch.Tensor]  # first moments of the trainable parameters, in `names` order
    nu: List[torch.Tensor]  # second moments


class AdamW:
    """optax.adamw over the trainable parameters, frozen ones set to zero.

    `names` are the trainable parameters' names in the order in which
    `init` and `update` take them."""

    def __init__(self, schedule, weight_decay: float, names: Sequence[str],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.names = list(names)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        device = params[0].device if params else "cpu"
        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=device),
                          mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params])

    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor]) -> AdamWState:
        """Apply one update to `params` in place; returns the new state
        (the moments are updated in place too)."""
        grads, params = list(grads), list(params)
        b1, b2 = self.b1, self.b2
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        count_inc = state.count + 1
        n = count_inc.float()
        one = torch.ones((), dtype=torch.float32, device=n.device)
        bc1 = one - torch.pow(torch.full_like(one, b1), n)
        bc2 = one - torch.pow(torch.full_like(one, b2), n)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        step_size = -1 * self.schedule(state.count)
        torch._foreach_mul_(updates, step_size)
        torch._foreach_add_(params, updates)
        return AdamWState(count=count_inc, mu=mu, nu=nu)


def make_optimizer(lr: float, warmup_steps: int, total_steps: int,
                   weight_decay: float = 0.01,  # torch AdamW default, what the reference ran
                   trainable_mask: Optional[Dict[str, bool]] = None) -> AdamW:
    """AdamW with the linear warmup schedule over the parameters that
    `trainable_mask` ({name: bool}, Captioner.trainable_filter) marks, in
    its order."""
    names = [n for n, keep in (trainable_mask or {}).items() if keep]
    return AdamW(linear_warmup_schedule(lr, warmup_steps, total_steps), weight_decay, names)
