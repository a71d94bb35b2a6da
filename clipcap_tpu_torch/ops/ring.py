"""Ring-KV-cache primitives for continuous-batching decode (port of
clipcap_tpu/ops/ring.py).

The cache's time axis is a ring of size T written at one global index, so
every serving slot sits at its own point in its own request while the
per-step cache write stays one slab (models/gpt2.py decode_step_ring).
Per-slot isolation comes from the [B, T] attention-bias window computed
here. `idx` is the global step counter, a Python int the host keeps.
"""

from __future__ import annotations

import torch

from .attention import NEG_INF


def ring_timesteps(idx, a_len: int, device="cuda") -> torch.Tensor:
    """gp[p]: the global timestep whose K/V ring position p holds
    (negative for never-written positions). [T] int64. `idx` is the host
    int or a 0-d int64 tensor on `device`: the same gp either way."""
    # floor-mod (% on integer tensors), not torch.fmod: before the first
    # wrap idx - p is negative for never-written positions, and a truncated
    # remainder would give them gp == p >= start, attending zero K/V
    return idx - torch.remainder(idx - torch.arange(a_len, device=device), a_len)


def ring_layout(idx, a_len: int, ring_start: torch.Tensor):
    """Ring write slot and the per-row additive bias [B, T]. For a host int
    `idx` the slot is a Python int; for a 0-d tensor `idx` (the device
    index), a 0-d tensor on its device, and no value is read on the host.

    Row b may attend ring position p iff gp(p) >= ring_start[b], its
    request's first claimed timestep; the current token's write at `idx`
    is included (gp(idx % T) == idx). Never-written positions have
    gp < 0 <= ring_start. Causality needs no extra term: the ring only
    holds timesteps <= idx."""
    gp = ring_timesteps(idx, a_len, ring_start.device)
    zero = torch.zeros((), dtype=torch.float32, device=ring_start.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ring_start.device)
    return idx % a_len, torch.where(gp[None, :] >= ring_start[:, None], zero, neg)


def refill_positions(idx: int, prefix_len: int, a_len: int, device="cuda") -> torch.Tensor:
    """Ring slots a refilled request's P prefix entries claim: global
    timesteps [idx - P, idx - 1], the window ring_layout grants a row with
    start = idx - P. [P] int64."""
    return torch.remainder(idx - prefix_len + torch.arange(prefix_len, device=device), a_len)


def paste_rows(big: torch.Tensor, small: torch.Tensor, q: int, rp: torch.Tensor,
               time_axis: int) -> torch.Tensor:
    """Write `small`'s R rows IN PLACE into `big` at the contiguous batch-row
    block [q, q+R) (axis 1) and the ring positions `rp` along `time_axis`
    (2 for the float cache [L, B, T, H, Dh]; 3 for the int8 cache's
    [L, B, H, T, Dh] slabs and [L, B, H, T] scales); returns `big`.

    One indexed write of the row block at the ring slots. The JAX version
    rolls a doubled array to get around XLA's scatter lowering and leaves
    junk outside the window; here positions outside `rp` keep what they
    held. Either is safe: ring_layout masks them for the refilled rows, and
    no other row reads these rows."""
    if not 2 <= time_axis < big.dim():
        raise ValueError(f"time axis {time_axis} of a {big.dim()}-d cache slab")
    index = [slice(None)] * big.dim()
    index[1] = slice(q, q + small.shape[1])
    index[time_axis] = rp.to(big.device)
    big[tuple(index)] = small.to(big.dtype)
    return big


def paste_rows_axis0(big: torch.Tensor, small: torch.Tensor, q: int) -> torch.Tensor:
    """Contiguous-block row paste on axis 0, in place (per-request tensors
    with no layer axis: serving state vectors); returns `big`."""
    big[q: q + small.shape[0]] = small.to(big.dtype)
    return big
