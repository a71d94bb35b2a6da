"""Int8 inference quantization (port of clipcap_tpu/ops/quant.py).

- weights: per-output-channel symmetric absmax quantization, done once;
- activations: dynamic per-row absmax quantization at run time;
- matmul: int8 x int8 -> int32 (`torch._int_mm`), dequantized by the
  product of the two scales.

Layout: the port stores a linear's weight as nn.Linear's [out, in], so the
per-output-channel absmax runs over the LAST axis, where JAX reduces axis
-2 of its [in, out]. `q` and `s` equal JAX's bit for bit (both round half
to even, clip to +-127 and floor the scale at 1e-12; the activation
scales as compiled JAX computes them, see `absmax_scale`). The dequantization
keeps JAX's order: int32 -> f32, * s_x, * s_w, + bias in f32, then the
cast to `out_dtype` (x's dtype when none is given).

`torch._int_mm` on CUDA takes only an [M, K] x [K, N] product with M > 16
and K, N multiples of 8, operands K-major. `int8_linear` pads the rows up
to 17 with zeros (zero rows add exact zeros to an int32 sum) and passes
the [out, in] weight as `q.t()`, so both operands are K-major; a weight
whose N is not a multiple of 8 is padded with zero channels where it is
quantized (GPT-2's lm_head, `pad_channels`). Any other shape raises:
there is no fallback. The CPU build takes any shape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

MIN_INT_MM_ROWS = 17  # torch._int_mm on CUDA wants more than 16 rows
CHANNEL_ALIGN = 8  # ... and K, N multiples of 8


def absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """The run-time quantization scale of a row whose absmax is `amax`:
    max(amax / 127, 1e-12) as JAX computes it compiled, where XLA folds the
    division by the constant into a multiplication by f32(1/127). Every
    int8 activation of JAX's decode runs compiled (jit, lax.scan)."""
    return torch.clamp_min(amax * (1.0 / 127.0), 1e-12)


def _to_int8(xf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> dict:
    """[..., out, in] weight -> {"q": int8 [..., out, in], "s": f32 [..., out]}.
    The scale divides by 127, as JAX's quantize_params run eagerly does (the
    golden fixtures' weights). The divisor is a tensor: CUDA's division by
    a Python scalar multiplies by its reciprocal, the CPU's divides."""
    wf = w.detach().float()
    s = torch.clamp_min(wf.abs().amax(dim=-1, keepdim=True) / wf.new_full((), 127.0), 1e-12)
    return {"q": _to_int8(wf, s), "s": s.squeeze(-1)}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


def quantize_rows(x: torch.Tensor):
    """Dynamic per-row symmetric quantization over the last axis.

    Returns (int8 values, f32 scales with a keepdims last axis)."""
    xf = x.float()
    s = absmax_scale(xf.abs().amax(dim=-1, keepdim=True))
    return _to_int8(xf, s), s


def pad_channels(w: torch.Tensor, multiple: int = CHANNEL_ALIGN) -> torch.Tensor:
    """[out, in] -> [out rounded up to `multiple`, in], zero rows appended
    (they quantize to q = 0 at the floor scale 1e-12)."""
    extra = -w.shape[0] % multiple
    return F.pad(w, (0, 0, 0, extra)) if extra else w


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] @ int8 [N, K]^T -> int32 [M, N] through torch._int_mm,
    the rows zero-padded to the CUDA minimum and sliced back."""
    m = a.shape[0]
    if m < MIN_INT_MM_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_INT_MM_ROWS - m))
    return torch._int_mm(a, b_t.t())[:m]


def int8_linear(x: torch.Tensor, wq: dict, bias: Optional[torch.Tensor] = None,
                out_dtype=None) -> torch.Tensor:
    """x [..., in] @ quantized [out, in] with dynamic activation scales."""
    x8, s_x = quantize_rows(x)
    lead, n = x.shape[:-1], wq["q"].shape[0]
    y = int_mm(x8.reshape(-1, x.shape[-1]), wq["q"]).reshape(*lead, n)
    y = y.float() * s_x * wq["s"].float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype if out_dtype is not None else x.dtype)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch: a quantized {"q", "s"} weight takes int8_linear; a plain
    [out, in] weight takes x @ w.T + bias."""
    if is_quantized(w):
        return int8_linear(x, w, bias)
    return F.linear(x, w, bias)


class Int8Linear(nn.Module):
    """A linear layer in int8: buffers q [out, in] int8, s [out] f32 and an
    optional bias. `weight` is the {"q", "s"} dict that `linear` dispatches
    on, so a module that calls quant.linear(x, lin.weight, lin.bias) runs
    in int8 once its nn.Linear is swapped for this."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.register_buffer("bias", bias)

    @classmethod
    def quantize(cls, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> "Int8Linear":
        wq = quantize_weight(weight)
        return cls(wq["q"], wq["s"], None if bias is None else bias.detach().clone())

    @classmethod
    def empty(cls, fan_in: int, fan_out: int, *, bias_dtype=None, device="cuda") -> "Int8Linear":
        """Zeros of the right shapes, to be filled by load_state_dict."""
        return cls(torch.zeros(fan_out, fan_in, dtype=torch.int8, device=device),
                   torch.zeros(fan_out, dtype=torch.float32, device=device),
                   None if bias_dtype is None else
                   torch.zeros(fan_out, dtype=bias_dtype, device=device))

    @property
    def weight(self) -> dict:
        return {"q": self.q, "s": self.s}

    def forward(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        return int8_linear(x, self.weight, self.bias, out_dtype)
