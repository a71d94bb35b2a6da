"""Activation functions (port of clipcap_tpu/ops/activations.py).

The mapper's configurable activations (reference layers/Transformer.py:112-130:
relu/elu/gelu/selu/geglu, where geglu doubles the fc1 width) plus CLIP's
quick_gelu and GPT-2's tanh-approximated "gelu_new".
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def geglu(x: torch.Tensor) -> torch.Tensor:
    """value * gelu(gate) over the halves of the last axis (reference
    layers/Transformer.py:112-114; exact erf gelu, torch's default)."""
    value, gate = x.chunk(2, dim=-1)
    return value * F.gelu(gate)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


@functools.lru_cache(maxsize=None)
def _gelu_new_constants(dtype: torch.dtype):
    """gelu_new's constants as JAX holds them for an input of `dtype`: a
    weakly typed constant takes the input's dtype (0.044715 is
    0.044677734375 in bf16), and sqrt(2/pi) is taken in f32, then cast.
    Returned as Python floats, each exact in `dtype`."""
    k = torch.tensor(0.044715, dtype=dtype).item()
    c = torch.sqrt(torch.tensor(2.0 / math.pi, dtype=torch.float32)).to(dtype).item()
    return k, c


def gelu_new(x: torch.Tensor, f32_product: bool = False) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU (HF activation "gelu_new"), in JAX's
    order and with its constants, so that in bf16 each op rounds as the JAX
    package's does. x^3 is taken in f32 and rounded once, as XLA's power
    is (the CPU's bf16 torch.pow rounds differently).

    f32_product: the final product (0.5 x) * (1 + tanh(...)) of its two
    rounded factors, returned in f32 unrounded. That is what compiled JAX
    quantizes where gelu_new feeds an int8 linear: XLA moves the int8
    quantization's widening convert above the product, so its bf16
    rounding drops out."""
    k, c = _gelu_new_constants(x.dtype)
    cube = torch.pow(x.float(), 3.0).to(x.dtype)
    half, gate = 0.5 * x, 1.0 + torch.tanh(c * (x + k * cube))
    if f32_product:
        return half.float() * gate  # gate widens exactly inside the product
    return half * gate


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


_ACTS = {
    "relu": F.relu,
    "elu": F.elu,
    "gelu": gelu_exact,
    "selu": F.selu,
    "geglu": geglu,
    "quick_gelu": quick_gelu,
    "gelu_new": gelu_new,
}


def parse_act_fn(name: str):
    """Name -> activation, matching reference layers/Transformer.py:117-130."""
    key = name.lower()
    if key not in _ACTS:
        raise ValueError(f"Specified activation function {name} is not supported.")
    return _ACTS[key]


def is_gated(name: str) -> bool:
    """Gated activations need a doubled fc1 width (reference :74)."""
    return name.lower() == "geglu"
