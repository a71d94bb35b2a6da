"""Dtype policy (the port's own copy of clipcap_tpu/core/dtypes.py, over
torch dtypes).

The reference trains with AMP fp16 (`pl.Trainer(precision=16)`,
reference train.py:280). The port's mixed-precision story is bfloat16
compute with float32 parameters and optimizer state, and float32
softmax/layernorm accumulation; this module names that policy. As in the
JAX package, no model takes it yet: the models hold their dtypes as
constructor arguments and the train step's `bf16_compute`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Dtype roles for one model.

    param_dtype:   storage dtype of parameters (f32 for training; bf16 for
                   inference-only replicas).
    compute_dtype: dtype activations/matmul inputs are cast to. The tensor
                   cores want bf16; parity tests use f32.
    accum_dtype:   accumulation dtype for attention logits / softmax /
                   layernorm statistics: always f32.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) if x.dtype != self.compute_dtype else x

    def cast_accum(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.accum_dtype) if x.dtype != self.accum_dtype else x


def default_policy(training: bool = True) -> DTypePolicy:
    return DTypePolicy(
        param_dtype=torch.float32,
        compute_dtype=torch.bfloat16,
        accum_dtype=torch.float32,
    )


# Exact policy used by numerics-parity tests.
FP32 = DTypePolicy(
    param_dtype=torch.float32, compute_dtype=torch.float32, accum_dtype=torch.float32
)

# Inference replica policy: bf16 weights, bf16 compute, f32 accumulation.
BF16_INFERENCE = DTypePolicy(
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, accum_dtype=torch.float32
)
