"""K1: fused bidirectional multi-head attention for encoder sequences.

Replaces the TPU kernel clipcap_tpu/ops/pallas/fused_attention.py
(`fused_attention` -> `_attn_kernel`) with the hand-written CUDA kernel in
csrc/fused_attention.cu: one four-warp block per (64-query tile, head,
image), both products on the tensor cores (mma.sync; error-compensated
3xTF32 for f32 inputs, bf16 for bf16), an online f32 softmax in registers,
no [T, T] scores in device memory. Device memory bounds it on the H100 at
the ViT-B/32 shape (q, k, v read once and o written once: 39.3 MB, ~11.7 us
at B=64 in f32); see the source's header for what the design does about it.

q, k and v may be strided views, such as the three slices of a packed
`[B, T, 3*H*dh]` qkv projection reshaped to `[B, T, H, dh]`: the kernel
reads them in place. `attention_layout` checks the layout the kernel takes
(last stride 1, head stride dh, 16-byte aligned token and batch strides and
base addresses) and raises ValueError for any other; nothing is copied.

`fused_attention` launches the kernel for CUDA tensors and takes
`fused_attention_plain`, the same function in plain PyTorch, only for CPU
tensors. `LAUNCHES["fused_attention"]` counts kernel launches, and
`LAUNCHES_BY_DTYPE` the same launches by the inputs' dtype.

`fused_attention` is differentiable: an autograd Function whose forward is
the kernel (or the plain version on the CPU) and whose backward is
`fused_attention_backward_plain`, plain torch ops on either device. The
JAX package has no Pallas backward (XLA differentiates there), so neither
has the port a hand-written one. The backward recomputes the f32
probabilities from the saved q, k and v (views, saved as they came: the
gradients reach a packed qkv through autograd, as for any view).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

LAUNCHES = {"fused_attention": 0}
LAUNCHES_BY_DTYPE = {"float32": 0, "bfloat16": 0}
MAX_SEQ = 1024
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
ALIGN_BYTES = 16  # the kernel's cp.async copies move 16 bytes


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's math in PyTorch: per head, f32 scores scaled by
    dh^-0.5, max-subtracted softmax in f32, probabilities cast to v's dtype,
    f32-accumulated product with v, output in q's dtype."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh**-0.5
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_layout(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> Tuple[Tuple[int, int], ...]:
    """The (batch, token) element strides of q, k and v for the kernel.

    Each is a [B, T, H, dh] view of one shape and dtype, with last stride 1,
    head stride dh, and a base address, token stride and batch stride that
    are multiples of 16 bytes; dh is 64 or 128 and T at most MAX_SEQ.
    Raises ValueError for anything else (the caller must not copy in
    silence)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, dh], got shape {tuple(q.shape)}")
    b, t, h, dh = q.shape
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} shape {tuple(x.shape)} != q shape {tuple(q.shape)}")
        if x.dtype != q.dtype:
            raise ValueError("q, k and v must share a dtype")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {DTYPES}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if t > MAX_SEQ:
        raise ValueError(f"sequence {t} too long for the fused kernel (max {MAX_SEQ})")
    vec = ALIGN_BYTES // q.element_size()
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        sb, st, sh, sd = x.stride()
        if sd != 1:
            raise ValueError(f"{name}: last stride {sd}, want 1")
        if sh != dh and h > 1:
            raise ValueError(f"{name}: head stride {sh}, want head_dim {dh}")
        if st % vec or st < h * dh:
            raise ValueError(f"{name}: token stride {st} is not a multiple of {vec} elements "
                             f"({ALIGN_BYTES} bytes) of at least heads*head_dim {h * dh}")
        if sb % vec:
            raise ValueError(f"{name}: batch stride {sb} is not a multiple of {vec} elements")
        if x.data_ptr() % ALIGN_BYTES:
            raise ValueError(f"{name}: base address not {ALIGN_BYTES}-byte aligned")
        strides.append((sb, st))
    return tuple(strides)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {x.device}")
    (qb, qt), (kb, kt), (vb, vt) = attention_layout(q, k, v)
    lib = _build.library("fused_attention")
    fn = lib.clipcap_fused_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h, dh,
                0 if q.dtype == torch.float32 else 1, dh**-0.5, qb, qt, kb, kt, vb, vt,
                _build.stream_handle(q.device))
    _build.raise_on_error("fused_attention", rc)
    LAUNCHES["fused_attention"] += 1
    LAUNCHES_BY_DTYPE[str(q.dtype).split(".")[1]] += 1
    return out


def fused_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   dout: torch.Tensor):
    """(dq, dk, dv) of fused_attention_plain at (q, k, v) for the output
    gradient `dout`, in the order of operations autograd takes through it:
    the f32 probabilities P recomputed from q and k, dP = dO vᵀ (rounded to
    v's dtype, as the cast of P in the forward rounds its gradient),
    dv = P' ᵀ dO with P' the probabilities in v's dtype, the softmax's
    dS = P (dP - rowsum(P dP)), and dq = dS k·dh^-0.5, dk = dSᵀ q·dh^-0.5,
    each in its input's dtype."""
    dh = q.shape[-1]
    scale = dh**-0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    probs = torch.softmax(scores, dim=-1)
    do = dout.float()
    dprobs = torch.einsum("bqhd,bkhd->bhqk", do, vf).to(v.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(v.dtype).float(), do)
    ds = probs * (dprobs - (probs * dprobs).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, dout):
        return fused_attention_backward_plain(*ctx.saved_tensors, dout)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention over [B, T, H, dh]; returns [B, T, H, dh].

    CUDA tensors launch the kernel (or raise), which writes a contiguous
    output; CPU tensors take the plain version. Differentiable in q, k and
    v through fused_attention_backward_plain."""
    return _FusedAttention.apply(q, k, v)
