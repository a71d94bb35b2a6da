"""Vision transformers, CLIP style and BLIP(timm) style (port of clipcap_tpu/models/vit.py).

- patchify is a reshape + one matmul (a stride-P convolution is a
  per-patch linear), in conv-weight flatten order (c, ph, pw);
- attention logits and softmax are f32; on CUDA, sequences of at most
  1024 tokens with head_dim 64 or 128 run the hand-written kernel K1
  (ops/kernels/fused_attention.py), the JAX package's Pallas gate with
  "on a TPU" read as "on CUDA";
- output modes: "pooled" (CLIP: ln_post on CLS, then @ proj),
  "tokens_proj" (all tokens @ proj, no ln_post: the reference's
  monkeypatched forward, reference inference.py:422-444) and "tokens"
  (BLIP/timm: final norm over all tokens, no projection).

The JAX module's `init` is the `ViT` constructor and `apply` is `ViT.forward`;
`quantize_params` gives the int8 encoder (its linears int8, attention still
K1 on CUDA).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..core.config import ViTConfig
from ..ops import quant
from ..ops.activations import gelu_exact, quick_gelu
from ..ops.attention import dot_product_attention
from ..ops.kernels.fused_attention import HEAD_DIMS, MAX_SEQ, fused_attention
from ..ops.layernorm import LayerNorm
from .common import linear, make_generator, normal, remat_call


def patchify(pixels: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, gh*gw, 3*P*P] in conv-weight flatten order (c, ph, pw)."""
    b, c, h, w = pixels.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = pixels.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, gh * gw, c * p * p)


def use_kernel_attention(t: int, dh: int, x: torch.Tensor) -> bool:
    """The fused attention kernel's gate (vit.py:92-96): sequences that fit
    it, head_dim 64 or 128, and a tensor on CUDA."""
    return t <= MAX_SEQ and dh in HEAD_DIMS and x.is_cuda


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, gen, device, dtype):
        super().__init__()
        d = cfg.width
        hidden = int(d * cfg.mlp_ratio)
        eps = cfg.layer_norm_epsilon
        kw = dict(gen=gen, device=device, dtype=dtype, std=0.02, bias=True)
        self.heads = cfg.heads
        self.act = quick_gelu if cfg.style == "clip" else gelu_exact
        self.ln1 = LayerNorm(d, eps, device=device, dtype=dtype)
        self.qkv = linear(d, 3 * d, **kw)
        self.out = linear(d, d, **kw)
        self.ln2 = LayerNorm(d, eps, device=device, dtype=dtype)
        self.fc1 = linear(d, hidden, **kw)
        self.fc2 = linear(hidden, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        heads, dh = self.heads, d // self.heads
        h = self.ln1(x)
        qkv = quant.linear(h, self.qkv.weight, self.qkv.bias)
        # views of the packed projection: the kernel reads them in place
        q, k, v = (y.reshape(b, t, heads, dh) for y in qkv.chunk(3, dim=-1))
        if use_kernel_attention(t, dh, q):
            attn = fused_attention(q, k, v)
        else:
            attn = dot_product_attention(q, k, v)
        x = x + quant.linear(attn.reshape(b, t, d), self.out.weight, self.out.bias)
        h = self.ln2(x)
        h = self.act(quant.linear(h, self.fc1.weight, self.fc1.bias))
        return x + quant.linear(h, self.fc2.weight, self.fc2.bias)


class ViT(nn.Module):
    """CLIP/BLIP vision transformer with the JAX package's init: N(0, 0.02)
    weights, zero biases, cls/pos/proj at N(0, width^-1)."""

    def __init__(self, cfg: ViTConfig, *, device="cuda", dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(seed, device)
        d = cfg.width
        scale = d**-0.5
        patch_dim = 3 * cfg.patch_size * cfg.patch_size
        self.patch = linear(patch_dim, d, bias=cfg.style == "blip", gen=gen, device=device,
                            dtype=dtype, std=0.02)
        self.cls = normal((d,), scale, gen, device, dtype)
        self.pos = normal((cfg.grid * cfg.grid + 1, d), scale, gen, device, dtype)
        if cfg.style == "clip":
            self.ln_pre = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(ViTBlock(cfg, gen, device, dtype) for _ in range(cfg.layers))
        self.ln_post = LayerNorm(d, cfg.layer_norm_epsilon, device=device, dtype=dtype)
        self.proj = (normal((d, cfg.output_dim), scale, gen, device, dtype)
                     if cfg.style == "clip" and cfg.output_dim is not None else None)

    def forward(self, pixels: torch.Tensor, output: Optional[str] = None,
                remat: bool = False) -> torch.Tensor:
        """pixels [B, 3, H, W], resized and normalized -> features; remat
        checkpoints each block (JAX's apply(remat=True))."""
        cfg = self.cfg
        if output is None:
            output = "pooled" if cfg.style == "clip" else "tokens"
        x = quant.linear(patchify(pixels, cfg.patch_size), self.patch.weight, self.patch.bias)
        b = x.shape[0]
        cls = self.cls.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos[None, : x.shape[1]]
        if cfg.style == "clip":
            x = self.ln_pre(x)
        for block in self.blocks:
            x = remat_call(block, x) if remat else block(x)
        if output == "pooled":
            pooled = self.ln_post(x[:, 0])
            return pooled @ self.proj if self.proj is not None else pooled
        if output == "tokens_proj":
            if self.proj is None:
                raise ValueError("tokens_proj needs a projection (CLIP-style ViT)")
            return x @ self.proj
        if output == "tokens":
            return self.ln_post(x)
        raise ValueError(f"unknown ViT output mode {output!r}")


def quantize_params(vit: ViT) -> ViT:
    """The int8 encoder (JAX vit.quantize_params): a copy of `vit` whose
    patch, QKV, attention-out and MLP weights are per-output-channel int8
    (ops.quant.Int8Linear, which quant.linear dispatches on); LayerNorms,
    embeddings, biases and the output projection keep their dtype."""
    out = copy.deepcopy(vit)
    out.patch = quant.Int8Linear.quantize(vit.patch.weight, vit.patch.bias)
    for blk, src in zip(out.blocks, vit.blocks):
        for name in ("qkv", "out", "fc1", "fc2"):
            lin = getattr(src, name)
            setattr(blk, name, quant.Int8Linear.quantize(lin.weight, lin.bias))
    return out
