"""Plain PyTorch pieces of the references, in float32, written from the
published descriptions and not from the port: LayerNorm, attention, the
GELUs, per-channel and per-row integer rounding, ClipCap's transformer
mapper (arXiv:2111.09734; the reference repository's
layers/Transformer.py) and CLIP's vision transformer (Radford et al. 2021).
TF32 is off while the references run (`no_tf32`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def no_tf32():
    """Turn TF32 off for float32 products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, g, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def fake_quant(w: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """w [out, in] rounded per output channel to `bits`-bit integers times
    their absmax scale (unchanged when bits is None)."""
    if bits is None:
        return w
    top = 2 ** (bits - 1) - 1
    s = torch.clamp_min(w.abs().amax(-1, keepdim=True) / top, 1e-12)
    return torch.clamp(torch.round(w / s), -top, top) * s


def attention(q, k, v, causal: bool):
    """q, k, v [B, T, H, Dh] -> [B, T, H*Dh], softmax over keys."""
    b, t, h, dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if causal:
        mask = torch.ones(t, k.shape[1], dtype=torch.bool, device=q.device).tril(k.shape[1] - t)
        s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(b, t, h * dh)


def mapper(w: Dict[str, torch.Tensor], m: dict, feats: torch.Tensor) -> torch.Tensor:
    """feats [N, dim_clip] -> prefix [N, prefix_length, dim_embedding]."""
    d, heads = m["dim_embedding"], m["num_heads"]
    n = feats.shape[0]
    x = (feats @ w["mapper.linear.weight"].T + w["mapper.linear.bias"]).reshape(
        n, m["clip_length"], d)
    x = torch.cat([x, w["mapper.prefix_const"].expand(n, -1, -1)], 1)
    t = x.shape[1]
    for i in range(m["num_layers"]):
        p = f"mapper.layers.{i}."
        h = layer_norm(x, w[p + "ln1.weight"], w[p + "ln1.bias"], 1e-5)
        q = (h @ w[p + "wq.weight"].T).reshape(n, t, heads, d // heads)
        kv = (h @ w[p + "wkv.weight"].T).reshape(n, t, 2, heads, d // heads)
        a = attention(q, kv[:, :, 0], kv[:, :, 1], causal=False)
        x = x + a @ w[p + "wo.weight"].T + w[p + "wo.bias"]
        h = layer_norm(x, w[p + "ln2.weight"], w[p + "ln2.bias"], 1e-5)
        h = torch.relu(h @ w[p + "fc1.weight"].T + w[p + "fc1.bias"])
        x = x + h @ w[p + "fc2.weight"].T + w[p + "fc2.bias"]
    return x[:, m["clip_length"]:]


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x.pow(3))))


def fake_quant_rows(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """x rounded over its last axis to `bits`-bit integers times each row's
    absmax scale (unchanged when bits is None): a dynamic per-row
    activation quantization."""
    if bits is None:
        return x
    top = 2 ** (bits - 1) - 1
    s = torch.clamp_min(x.abs().amax(-1, keepdim=True) / top, 1e-12)
    return torch.clamp(torch.round(x / s), -top, top) * s


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def clip_vit_pooled(w: Dict[str, torch.Tensor], v: dict, pixels: torch.Tensor) -> torch.Tensor:
    """CLIP's VisionTransformer (Radford et al. 2021): a stride-P convolution
    without bias, the class token and positions, ln_pre, pre-LN blocks
    (fused [q | k | v] projection, QuickGELU MLP), ln_post of the class
    token, the projection. pixels [N, 3, S, S] -> [N, output_dim]."""
    d, p, heads = v["width"], v["patch_size"], v["heads"]
    eps = v["layer_norm_epsilon"]
    conv = w["visual.patch.weight"].reshape(d, 3, p, p)
    x = torch.nn.functional.conv2d(pixels, conv, stride=p).flatten(2).transpose(1, 2)
    n, t = x.shape[0], x.shape[1] + 1
    x = torch.cat([w["visual.cls"].expand(n, 1, -1), x], 1) + w["visual.pos"][:t]
    x = layer_norm(x, w["visual.ln_pre.weight"], w["visual.ln_pre.bias"], eps)
    for i in range(v["layers"]):
        b = f"visual.blocks.{i}."
        h = layer_norm(x, w[b + "ln1.weight"], w[b + "ln1.bias"], eps)
        qkv = h @ w[b + "qkv.weight"].T + w[b + "qkv.bias"]
        q, k, vv = (y.reshape(n, t, heads, d // heads) for y in qkv.split(d, -1))
        x = x + attention(q, k, vv, causal=False) @ w[b + "out.weight"].T + w[b + "out.bias"]
        h = layer_norm(x, w[b + "ln2.weight"], w[b + "ln2.bias"], eps)
        h = quick_gelu(h @ w[b + "fc1.weight"].T + w[b + "fc1.bias"])
        x = x + h @ w[b + "fc2.weight"].T + w[b + "fc2.bias"]
    return layer_norm(x[:, 0], w["visual.ln_post.weight"], w["visual.ln_post.bias"], eps) @ \
        w["visual.proj"]
