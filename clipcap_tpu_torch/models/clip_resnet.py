"""CLIP's ModifiedResNet image tower, RN50 to RN50x64 (port of
clipcap_tpu/models/clip_resnet.py).

The Gen-B ranking ensembles re-rank with RN50x64 (reference
sampling.py:436-479, caption_me.py:56-74). The published architecture:

- a 3-conv stem (stride 2 on the first) and a 2x2 average pool;
- Bottleneck blocks (expansion 4) with anti-aliased striding: stride-1
  convolutions plus an average pool after conv2 (and in the downsample
  path);
- an attention-pooling head: the mean token prepended, a learned
  positional embedding, one multi-head attention whose query is the mean
  token.

Convolutions are torch.nn.functional.conv2d (cuDNN on the card), as JAX's
are XLA convolutions outside any Pallas kernel. BatchNorm is applied from
the checkpoint's running statistics in inference mode, folded as JAX folds
it: scale = g / sqrt(var + eps), shift = b - mean * scale, x * scale +
shift. The attention pool is plain torch, as it is plain XLA in JAX.
Parameter names are OpenAI's `visual.*` without the prefix, so
tools/import_weights copies a checkpoint through.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import linear, make_generator, normal


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    output_dim: int = 1024
    heads: int = 32
    image_size: int = 224
    bn_eps: float = 1e-5

    @classmethod
    def variant(cls, name: str) -> "ResNetConfig":
        table = {
            "RN50": dict(layers=(3, 4, 6, 3), width=64, output_dim=1024, heads=32,
                         image_size=224),
            "RN101": dict(layers=(3, 4, 23, 3), width=64, output_dim=512, heads=32,
                          image_size=224),
            "RN50x4": dict(layers=(4, 6, 10, 6), width=80, output_dim=640, heads=40,
                           image_size=288),
            "RN50x16": dict(layers=(6, 8, 18, 8), width=96, output_dim=768, heads=48,
                            image_size=384),
            "RN50x64": dict(layers=(3, 15, 36, 10), width=128, output_dim=1024, heads=64,
                            image_size=448),
        }
        if name not in table:
            raise ValueError(f"unknown CLIP ResNet variant {name!r}")
        return cls(**table[name])


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d in inference mode from stored statistics (buffers named
    as nn.BatchNorm2d's, without num_batches_tracked)."""

    def __init__(self, c: int, eps: float, device, dtype):
        super().__init__()
        self.eps = eps
        kw = dict(device=device, dtype=dtype)
        self.register_buffer("weight", torch.ones(c, **kw))
        self.register_buffer("bias", torch.zeros(c, **kw))
        self.register_buffer("running_mean", torch.zeros(c, **kw))
        self.register_buffer("running_var", torch.ones(c, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = torch.tensor(self.eps, dtype=self.running_var.dtype, device=x.device)
        scale = self.weight / torch.sqrt(self.running_var + eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class Conv(nn.Module):
    """A bias-free convolution's OIHW weight, N(0, fan_in^-1) at init."""

    def __init__(self, cout: int, cin: int, k: int, gen, device, dtype):
        super().__init__()
        self.weight = normal((cout, cin, k, k), (cin * k * k) ** -0.5, gen, device, dtype)

    def forward(self, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
        return F.conv2d(x, self.weight, stride=stride, padding=padding)


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    return x if k == 1 else F.avg_pool2d(x, k)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool, eps: float,
                 gen, device, dtype):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.stride = stride
        self.conv1, self.bn1 = Conv(planes, inplanes, 1, **kw), FrozenBatchNorm(
            planes, eps, device, dtype)
        self.conv2, self.bn2 = Conv(planes, planes, 3, **kw), FrozenBatchNorm(
            planes, eps, device, dtype)
        self.conv3, self.bn3 = Conv(planes * 4, planes, 1, **kw), FrozenBatchNorm(
            planes * 4, eps, device, dtype)
        self.downsample = (nn.ModuleList([Conv(planes * 4, inplanes, 1, **kw),
                                          FrozenBatchNorm(planes * 4, eps, device, dtype)])
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out, padding=1)))
        out = self.bn3(self.conv3(_avgpool(out, self.stride)))
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(_avgpool(x, self.stride)))
        return torch.relu(out + identity)


class AttentionPool(nn.Module):
    def __init__(self, spacial: int, embed_dim: int, output_dim: int, heads: int, gen, device,
                 dtype):
        super().__init__()
        self.heads = heads
        kw = dict(bias=True, gen=gen, device=device, dtype=dtype)
        self.positional_embedding = normal((spacial**2 + 1, embed_dim), embed_dim**-0.5, gen,
                                           device, dtype)
        self.q_proj = linear(embed_dim, embed_dim, std=embed_dim**-0.5, **kw)
        self.k_proj = linear(embed_dim, embed_dim, std=embed_dim**-0.5, **kw)
        self.v_proj = linear(embed_dim, embed_dim, std=embed_dim**-0.5, **kw)
        self.c_proj = linear(embed_dim, output_dim, std=embed_dim**-0.5, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> [B, output_dim]: the mean token queries every token."""
        b, c, h, w = x.shape
        x = x.reshape(b, c, h * w).permute(2, 0, 1)  # [HW, B, C]
        x = torch.cat([x.mean(dim=0, keepdim=True), x], dim=0)
        seq = (x + self.positional_embedding[:, None, :]).permute(1, 0, 2)  # [B, HW+1, C]
        t, dh = seq.shape[1], c // self.heads
        q = self.q_proj(seq[:, :1]).reshape(b, 1, self.heads, dh)
        k = self.k_proj(seq).reshape(b, t, self.heads, dh)
        v = self.v_proj(seq).reshape(b, t, self.heads, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh**-0.5
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, c)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """CLIP's ResNet image tower with the JAX package's init: N(0, fan_in^-1)
    convolutions, identity BatchNorm statistics, attention-pool weights and
    positions N(0, C^-1), zero biases."""

    def __init__(self, cfg: ResNetConfig, *, device="cuda", dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = make_generator(seed, device)
        kw = dict(gen=gen, device=device, dtype=dtype)
        w, eps = cfg.width, cfg.bn_eps

        def bn(c):
            return FrozenBatchNorm(c, eps, device, dtype)

        self.conv1, self.bn1 = Conv(w // 2, 3, 3, **kw), bn(w // 2)
        self.conv2, self.bn2 = Conv(w // 2, w // 2, 3, **kw), bn(w // 2)
        self.conv3, self.bn3 = Conv(w, w // 2, 3, **kw), bn(w)
        inplanes = w
        for stage, blocks in enumerate(cfg.layers):
            planes = w * 2**stage
            layer = nn.ModuleList()
            for j in range(blocks):
                stride = (1 if stage == 0 else 2) if j == 0 else 1
                down = j == 0 and (stage > 0 or inplanes != planes * 4)
                layer.append(Bottleneck(inplanes, planes, stride, down, eps, **kw))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", layer)
        self.attnpool = AttentionPool(cfg.image_size // 32, inplanes, cfg.output_dim, cfg.heads,
                                      **kw)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, 3, S, S] normalized pixels -> pooled features [B, output_dim]."""
        x = torch.relu(self.bn1(self.conv1(pixels, stride=2, padding=1)))
        x = torch.relu(self.bn2(self.conv2(x, padding=1)))
        x = torch.relu(self.bn3(self.conv3(x, padding=1)))
        x = _avgpool(x, 2)
        for stage in range(1, 5):
            for blk in getattr(self, f"layer{stage}"):
                x = blk(x)
        return self.attnpool(x)
