"""GPT-2 (Radford et al. 2019; HF GPT2LMHeadModel) in float32: learned
positions, pre-LN blocks with a fused [q | k | v] projection, causal
attention, the tanh GELU, a final LayerNorm and the head tied to the
token embedding. `quant_bits` runs the int8 decode that a configuration
states (int8 weights per output channel, activations per row, a KV cache
per position and head) at that many bits, in float32, with round half to
even and absmax scales: 8 works the program's quantization out again from
the weights, 4 is the control one step below.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .common import attention, fake_quant, fake_quant_rows, gelu_tanh, layer_norm

LINEARS = ("c_attn", "c_proj", "c_fc", "mlp_proj")


class LM:
    """GPT-2 over float32 copies of the weights. With `quant_bits` it runs
    the decode the configuration states at that width, in float32: the
    block linears and the head rounded per output channel, their inputs per
    row; a decode position's query rounded per head, every key and value
    per position and head, and its attention probabilities, scaled by the
    values' scales, per row before the value product. The prefix's own
    positions attend in full precision, as a prefill does."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict, quant_bits: Optional[int] = None):
        self.cfg = cfg
        self.bits = quant_bits
        self.w = {}
        for name, t in w.items():
            if not name.startswith("lm."):
                continue
            t = t.float()
            mod = name.rsplit(".", 2)
            if len(mod) == 3 and mod[1] in LINEARS and mod[2] == "weight":
                t = fake_quant(t, quant_bits)
            self.w[name[3:]] = t
        self.head = fake_quant(self.w["wte"], quant_bits)

    def _linear(self, x, name):
        w = self.w
        return fake_quant_rows(x, self.bits) @ w[name + ".weight"].T + w[name + ".bias"]

    def _attention(self, q, k, v, prefix_len: int):
        """Causal attention; query positions from prefix_len on read the
        rounded cache."""
        full = attention(q, k, v, causal=True)
        if self.bits is None or prefix_len >= q.shape[1]:
            return full
        b, t, h, dh = q.shape
        top = 2 ** (self.bits - 1) - 1
        sv = torch.clamp_min(v.abs().amax(-1, keepdim=True) / top, 1e-12)  # [B, T, H, 1]
        v_int = torch.clamp(torch.round(v / sv), -top, top)
        s = torch.einsum("bqhd,bkhd->bhqk", fake_quant_rows(q, self.bits),
                         fake_quant_rows(k, self.bits)) / math.sqrt(dh)
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        p = fake_quant_rows(p * sv[..., 0].permute(0, 2, 1)[:, :, None, :], self.bits)
        cached = torch.einsum("bhqk,bkhd->bqhd", p, v_int).reshape(b, t, h * dh)
        keep = torch.arange(t, device=q.device)[None, :, None] < prefix_len
        return torch.where(keep, full, cached)

    def logits(self, embeds: torch.Tensor, prefix_len: int = 0) -> torch.Tensor:
        """embeds [B, T, D] (positions 0..T-1, the first prefix_len of them a
        prefilled prompt) -> logits [B, T, V]."""
        w, cfg = self.w, self.cfg
        b, t, d = embeds.shape
        heads, eps = cfg["n_head"], cfg["layer_norm_epsilon"]
        x = embeds + w["wpe"][:t]
        for i in range(cfg["n_layer"]):
            p = f"blocks.{i}."
            h = layer_norm(x, w[p + "ln1.weight"], w[p + "ln1.bias"], eps)
            qkv = self._linear(h, p + "c_attn")
            q, k, v = (y.reshape(b, t, heads, d // heads) for y in qkv.split(d, -1))
            x = x + self._linear(self._attention(q, k, v, prefix_len), p + "c_proj")
            h = layer_norm(x, w[p + "ln2.weight"], w[p + "ln2.bias"], eps)
            x = x + self._linear(gelu_tanh(self._linear(h, p + "c_fc")), p + "mlp_proj")
        x = layer_norm(x, w["ln_f.weight"], w["ln_f.bias"], eps)
        return fake_quant_rows(x, self.bits) @ self.head.T

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["wte"][tokens]
