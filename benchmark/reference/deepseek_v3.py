"""DeepSeek-V3's decoder (arXiv:2412.19437, section 2.1; HF
DeepseekV3ForCausalLM) in float32, written from the published description:
no cache, no batching tricks, no kernels.

- Multi-head latent attention, expanded: q = W_q x (no query latent,
  `q_lora_rank` null), per head nope then rope dims; [c | k_rope] = W_kva x,
  c RMS-normed; [k_nope | v] per head = W_kvb c; k = [k_nope | k_rope]
  with k_rope shared by the heads; causal softmax of q.k / sqrt(nope +
  rope).
- The dense SwiGLU of the first `first_k_dense_replace` layers; then the
  MoE: sigmoid scores in f32, the top k of score + e_score_correction_bias,
  the chosen scores (without the bias) normalized to sum 1 and times
  `routed_scaling_factor`, each routed expert computed for the tokens
  routed to it, plus the shared experts for every token.
- RMSNorm with f32 statistics; an untied head.

Departures from the description, none of which changes a logit:
- The rotary dims are rotated in pairs (2i, 2i+1) where they lie.
  DeepSeek-V3's code de-interleaves the pairs into [evens | odds] before
  rotating by halves; that permutes q_rope and k_rope alike, and every
  score q.k is the same.
- Moonlight has no multi-token prediction layers
  (`num_nextn_predict_layers` 0), so there are none here.
- The stop ids are the traffic mix's synthetic ones: the judge reads
  tokens, and no tokenizer runs.

Weights are the port's state-dict names (benchmark/families/deepseek_v3.py
lists them). They may be given in bf16: each layer is widened to float32
when it runs and dropped after, so a 16B model is held once in bf16 plus
one layer in float32. With `quant_bits` every projection and expert matrix
(not the router) is rounded per output channel to that many bits: the
control.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .common import fake_quant


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x, positions, theta):
    """Pairs (2i, 2i+1) of x [B, T, ..., d] rotated by position x
    theta^(-2i/d)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv  # [T, d/2]
    shape = (1, len(positions)) + (1,) * (x.dim() - 3) + (d // 2,)
    sin, cos = torch.sin(ang).view(shape), torch.cos(ang).view(shape)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], -1).flatten(-2)


def swiglu(x, gate_up, down):
    g, u = (x @ gate_up.T).chunk(2, -1)
    return (torch.nn.functional.silu(g) * u) @ down.T


class LM:
    """The decoder over the weights `w` (names with the "lm." prefix)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict, quant_bits: Optional[int] = None):
        self.cfg = cfg
        self.bits = quant_bits
        self.w = {k[3:]: t for k, t in w.items() if k.startswith("lm.")}

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i's weights in float32, the matrices rounded to quant_bits."""
        p = f"layers.{i}."
        out = {}
        for name, t in self.w.items():
            if not name.startswith(p):
                continue
            key = name[len(p):]
            t = t.float()
            if t.dim() >= 2 and not key.startswith("mlp.router"):
                t = fake_quant(t, self.bits)
            out[key] = t
        return out

    def _attention(self, lw, h):
        cfg = self.cfg
        b, t, _ = h.shape
        heads, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
        dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        pos = torch.arange(t, device=h.device)
        q = (h @ lw["attn.q_proj.weight"].T).view(b, t, heads, dn + dr)
        q_nope, q_rope = q.split([dn, dr], -1)
        c, k_rope = (h @ lw["attn.kv_a.weight"].T).split([r, dr], -1)
        c = rms_norm(c, lw["attn.kv_norm.weight"], cfg["rms_norm_eps"])
        k_nope, v = (c @ lw["attn.kv_b.weight"].T).view(b, t, heads, dn + dv).split([dn, dv], -1)
        q = torch.cat([q_nope, rope(q_rope, pos, cfg["rope_theta"])], -1)
        k_rope = rope(k_rope, pos, cfg["rope_theta"])[:, :, None].expand(b, t, heads, dr)
        k = torch.cat([k_nope, k_rope], -1)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dn + dr)
        causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, t, heads * dv)
        return o @ lw["attn.o_proj.weight"].T

    def _moe(self, lw, h):
        cfg = self.cfg
        x = h.reshape(-1, h.shape[-1])
        scores = torch.sigmoid(x @ lw["mlp.router.weight"].T)
        chosen = torch.topk(scores + lw["mlp.router_bias"], cfg["num_experts_per_tok"], -1).indices
        weight = scores.gather(-1, chosen)
        if cfg["norm_topk_prob"]:
            weight = weight / weight.sum(-1, keepdim=True)
        weight = weight * cfg["routed_scaling_factor"]
        out = swiglu(x, lw["mlp.shared.gate_up.weight"], lw["mlp.shared.down.weight"])
        for e in range(cfg["n_routed_experts"]):
            tok, slot = (chosen == e).nonzero(as_tuple=True)
            if len(tok):
                y = swiglu(x[tok], lw["mlp.experts.gate_up"][e], lw["mlp.experts.down"][e])
                out = out.index_add(0, tok, y * weight[tok, slot][:, None])
        return out.view(h.shape)

    def hidden(self, embeds: torch.Tensor) -> torch.Tensor:
        """embeds [B, T, D] at positions 0..T-1 -> the final normed states."""
        cfg = self.cfg
        eps = cfg["rms_norm_eps"]
        x = embeds.float()
        for i in range(cfg["num_hidden_layers"]):
            lw = self._layer(i)
            x = x + self._attention(lw, rms_norm(x, lw["attn_norm.weight"], eps))
            h = rms_norm(x, lw["mlp_norm.weight"], eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + swiglu(h, lw["mlp.gate_up.weight"], lw["mlp.down.weight"])
            else:
                x = x + self._moe(lw, h)
            del lw
        return rms_norm(x, self.w["norm.weight"].float(), eps)

    def head_weight(self) -> torch.Tensor:
        return fake_quant(self.w["head.weight"].float(), self.bits)

    def logits(self, embeds: torch.Tensor, prefix_len: int = 0) -> torch.Tensor:
        """embeds [B, T, D] -> logits [B, T, V]. The configuration decodes in
        bf16 without a quantized cache, so the prefix's positions need no
        path of their own (`prefix_len` is taken for the common surface)."""
        return self.hidden(embeds) @ self.head_weight().T

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["embed"][tokens].float()
