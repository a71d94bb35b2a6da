"""GPT-J-6B (Wang and Komatsuzaki 2021; HF GPTJForCausalLM) in float32."""

from __future__ import annotations

from typing import Dict

import torch

from .common import attention, gelu_tanh, layer_norm


def rotate_every_two(x):
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], -1).flatten(-2)


class LM:
    """GPT-J-6B (Wang and Komatsuzaki 2021; HF GPTJForCausalLM) in float32:
    rotary positions interleaved on the first rotary_dim dims of q and k,
    one LayerNorm feeding the attention and the MLP in parallel, bias-free
    q, k, v and output projections, a tanh-GELU MLP, a biased untied head.
    `start`/`step` decode with the keys and values of earlier positions kept
    per layer, rows reordered by `reorder`."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict):
        self.cfg = cfg
        self.w = {k[3:]: t.float() for k, t in w.items() if k.startswith("lm.")}
        rd = cfg["rotary_dim"]
        self.inv_freq = 1.0 / (10000.0 ** (torch.arange(0, rd, 2, dtype=torch.float32) / rd))
        self.k, self.v, self.t = None, None, 0

    def _rotary(self, x, positions):
        rd = self.cfg["rotary_dim"]
        ang = positions.float()[:, None] * self.inv_freq.to(x.device)[None]
        sin = torch.sin(ang).repeat_interleave(2, -1)[None, :, None]
        cos = torch.cos(ang).repeat_interleave(2, -1)[None, :, None]
        r = x[..., :rd]
        return torch.cat([r * cos + rotate_every_two(r) * sin, x[..., rd:]], -1)

    def _run(self, x):
        """x [B, T, D] at positions self.t.. -> logits [B, T, V], the keys and
        values appended."""
        w, cfg = self.w, self.cfg
        b, t, d = x.shape
        heads, eps = cfg["n_head"], cfg["layer_norm_epsilon"]
        pos = torch.arange(self.t, self.t + t, device=x.device)
        for i in range(cfg["n_layer"]):
            p = f"blocks.{i}."
            h = layer_norm(x, w[p + "ln1.weight"], w[p + "ln1.bias"], eps)
            q, k, v = ((h @ w[p + n + ".weight"].T).reshape(b, t, heads, d // heads)
                       for n in ("wq", "wk", "wv"))
            q, k = self._rotary(q, pos), self._rotary(k, pos)
            if self.t:
                k, v = torch.cat([self.k[i], k], 1), torch.cat([self.v[i], v], 1)
            self.k[i], self.v[i] = k, v
            a = attention(q, k, v, causal=True) @ w[p + "wo.weight"].T
            m = gelu_tanh(h @ w[p + "w_in.weight"].T + w[p + "w_in.bias"])
            x = x + a + m @ w[p + "w_out.weight"].T + w[p + "w_out.bias"]
        self.t += t
        x = layer_norm(x, w["ln_f.weight"], w["ln_f.bias"], eps)
        return x @ w["lm_head.weight"].T + w["lm_head.bias"]

    def start(self, embeds):
        self.k, self.v, self.t = [None] * self.cfg["n_layer"], [None] * self.cfg["n_layer"], 0
        return self._run(embeds)

    def step(self, embeds):
        return self._run(embeds)

    def reorder(self, rows):
        self.k = [k.index_select(0, rows) for k in self.k]
        self.v = [v.index_select(0, rows) for v in self.v]

    def embed(self, tokens):
        return self.w["wte"][tokens]
