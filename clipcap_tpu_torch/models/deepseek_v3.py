"""DeepSeek-V3's decoder (arXiv:2412.19437; HF `model_type` "deepseek_v3")
as a ClipCap LM, at Moonlight-16B-A3B's sizes by default. The JAX package
has no such LM: this module is the port's own, held against the plain
float32 reference of benchmark/reference/deepseek_v3.py by the tests.

A block is pre-norm (RMSNorm, f32 statistics): x + attn(norm(x)), then
x + mlp(norm(x)). The residual stream x is kept in f32 and each norm's
output is rounded to the model's dtype for the products; the router reads
the f32 norm output. Rounding the stream itself to bf16 at every one of
the 54 additions moves the routers' inputs enough to flip the choice of
experts for many tokens, each flip moving the logits by a logit or more
at random weights; the f32 stream costs 8 KB a token a layer.

- Attention is multi-head latent attention (MLA) with `q_lora_rank` None:
  q = W_q x, per head `qk_nope_head_dim` plain dims then `qk_rope_head_dim`
  rotary ones; kv_a maps x to the latent c (`kv_lora_rank`, then its own
  RMSNorm) and one rotary key k_rope shared by every head; kv_b maps c to
  each head's k_nope and v. Scores are [q_nope | q_rope] . [k_nope |
  k_rope] times 1/sqrt(qk_nope + qk_rope), with no rope scaling.
- The rotary dims are rotated in pairs (2i, 2i+1) by position x
  theta^(-2i/d_rope) (GPT-J's rotate-every-two). DeepSeek-V3's code first
  de-interleaves the pairs into [evens | odds] and rotates by halves; that
  permutes q_rope and k_rope alike and leaves every score as it is, so the
  port keeps the published column order and rotates in place (the
  reference does the same).
- The first `first_k_dense_replace` layers' MLP is a SwiGLU of
  `intermediate_size`; every later one is a MoE: the sigmoid router of
  ops/experts.py over `n_routed_experts`, top `num_experts_per_tok` by
  score + e_score_correction_bias, weighted by the unbiased scores
  normalized and times `routed_scaling_factor`, the dropless grouped
  experts, plus the shared experts, one SwiGLU of n_shared x
  moe_intermediate_size, for every token.

The cache is a latent ring: `LatentCache.kv` [L, B, T, kv_lora_rank +
qk_rope_head_dim] holds each position's normed latent c_kv and its rotated
k_rope side by side (576 values a position at Moonlight's sizes, where
per-head K/V would take 16 x 256). A prefill expands its own latents per
head (kv_b) and attends as plain attention. A decode step attends in
latent space (the absorbed form): W_kb is folded into the query, q_lat =
q_nope W_kb, so the scores are [q_lat | q_rope] . kv over the ring in one
product, the weighted sum of the latents is taken, and W_vb maps it to
each head's value. Both agree with the expanded full forward.

The ring protocol is GPT-2's and GPT-J's (decode/serving.py):
`decode_step_ring` attends through ops/ring.py's [B, T] window bias with
each row at its own rotary position, and `scatter_refill` pastes a refill's
prefix latents with `paste_rows`. The ring step takes the ring index as a
device tensor and reads nothing on the host (the routed experts' groups
are found on the card), so it declares `graph_safe_ring_step` and the
serving engine replays it as one CUDA graph, as GPT2Int8's.

With a tracer active (utils/profiling.py), each MoE layer's routing and
expert products in an eager call are the call-stack span `lm.moe`. With
`log_experts(capacity)` every MoE call, eager or replayed, appends its
experts' token counts to a device log (ops/experts.py `ExpertLog`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import DeepseekV3Config
from ..ops import experts as X
from ..ops.attention import causal_bias, dot_product_attention, padding_bias
from ..ops.ring import paste_rows, refill_positions, ring_layout
from ..utils import profiling as P
from .common import gather_rows, make_generator, remat_call


class LatentCache(NamedTuple):
    kv: torch.Tensor  # [L, B, maxT, kv_lora_rank + qk_rope_head_dim]: c_kv | k_rope
    index: int  # number of valid positions (the ring's global write index)


def rope_rotation(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """exp(i angle) [..., dim // 2] (complex64) of positions [...] for the
    pairs (2i, 2i+1): angle position x theta^(-2i/dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.polar(torch.ones_like(ang), ang)


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (2i, 2i+1) of x's last axis, each pair one complex
    number times rot (broadcast against [..., dim // 2]), in f32, back in
    x's dtype."""
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    return torch.view_as_real(xc * rot).flatten(-2).to(x.dtype)


class _Params:
    """Parameter factory: N(0, std) draws from one generator."""

    def __init__(self, seed: int, device, dtype):
        self.gen = make_generator(seed, device)
        self.device, self.dtype = device, dtype

    def normal(self, *shape, std: float = 0.02) -> nn.Parameter:
        w = torch.randn(shape, generator=self.gen, device=self.device) * std
        return nn.Parameter(w.to(self.dtype))

    def ones(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, device=self.device, dtype=self.dtype))

    def zeros(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, device=self.device, dtype=self.dtype))


class RMSNorm(nn.Module):
    """RMSNorm in f32 (statistics and gain), returning f32."""

    def __init__(self, dim: int, eps: float, mk: _Params):
        super().__init__()
        self.eps = eps
        self.weight = mk.ones(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight.float(), self.eps)


class Linear(nn.Module):
    """A bias-free [out, in] projection."""

    def __init__(self, fan_in: int, fan_out: int, mk: _Params):
        super().__init__()
        self.weight = mk.normal(fan_out, fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight)


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x), gate and up stacked as [gate | up] rows;
    x is taken in the weights' dtype."""

    def __init__(self, dim: int, width: int, mk: _Params):
        super().__init__()
        self.gate_up = Linear(dim, 2 * width, mk)
        self.down = Linear(width, dim, mk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(X.swiglu(self.gate_up(x.to(self.down.weight.dtype))))


class Experts(nn.Module):
    """The routed experts' stacked SwiGLU weights: gate_up [E, 2F, D]
    ([gate | up] rows per expert) and down [E, D, F]."""

    def __init__(self, n: int, dim: int, width: int, mk: _Params):
        super().__init__()
        self.gate_up = mk.normal(n, 2 * width, dim)
        self.down = mk.normal(n, dim, width)


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, mk: _Params):
        super().__init__()
        d, e = cfg.hidden_size, cfg.n_routed_experts
        self.cfg = cfg
        self.router = Linear(d, e, mk)
        self.router_bias = mk.zeros(e)  # e_score_correction_bias: chooses, never weighs
        self.experts = Experts(e, d, cfg.moe_intermediate_size, mk)
        self.shared = SwiGLU(d, cfg.n_shared_experts * cfg.moe_intermediate_size, mk)
        self.log: Optional[X.ExpertLog] = None  # DeepseekV3.log_experts

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h: the normed residual in f32. The router reads it as it is; the
        experts take it in the weights' dtype. Returns f32."""
        cfg = self.cfg
        flat = h.reshape(-1, h.shape[-1])
        xb = flat.to(self.experts.gate_up.dtype)
        with P.span("lm.moe"):
            experts, weights = X.route(flat, self.router.weight, self.router_bias,
                                       cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                                       cfg.norm_topk_prob)
            y = X.routed_experts(xb, experts, weights, self.experts.gate_up,
                                 self.experts.down, log=self.log)
        return (y + self.shared(xb).float()).reshape(h.shape)


class MLA(nn.Module):
    """Multi-head latent attention (see the module docstring)."""

    def __init__(self, cfg: DeepseekV3Config, mk: _Params):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.h, self.r = h, cfg.kv_lora_rank
        self.dn, self.dr, self.dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.scale = (self.dn + self.dr) ** -0.5
        self.q_proj = Linear(d, h * (self.dn + self.dr), mk)
        self.kv_a = Linear(d, self.r + self.dr, mk)
        self.kv_norm = RMSNorm(self.r, cfg.rms_norm_eps, mk)
        self.kv_b = Linear(self.r, h * (self.dn + self.dv), mk)
        self.o_proj = Linear(h * self.dv, d, mk)

    def project(self, x: torch.Tensor, rot: torch.Tensor):
        """x [B, T, D] -> q_nope [B, T, H, dn], q_rope [B, T, H, dr] (rotated)
        and the latents [B, T, r + dr]: the normed c_kv, then the rotated
        k_rope. rot broadcasts against [B, T, dr/2]; the heads' q_rope and
        the shared k_rope are rotated in one call, k_rope as one more head."""
        b, t, _ = x.shape
        q = self.q_proj(x).view(b, t, self.h, self.dn + self.dr)
        q_nope, q_rope = q.split([self.dn, self.dr], -1)
        c, k_rope = self.kv_a(x).split([self.r, self.dr], -1)
        qk = apply_rope(torch.cat([q_rope, k_rope[:, :, None]], 2), rot[:, :, None])
        lat = torch.cat([self.kv_norm(c).to(x.dtype), qk[:, :, self.h]], -1)
        return q_nope, qk[:, :, :self.h], lat

    def expanded(self, q_nope, q_rope, lat, bias) -> torch.Tensor:
        """Plain attention with every head's keys and values expanded from
        the latents lat [B, Tk, r + dr]: -> [B, Tq, H * dv]."""
        b, tk, _ = lat.shape
        kv = self.kv_b(lat[..., :self.r]).view(b, tk, self.h, self.dn + self.dv)
        k_nope, v = kv.split([self.dn, self.dv], -1)
        k_rope = lat[..., None, self.r:].expand(b, tk, self.h, self.dr)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope], -1)
        o = dot_product_attention(q, k, v, bias, scale=self.scale)
        return o.reshape(*o.shape[:2], self.h * self.dv)

    def absorbed(self, q_nope, q_rope, lat, bias) -> torch.Tensor:
        """One query position per row attending the latents lat [B, Tk, r +
        dr] in latent space: q_nope [B, 1, H, dn] folded through W_kb, the
        scores against the latents in one product, the weighted latents
        mapped through W_vb. bias [B, Tk] or None -> [B, 1, H * dv]."""
        b = q_nope.shape[0]
        w = self.kv_b.weight.view(self.h, self.dn + self.dv, self.r)
        w_kb, w_vb = w[:, :self.dn], w[:, self.dn:]
        q_lat = torch.einsum("bhd,hdc->bhc", q_nope[:, 0], w_kb)
        qc = torch.cat([q_lat, q_rope[:, 0]], -1)  # [B, H, r + dr]
        s = torch.matmul(qc, lat.transpose(1, 2)).float() * self.scale  # [B, H, Tk]
        if bias is not None:
            s = s + bias[:, None, :]
        p = torch.softmax(s, -1).to(lat.dtype)
        o_lat = torch.matmul(p, lat[..., :self.r])  # [B, H, r]
        o = torch.einsum("bhc,hdc->bhd", o_lat, w_vb)
        return o.reshape(b, 1, self.h * self.dv)


class Block(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, layer: int, mk: _Params):
        super().__init__()
        d = cfg.hidden_size
        self.attn_norm = RMSNorm(d, cfg.rms_norm_eps, mk)
        self.attn = MLA(cfg, mk)
        self.mlp_norm = RMSNorm(d, cfg.rms_norm_eps, mk)
        self.mlp = (SwiGLU(d, cfg.intermediate_size, mk) if layer < cfg.first_k_dense_replace
                    else MoE(cfg, mk))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
        """The whole block without a cache; x is the f32 residual stream."""
        dtype = self.attn_norm.weight.dtype
        q_nope, q_rope, lat = self.attn.project(self.attn_norm(x).to(dtype), rot)
        x = x + self.attn.o_proj(self.attn.expanded(q_nope, q_rope, lat, bias)).float()
        return x + self.mlp(self.mlp_norm(x)).float()


class DeepseekV3(nn.Module):
    """DeepSeek-V3's decoder with the engine's LM protocol (lm/registry.py).

    Initialisation: N(0, 0.02) weights (the embedding and the head too),
    unit RMSNorm gains and a zero router bias, drawn from `seed`."""

    chunked_forward = False  # one position per row after the prefill
    # decode_step_ring takes the ring index as a device tensor and reads no
    # value on the host: the serving engine captures it as a CUDA graph
    graph_safe_ring_step = True

    def __init__(self, cfg: DeepseekV3Config, *, device="cuda", dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        if cfg.q_lora_rank is not None or cfg.n_group != 1:
            raise ValueError("the port runs DeepSeek-V3 with q_lora_rank None and n_group 1 "
                             "(Moonlight's settings)")
        self.cfg = cfg
        mk = _Params(seed, device, dtype)
        self.embed = mk.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Block(cfg, i, mk) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, mk)
        self.head = Linear(cfg.hidden_size, cfg.vocab_size, mk)

    # --- the lm/registry protocol -------------------------------------------------

    def log_experts(self, capacity: int) -> X.ExpertLog:
        """Have every MoE layer append each call's expert-token counts to
        one device log of `capacity` calls (before the engine captures its
        graph step, for the replays to write it too); returns the log."""
        log = X.ExpertLog(capacity, self.cfg.n_routed_experts, self.embed.device)
        for block in self.layers:
            if isinstance(block.mlp, MoE):
                block.mlp.log = log
        return log

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.embed, tokens)

    def embedding_size(self) -> int:
        return self.cfg.hidden_size

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head over the final norm of the f32 residual x, in the model's
        dtype."""
        return self.head(self.norm(x).to(self.embed.dtype))

    def _rope(self, positions: torch.Tensor) -> torch.Tensor:
        return rope_rotation(positions, self.cfg.qk_rope_head_dim, self.cfg.rope_theta)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                logits_slice: Optional[Tuple[int, int]] = None,
                remat: bool = False) -> torch.Tensor:
        """Full forward -> logits [B, T, V]; logits_slice and remat as
        GPT2.forward's."""
        _, t, _ = inputs_embeds.shape
        x = inputs_embeds.float()
        rot = self._rope(torch.arange(t, device=x.device))[None]
        bias = causal_bias(t, t, device=x.device)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        for block in self.layers:
            x = remat_call(block, x, bias, rot) if remat else block(x, bias, rot)
        if logits_slice is not None:
            x = x[:, logits_slice[0]: logits_slice[1]]
        return self.logits(x)

    def init_cache(self, batch: int, max_len: int, dtype=None) -> LatentCache:
        """A fresh latent cache: zeros [L, batch, max_len, r + dr], index 0."""
        cfg = self.cfg
        shape = (cfg.num_hidden_layers, batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        return LatentCache(torch.zeros(shape, dtype=dtype or self.embed.dtype,
                                       device=self.embed.device), 0)

    def _forward_cached(self, inputs_embeds: torch.Tensor, cache: LatentCache,
                        full_logits: bool,
                        ring: Optional[tuple] = None
                        ) -> Tuple[torch.Tensor, LatentCache]:
        """A fresh prefill (index 0, expanded attention over its own
        latents), or one decode position per row (absorbed attention over
        the cache), in ring mode (pos, start, index) at each row's own
        position, written at the host's `cache.index` or, given `index`, at
        the device's."""
        b, t, _ = inputs_embeds.shape
        idx, a_len = cache.index, cache.kv.shape[2]
        dev = inputs_embeds.device
        if ring is not None:
            if t != 1:
                raise ValueError("ring mode is decode-only (t == 1)")
            pos, start, index = ring
            # bias [B, maxT]; a device index places the write and the window on the card
            wslot, bias = ring_layout(idx if index is None else index, a_len, start)
            rot = self._rope(pos[:, None])  # [B, 1, dr/2]: each row at its own position
            end = a_len
        else:
            if idx + t > a_len:
                raise ValueError(f"cache of {a_len} positions cannot take {idx + t}")
            if idx and t != 1:
                raise ValueError("a cached continuation takes one position per row")
            wslot, end, bias = idx, idx + t, None
            rot = self._rope(torch.arange(idx, idx + t, device=dev)[None])
        x, dtype = inputs_embeds.float(), self.embed.dtype
        for layer, block in enumerate(self.layers):
            q_nope, q_rope, lat = block.attn.project(block.attn_norm(x).to(dtype), rot)
            if isinstance(wslot, torch.Tensor):
                cache.kv[layer].index_copy_(1, wslot.reshape(1), lat.to(cache.kv.dtype))
            else:
                cache.kv[layer, :, wslot: wslot + t] = lat.to(cache.kv.dtype)
            if idx == 0 and ring is None:
                o = block.attn.expanded(q_nope, q_rope, lat, causal_bias(t, t, device=dev))
            else:
                o = block.attn.absorbed(q_nope, q_rope, cache.kv[layer, :, :end], bias)
            x = x + block.attn.o_proj(o).float()
            x = x + block.mlp(block.mlp_norm(x)).float()
        if not full_logits:
            x = x[:, -1:]
        return self.logits(x), LatentCache(cache.kv, idx + t)

    def prefill(self, inputs_embeds: torch.Tensor, cache: LatentCache,
                full_logits: bool = False) -> Tuple[torch.Tensor, LatentCache]:
        """Encode the prompt into a FRESH cache (index 0): logits [B, 1, V]
        (every position with full_logits) and the cache."""
        if cache.index != 0:
            raise ValueError("prefill needs a fresh cache (index 0)")
        return self._forward_cached(inputs_embeds, cache, full_logits=full_logits)

    def decode_step(self, token_embed: torch.Tensor,
                    cache: LatentCache) -> Tuple[torch.Tensor, LatentCache]:
        logits, cache = self._forward_cached(token_embed, cache, full_logits=False)
        return logits[:, -1], cache

    def decode_step_ring(self, token_embed: torch.Tensor, cache: LatentCache,
                         pos: torch.Tensor, start: torch.Tensor,
                         index: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, LatentCache]:
        """Ring-cache decode step (GPT2Int8.decode_step_ring's contract),
        rotary at each row's logical position pos[b]; `index`, the graph
        step's 0-d device ring index, stands in for cache.index."""
        logits, cache = self._forward_cached(token_embed, cache, full_logits=False,
                                             ring=(pos, start, index))
        return logits[:, -1], cache

    @staticmethod
    def scatter_refill(cache: LatentCache, small: LatentCache, q: int) -> LatentCache:
        """A freshly prefilled R-row cache written IN PLACE into the ring rows
        [q, q+R) at the window's ring slots."""
        rp = refill_positions(cache.index, small.kv.shape[2], cache.kv.shape[2],
                              cache.kv.device)
        paste_rows(cache.kv, small.kv, q, rp, time_axis=2)
        return cache


# --- the registry's converters ----------------------------------------------------------
#
# The JAX package has no DeepSeek-V3, so a checkpoint's "lm" tree is the
# port's state dict nested at its dots (train/checkpoints.py stores trees).


def quantize_params(lm: DeepseekV3):
    raise NotImplementedError("int8 decode of DeepSeek-V3 is not implemented: it decodes in "
                              "the model's dtype (bf16)")


def params_tree(sd: dict, layers: Optional[int] = None) -> dict:
    """The port's state dict -> a tree nested at the dots of its names."""
    tree: dict = {}
    for name, value in sd.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def tree_state_dict(tree, prefix: str = "") -> dict:
    """Inverse of params_tree (a checkpoint may read the numbered layers
    back as a list)."""
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for key, value in items:
        if isinstance(value, (dict, list, tuple)):
            out.update(tree_state_dict(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def from_hf_state_dict(hf: dict, cfg: DeepseekV3Config) -> dict:
    """A HF DeepseekV3ForCausalLM state dict -> the port's names: gate and up
    stacked as [gate | up] rows, the routed experts stacked on a leading
    [E] axis. The rotary columns keep their published order (see the
    module docstring). Takes numpy arrays or tensors."""
    import numpy as np

    def cat(*names):
        return np.concatenate([np.asarray(hf[n]) for n in names], 0)

    sd = {"embed": np.asarray(hf["model.embed_tokens.weight"]),
          "norm.weight": np.asarray(hf["model.norm.weight"]),
          "head.weight": np.asarray(hf["lm_head.weight"])}
    attn = {"q_proj": "q_proj", "kv_a": "kv_a_proj_with_mqa", "kv_b": "kv_b_proj",
            "o_proj": "o_proj"}
    for i in range(cfg.num_hidden_layers):
        src, dst = f"model.layers.{i}.", f"layers.{i}."
        sd[dst + "attn_norm.weight"] = np.asarray(hf[src + "input_layernorm.weight"])
        sd[dst + "mlp_norm.weight"] = np.asarray(hf[src + "post_attention_layernorm.weight"])
        sd[dst + "attn.kv_norm.weight"] = np.asarray(hf[src + "self_attn.kv_a_layernorm.weight"])
        for ours, theirs in attn.items():
            sd[f"{dst}attn.{ours}.weight"] = np.asarray(hf[f"{src}self_attn.{theirs}.weight"])
        m = src + "mlp."
        if i < cfg.first_k_dense_replace:
            sd[dst + "mlp.gate_up.weight"] = cat(m + "gate_proj.weight", m + "up_proj.weight")
            sd[dst + "mlp.down.weight"] = np.asarray(hf[m + "down_proj.weight"])
            continue
        sd[dst + "mlp.router.weight"] = np.asarray(hf[m + "gate.weight"])
        sd[dst + "mlp.router_bias"] = np.asarray(hf[m + "gate.e_score_correction_bias"])
        e = [f"{m}experts.{j}." for j in range(cfg.n_routed_experts)]
        sd[dst + "mlp.experts.gate_up"] = np.stack(
            [cat(x + "gate_proj.weight", x + "up_proj.weight") for x in e])
        sd[dst + "mlp.experts.down"] = np.stack([np.asarray(hf[x + "down_proj.weight"])
                                                 for x in e])
        s = m + "shared_experts."
        sd[dst + "mlp.shared.gate_up.weight"] = cat(s + "gate_proj.weight", s + "up_proj.weight")
        sd[dst + "mlp.shared.down.weight"] = np.asarray(hf[s + "down_proj.weight"])
    return sd
