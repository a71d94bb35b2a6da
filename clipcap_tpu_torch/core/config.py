"""Configuration dataclasses of the captioning main path.

The port's own copies of `MapperConfig`, `GPT2Config`, `GPTJConfig`,
`T5Config`, `ViTConfig`, `CLIPTextConfig`, `BlipTextConfig`, `CaptionerConfig`
and `TrainConfig` from
clipcap_tpu/core/config.py, with the same fields,
defaults and JSON round trip (a test holds the two in step). The port keeps
its own copies because the JAX package's `core/__init__.py` imports JAX.

`DeepseekV3Config` is the port's own: the JAX package has no DeepSeek-V3
LM, so there is no copy to hold it against.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


class _JsonMixin:
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class MapperConfig(_JsonMixin):
    """The prefix mapping network (reference layers/Transformer.py:133-203)."""

    dim_clip: int = 512  # width of the visual embedding fed in
    dim_embedding: int = 768  # LM embedding width (output)
    prefix_length: int = 10  # learned-constant query count == output length
    clip_length: int = 10  # pseudo-token count (pooled mode) / ViT seq len
    num_layers: int = 8
    num_heads: int = 8
    mlp_ratio: float = 4.0
    prefix_init_std: float = 1.0
    act_fn: str = "relu"  # relu | elu | gelu | selu | geglu
    use_all_features: bool = False  # TransformerMapperAllFeatures semantics
    use_pos_embeddings: bool = False  # only meaningful with use_all_features


@dataclasses.dataclass(frozen=True)
class GPT2Config(_JsonMixin):
    """GPT-2 family (learned positions, pre-LN, tied lm_head)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5

    @classmethod
    def variant(cls, name: str) -> "GPT2Config":
        table = {
            "gpt2": dict(n_embd=768, n_layer=12, n_head=12),
            "gpt2-medium": dict(n_embd=1024, n_layer=24, n_head=16),
            "gpt2-large": dict(n_embd=1280, n_layer=36, n_head=20),
            "gpt2-xl": dict(n_embd=1600, n_layer=48, n_head=25),
        }
        if name not in table:
            raise ValueError(f"unknown GPT-2 variant {name!r}")
        return cls(**table[name])


@dataclasses.dataclass(frozen=True)
class GPTJConfig(_JsonMixin):
    """GPT-J family (rotary embeddings, parallel attention+MLP residual)."""

    vocab_size: int = 50400
    n_positions: int = 2048
    n_embd: int = 4096
    n_layer: int = 28
    n_head: int = 16
    rotary_dim: int = 64
    layer_norm_epsilon: float = 1e-5

    @classmethod
    def variant(cls, name: str) -> "GPTJConfig":
        if name in ("EleutherAI/gpt-j-6B", "gpt-j-6B", "gptj"):
            return cls()
        raise ValueError(f"unknown GPT-J variant {name!r}")


@dataclasses.dataclass(frozen=True)
class T5Config(_JsonMixin):
    """T5/T0 family (encoder-decoder, RMSNorm, relative position buckets)."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" (t5) or "gated-gelu" (t5 v1.1 / T0)
    tie_word_embeddings: bool = True

    @classmethod
    def variant(cls, name: str) -> "T5Config":
        """HF presets. "t0-11b" is bigscience/T0, the T5 v1.1 XXL geometry
        (gated-gelu, untied lm_head, 4096/10240, 64 heads), ~11B
        parameters: the reference's T0 decoder family (lms/T0.py)."""
        presets = {
            "t5-small": dict(),
            "t5-base": dict(d_model=768, d_ff=3072, num_layers=12,
                            num_decoder_layers=12, num_heads=12),
            "t5-large": dict(d_model=1024, d_ff=4096, num_layers=24,
                             num_decoder_layers=24, num_heads=16),
            "t0-11b": dict(d_model=4096, d_ff=10240, num_layers=24,
                           num_decoder_layers=24, num_heads=64,
                           feed_forward_proj="gated-gelu",
                           tie_word_embeddings=False),
        }
        if name not in presets:
            raise ValueError(f"unknown T5 variant {name!r}")
        return cls(**presets[name])


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config(_JsonMixin):
    """DeepSeek-V3's decoder (arXiv:2412.19437; HF `model_type`
    "deepseek_v3"), under its config.json names: multi-head latent
    attention, a few leading dense SwiGLU layers, then sigmoid-routed
    experts with shared experts. The defaults are Moonlight-16B-A3B's
    (huggingface.co/moonshotai/Moonlight-16B-A3B, config.json). The port
    runs `q_lora_rank` None (a plain query projection), `n_group` 1 and
    no rope scaling, as that config has them."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264  # the dense layers' SwiGLU width
    moe_intermediate_size: int = 1408  # each routed expert's SwiGLU width
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2  # one SwiGLU of n_shared * moe_intermediate_size
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    max_position_embeddings: int = 8192

    @classmethod
    def variant(cls, name: str) -> "DeepseekV3Config":
        if name in ("moonshotai/Moonlight-16B-A3B", "Moonlight-16B-A3B", "moonlight",
                    "deepseek_v3"):
            return cls()
        raise ValueError(f"unknown DeepSeek-V3 variant {name!r}")


@dataclasses.dataclass(frozen=True)
class ViTConfig(_JsonMixin):
    """Vision transformer config, CLIP style ("clip") or BLIP/timm style ("blip")."""

    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    output_dim: Optional[int] = 512  # projection width (CLIP only)
    style: str = "clip"  # "clip" | "blip"
    layer_norm_epsilon: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1

    @classmethod
    def clip_variant(cls, name: str) -> "ViTConfig":
        table = {
            "ViT-B/32": dict(image_size=224, patch_size=32, width=768, layers=12,
                             heads=12, output_dim=512),
            "ViT-B/16": dict(image_size=224, patch_size=16, width=768, layers=12,
                             heads=12, output_dim=512),
            "ViT-L/14": dict(image_size=224, patch_size=14, width=1024, layers=24,
                             heads=16, output_dim=768),
            "ViT-L/14@336px": dict(image_size=336, patch_size=14, width=1024,
                                   layers=24, heads=16, output_dim=768),
        }
        if name not in table:
            raise ValueError(f"unknown CLIP ViT variant {name!r}")
        return cls(style="clip", **table[name])

    @classmethod
    def blip_variant(cls, name: str, image_size: int = 384) -> "ViTConfig":
        table = {
            "ViT-B": dict(patch_size=16, width=768, layers=12, heads=12),
            "ViT-L": dict(patch_size=16, width=1024, layers=24, heads=16),
        }
        if name not in table:
            raise ValueError(f"unknown BLIP ViT variant {name!r}")
        return cls(style="blip", image_size=image_size, output_dim=None,
                   layer_norm_epsilon=1e-6, **table[name])


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig(_JsonMixin):
    """CLIP text tower (causal transformer, eot-pooled projection)."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    output_dim: int = 512
    layer_norm_epsilon: float = 1e-5


@dataclasses.dataclass(frozen=True)
class BlipTextConfig(_JsonMixin):
    """BLIP's BERT-style text decoder/encoder with cross-attention: Gen-B
    caption sampling (reference sampling.py:166-279) and ITM/ITC ranking
    (reference sampling.py:40-62)."""

    vocab_size: int = 30524  # bert-base + [DEC]/[ENC] special tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 768  # width of the vision features cross-attended to
    layer_norm_epsilon: float = 1e-12
    embed_dim: int = 256  # ITC projection width


@dataclasses.dataclass(frozen=True)
class CaptionerConfig(_JsonMixin):
    """Top-level ClipCap captioner = visual encoder + mapper + LM
    (reference model.py:25-78, train.py:167-189)."""

    lm_type: str = "gpt2"  # gpt2 | gptj | t5/t0 | deepseek_v3/moonlight
    lm_variant: str = "gpt2"
    visual_encoder_type: str = "BLIP"  # BLIP | CLIP | "none" (precomputed prefixes)
    visual_encoder_variant: str = "ViT-B"
    train_visual_encoder: bool = False
    prefix_only: bool = False  # train mapper only, LM frozen
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    normalize_prefix: bool = False

    @classmethod
    def from_dict(cls, d: dict):
        d = dict(d)
        if isinstance(d.get("mapper"), dict):
            d["mapper"] = MapperConfig.from_dict(d["mapper"])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class TrainConfig(_JsonMixin):
    """Training-run knobs (reference train.py:49-96). weight_decay defaults
    to 0.0 here, as in JAX, while cli/train.py and make_optimizer default
    to 0.01."""

    batch_size: int = 16
    epochs: int = 3
    optimizer_lr: float = 2e-5
    weight_decay: float = 0.0
    scheduler_warmup_steps: int = 2000
    total_steps: int = 10000
    autoclip_percentile: float = 10.0
    autoclip_history: int = 50000
    bf16_compute: bool = True  # reference precision=16 (train.py:280) -> bf16
    gradient_clip_val: float = -1.0  # <0 => AutoClip (reference train.py:283)
    accumulate_grad_batches: int = 1
    remat: bool = True  # activation checkpointing (reference train.py:200)
    max_token_length: int = 96
    validation_interval: int = 1000
    limit_val_batches: int = 100
    save_every_epochs: int = 1
    save_every_steps: int = 10000
    seed: int = 42
    mesh_data: int = -1  # -1 => all devices
    mesh_model: int = 1
    zero_shard_params: bool = False  # ZeRO-style param/opt sharding over data axis
    log_every_n_steps: int = 5
