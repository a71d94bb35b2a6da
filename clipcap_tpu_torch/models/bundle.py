"""CaptionerBundle: the runtime handle tying model, configs and tokenizer
(port of clipcap_tpu/models/bundle.py: encode_image, project_prefix,
prefix_from_pixels, embed_text, forward, enable_tensor_parallel,
enable_data_parallel_decode, enable_int8_decode, lm_decode,
make_serving_engine).

The JAX bundle's params dict becomes a `Captioner` module. The bundle
runs on `device`, the card unless asked for the CPU; the model must lie
there. Each submodule computes in its own dtype: pixels and features are
cast to the encoder's and the mapper's (a bf16 checkpoint computes in
bf16 from the pixels on; JAX promotes f32 pixels against bf16 weights to
f32 instead, so there the encoder and the mapper of a bf16 checkpoint run
in f32).

Multi-card decode runs one process per card (torchrun), each holding a
bundle: `enable_data_parallel_decode()` splits every decode batch over the
`data` axis, `enable_tensor_parallel(M)` shards GPT-J's heads over `model`.
Both install `cache_constraint`, which the samplers, beam search and
serving hand to the decode loops, and `tp_mesh`; every rank gets the whole
batch and returns the whole result (parallel/dp.py, parallel/tp.py).

`enable_int8_decode()` quantizes the LM once and switches only the decode
surface, `lm_decode`, which the samplers, beam search, serving and the
CLIP-guided tree drive; `forward`, the loss and `embed_text` keep the float
LM, as in JAX. The int8 module holds its own weights, so there is no
separate `lm_decode_params`.

With a tracer active (utils/profiling.py), `create`, `enable_int8_decode`,
`prefix_from_pixels` and `project_prefix` record the call-stack spans
`bundle.create`, `bundle.int8_quantize`, `bundle.encode` and `bundle.map`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core.config import CaptionerConfig, ViTConfig
from ..utils import profiling as P
from .captioner import Captioner


@dataclasses.dataclass
class CaptionerBundle:
    model: Captioner  # .mapper, .lm and, when encoding pixels, .visual
    cap_cfg: CaptionerConfig
    lm_cfg: Any
    tokenizer: Any
    vit_cfg: Optional[ViTConfig] = None  # config of model.visual if present
    device: str = "cuda"
    _int8_lm: Any = dataclasses.field(default=None, init=False, repr=False)
    # multi-card decode hooks (set by enable_tensor_parallel /
    # enable_data_parallel_decode)
    cache_constraint: Any = dataclasses.field(default=None, init=False, repr=False)
    tp_mesh: Any = dataclasses.field(default=None, init=False, repr=False)
    _decode_sharding: Optional[str] = dataclasses.field(default=None, init=False,
                                                        repr=False)  # None | "tp" | "dp"

    def __post_init__(self):
        where = {p.device.type for p in self.model.parameters()}
        if where != {torch.device(self.device).type}:
            raise ValueError(f"model parameters on {sorted(where)}, bundle asked for "
                             f"{self.device}")

    @classmethod
    @P.traced("bundle.create")
    def create(cls, cap_cfg: CaptionerConfig, lm_cfg, tokenizer,
               vit_cfg: Optional[ViTConfig] = None, *, seed: int = 0, device: str = "cuda",
               dtype=torch.float32) -> "CaptionerBundle":
        """A bundle of freshly initialised weights, drawn from `seed` on `device`."""
        model = Captioner(cap_cfg, lm_cfg, vit_cfg=vit_cfg, device=device, dtype=dtype,
                          seed=seed)
        return cls(model, cap_cfg, lm_cfg, tokenizer, vit_cfg=vit_cfg, device=device)

    @property
    def lm(self):
        return self.model.lm

    # --- multi-card -----------------------------------------------------------------

    def _mesh(self, data: int, model: int):
        from ..core.mesh import MeshSpec, make_mesh

        return make_mesh(MeshSpec(data=data, model=model),
                         device_type=torch.device(self.device).type)

    def enable_tensor_parallel(self, model_parallel: int, data_parallel: Optional[int] = None):
        """Shard the LM for tensor-parallel KV-cached decode: a (data, model)
        mesh over the world (data = world // model_parallel unless given),
        GPT-J's heads and MLP width split over `model` (parallel/tp.py), and
        the cache_constraint hook that keeps each decode batch's rows on
        their data rank. Returns the mesh."""
        from ..core.mesh import init_distributed
        from ..lm.registry import normalize_lm_type
        from ..parallel.tp import gptj_decode_shardings

        if normalize_lm_type(self.cap_cfg.lm_type) != "gptj":
            raise ValueError("tensor-parallel decode is implemented for GPT-J (heads and MLP "
                             "widths divide the model axis); GPT2-XL's 25 heads do not split "
                             "— use data parallelism (see PARITY.md)")
        if self._int8_lm is not None:
            raise ValueError("int8 decode and tensor-parallel decode are mutually exclusive "
                             "(the TP shardings describe the bf16 layout)")
        if self._decode_sharding is not None:
            raise ValueError(f"{self._decode_sharding} decode sharding already enabled")
        _, world = init_distributed(self.device)
        dp = data_parallel or max(1, world // model_parallel)
        mesh = self._mesh(dp, model_parallel)
        sh = gptj_decode_shardings(mesh, self.model.lm)
        self.model.lm.shard_heads(sh.model_group)
        self.cache_constraint = sh.constrain_cache
        self.tp_mesh = mesh
        self._decode_sharding = "tp"
        return mesh

    def enable_data_parallel_decode(self, data_parallel: Optional[int] = None):
        """Shard decode over the batch axis: the weights on every rank, each
        decode batch's rows and KV cache split over `data` (parallel/dp.py),
        the multi-card scale-out for GPT-2 (whose 25 heads do not split
        tensor-parallel). Composes with enable_int8_decode (the int8 caches'
        scale slabs shard like k/v); excludes tensor-parallel decode.
        Returns the mesh."""
        from ..core.mesh import init_distributed
        from ..parallel.dp import dp_decode_shardings

        if self._decode_sharding is not None:
            raise ValueError(f"{self._decode_sharding} decode sharding already enabled")
        _, world = init_distributed(self.device)
        mesh = self._mesh(data_parallel or world, 1)
        self.cache_constraint = dp_decode_shardings(mesh).constrain_cache
        self.tp_mesh = mesh
        self._decode_sharding = "dp"
        return mesh

    @P.traced("bundle.int8_quantize")
    def enable_int8_decode(self) -> "CaptionerBundle":
        """Quantize the LM once for int8 decode (the family's quantize_params:
        models/gpt2, models/gptj or models/t5): int8 weights with
        per-output-channel scales, and an int8 KV cache for GPT-2 and GPT-J
        (T5's stays float, as in JAX; int8 is what fits T0-11B's 22 GB of
        bf16 weights in 11.6 GB). Only `lm_decode` switches. Greedy tokens
        can differ from the float path at quantization boundaries."""
        from ..lm.registry import family

        if self._decode_sharding == "tp":
            raise ValueError("int8 decode and tensor-parallel decode are mutually exclusive "
                             "(the TP shardings describe the bf16 layout)")
        self._int8_lm = family(self.cap_cfg.lm_type).quantize_params(self.model.lm)
        return self

    @property
    def lm_decode(self):
        """The LM module decode paths drive: int8 once enabled."""
        return self._int8_lm if self._int8_lm is not None else self.model.lm

    def make_serving_engine(self, settings, slots: int = 256, **kw):
        """Continuous-batching engine over this bundle's decode LM, on the
        bundle's device. Drive it with `eng.serve(requests,
        prefix_pool=...)`, where the pool rows are project_prefix outputs.
        The activation dtype defaults to the decode LM's embedding table's
        (wte, T5's shared or DeepSeek-V3's embed): bf16 for the int8 GPT-2;
        the float model's for the int8 GPT-J and T5, which keep the table
        as JAX's quantize_params does."""
        from ..decode.serving import ServingEngine

        lm = self.lm_decode
        table = next(getattr(lm, n) for n in ("wte", "shared", "embed") if hasattr(lm, n))
        kw.setdefault("dtype", table.dtype)
        kw.setdefault("device", self.device)
        kw.setdefault("cache_constraint", self.cache_constraint)
        return ServingEngine(self.lm_decode, self.lm_cfg,
                             prefix_len=self.cap_cfg.mapper.prefix_length,
                             settings=settings, slots=slots, **kw)

    # --- visual ------------------------------------------------------------------

    @torch.no_grad()
    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> visual features (BLIP tokens or CLIP features)."""
        if self.model.visual is None or self.vit_cfg is None:
            raise ValueError("bundle has no visual encoder (precomputed-prefix mode)")
        mode = "tokens" if self.vit_cfg.style == "blip" else (
            "tokens_proj" if self.cap_cfg.mapper.use_all_features else "pooled")
        visual = self.model.visual
        return visual(pixels.to(self.device, visual.cls.dtype), output=mode)

    # --- mapper / LM ---------------------------------------------------------------

    @P.traced("bundle.map")
    @torch.no_grad()
    def project_prefix(self, visual_features: torch.Tensor) -> torch.Tensor:
        return self.model.project_prefix(visual_features.to(self.device))

    @P.traced("bundle.encode")
    def prefix_from_pixels(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.project_prefix(self.encode_image(pixels))

    @torch.no_grad()
    def embed_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.model.lm.embed_tokens(tokens.to(self.device))

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, prefix: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Captioner.forward on the bundle's device: logits [B, P+T, V]."""
        return self.model(tokens.to(self.device), prefix.to(self.device),
                          None if mask is None else mask.to(self.device))
