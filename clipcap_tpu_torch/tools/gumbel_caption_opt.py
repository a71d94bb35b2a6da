"""Gumbel-softmax caption optimization against BLIP-ITC similarity (port of
clipcap_tpu/tools/gumbel_caption_opt.py; the reference's blip_test.py
experiment, :40-209).

A caption is a trainable logits matrix [T, V]. Each step samples soft
one-hots with the straight-through Gumbel-softmax at an annealed
temperature (1.0 -> 0.001), embeds them through the BLIP text encoder
between a fixed [CLS] and [SEP], and takes an Adam step that raises the
ITC cosine between caption and image. Torch autograd takes the place of
JAX's jitted value_and_grad; the Adam update is train/optim.py's, in
optax's order of operations (optax.adam = adamw with no weight decay), not
torch.optim.Adam's. The initial logits and each step's Gumbel noise come
from a generator seeded with `seed`, so the port's draws differ from
jax.random's; tests inject both.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.sampling import gumbel_like
from ..train.optim import AdamW


def _soft_text_hidden(text, soft_onehot: torch.Tensor) -> torch.Tensor:
    """The text-only BLIP encoder (models.blip_text.BlipText) over soft
    token mixtures [B, T, V]: hidden states [B, T, D]."""
    t = soft_onehot.shape[1]
    x = soft_onehot @ text.word_embeddings + text.position_embeddings[None, :t]
    x = text.emb_ln(x)
    for blk in text.blocks:
        x = blk.mlp(blk.self_attn(x, x, None))
    return x


def gumbel_softmax(logits: torch.Tensor, tau: float, hard: bool = True,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """softmax((logits + g) / tau) with g ~ Gumbel (`noise`, or drawn from
    `generator`); hard: the one-hot of its argmax in the forward pass and
    the soft sample's gradient in the backward (straight-through)."""
    g = gumbel_like(logits, generator) if noise is None else noise
    y = torch.softmax((logits + g) / tau, dim=-1)
    if hard:
        y_hard = F.one_hot(torch.argmax(y, dim=-1), logits.shape[-1]).to(y.dtype)
        y = y_hard + y - y.detach()
    return y


def image_feature(retrieval, image_embeds: torch.Tensor) -> torch.Tensor:
    """The L2-normalized ITC image feature of ViT tokens [1, Tv, D]."""
    with torch.no_grad():
        img = retrieval["vision_proj"](image_embeds[:, 0])
        return img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)


def caption_itc(retrieval, img_feat: torch.Tensor, soft: torch.Tensor, cls: int,
                sep: int) -> torch.Tensor:
    """The ITC cosine of soft caption tokens [1, T, V] in a fixed
    [CLS] ... [SEP] frame against the image feature; a scalar."""
    vocab = soft.shape[-1]

    def one_hot(i):
        return F.one_hot(torch.full((1, 1), i, device=soft.device), vocab).to(soft.dtype)

    frame = torch.cat([one_hot(cls), soft, one_hot(sep)], dim=1)
    hidden = _soft_text_hidden(retrieval["text"], frame)
    txt = retrieval["text_proj"](hidden[:, 0])
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    return (img_feat * txt).sum()


def gumbel_step(retrieval, img_feat: torch.Tensor, logits: torch.Tensor, opt: AdamW, state,
                noise: torch.Tensor, tau: float, cls: int, sep: int):
    """One step: the ITC of a straight-through Gumbel sample of `logits`
    with `noise`, its gradient, and the Adam update of `logits` IN PLACE.
    Returns (itc, gradient, optimizer state)."""
    lg = logits.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = -caption_itc(retrieval, img_feat, gumbel_softmax(lg, tau, noise=noise), cls, sep)
        (grad,) = torch.autograd.grad(loss, lg)
    with torch.no_grad():
        state = opt.update([grad], state, [logits])
    return -loss.detach(), grad, state


def optimize_caption(
    retrieval,  # models.blip_retrieval.BlipRetrieval (or its mapping of modules)
    text_cfg,
    image_embeds: torch.Tensor,  # [1, Tv, D] from blip_retrieval.encode_image
    tokenizer,
    caption_length: int = 12,
    steps: int = 5000,
    lr: float = 0.1,
    tau_start: float = 1.0,
    tau_end: float = 0.001,
    seed: int = 0,
    log_every: int = 500,
    init_logits: Optional[torch.Tensor] = None,  # [1, T, V]
    gumbel_noise: Optional[torch.Tensor] = None,  # [steps, 1, T, V]
    device="cuda",
) -> dict:
    """Returns {"caption": str, "tokens": list[int], "itc": float}, the ITC
    of the last step's sample. Runs on `device`, the card unless asked for
    the CPU; the retrieval model and the image tokens must lie there."""
    dev = torch.device(device)
    if image_embeds.device.type != dev.type:
        raise ValueError(f"image tokens on {image_embeds.device}, asked for {dev}")
    vocab = text_cfg.vocab_size
    img_feat = image_feature(retrieval, image_embeds)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if init_logits is None:
        logits = 0.01 * torch.randn((1, caption_length, vocab), generator=gen, device=dev)
    else:
        logits = init_logits.to(device=dev, dtype=torch.float32).clone()
    opt = AdamW(lambda count: lr, 0.0, ["logits"])
    state = opt.init([logits])
    cls, sep = tokenizer.cls_token_id, tokenizer.sep_token_id

    sim = torch.zeros((), device=dev)
    for i in range(steps):
        tau = tau_start * (tau_end / tau_start) ** (i / max(steps - 1, 1))
        noise = gumbel_like(logits, gen) if gumbel_noise is None else gumbel_noise[i].to(dev)
        sim, _, state = gumbel_step(retrieval, img_feat, logits, opt, state, noise, tau, cls,
                                    sep)
        if log_every and (i % log_every == 0 or i == steps - 1):
            ids = torch.argmax(logits[0], dim=-1).tolist()
            print(f"step {i}: itc={float(sim):.4f} tau={tau:.4f} "
                  f"caption={tokenizer.decode(ids)!r}")

    ids = torch.argmax(logits[0], dim=-1).tolist()
    return {"caption": tokenizer.decode(ids), "tokens": ids, "itc": float(sim)}
