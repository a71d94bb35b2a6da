"""caption_me: single-image caption synthesis on the card (port of
clipcap_tpu/cli/caption_me.py; reference caption_me.py:13-138).

BLIP-samples `sample_count` candidates over per-candidate min/max-length
and top_p grids, ranks them by --mode (CLIP-ViT-L+RN50x64 / CLIP-ViT-L /
CLIP-RN50x64 / ITC / ITM) and prints the top n. Every model is built on
--device, the card unless asked for the CPU.

    python -m clipcap_tpu_torch.cli.caption_me IMAGE --blip_checkpoint B.pth \
        --blip_vocab vocab.txt --clip_vit_l_checkpoint ViT-L-14.pt \
        --clip_merges bpe_simple_vocab_16e6.txt.gz --mode CLIP-ViT-L

JAX's behaviours are kept (ROADMAP.md section 3): `main` loads no RN50x64
ranker, so the default mode raises KeyError in SynthesisEngine.rank, and it
builds the BLIP ranker on the captioner's modules, which have no itm_head,
vision_proj or text_proj, so --mode ITM and ITC raise KeyError.
"""

from __future__ import annotations

import argparse

import torch

from ..data.preprocessing import blip_preprocess
from .synthesis import SynthesisEngine, default_grids


def caption_image(
    engine: SynthesisEngine,
    image,  # PIL image
    mode: str = "CLIP-ViT-L+RN50x64",
    sample_count: int = 40,
    top_k: float = 2500,
    typ_p: float = 0.0,
    force_eos_prob: float = 0.9,
    num_runs: int = 1,
    top_n: int = 3,
    seed: int = 42,
    set_top_p=None, set_min_len=None, set_max_len=None,
):
    """Synthesize candidates for one image and rank them: (ranked [(caption,
    score)], every distinct candidate)."""
    top_p, min_len, max_len = default_grids(set_top_p, set_min_len, set_max_len,
                                            n=sample_count)
    pixels = torch.from_numpy(blip_preprocess(image, engine.blip_vit_cfg.image_size))[None]
    captions, _, _ = engine.synthesize(
        pixels, sample_count=sample_count, top_p=top_p, top_k=top_k, typ_p=typ_p,
        min_len=min_len, max_len=max_len, force_eos_prob=force_eos_prob,
        num_runs=num_runs, seed=seed)
    return engine.rank(image, captions, mode=mode, top_n=top_n), captions


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="caption one image on the card (Gen-B synthesis)")
    p.add_argument("image", help="path of the image to caption")
    p.add_argument("--mode", default="CLIP-ViT-L+RN50x64")
    p.add_argument("--sample_count", type=int, default=40)
    p.add_argument("--top_k", type=float, default=2500)
    p.add_argument("--typ_p", type=float, default=0.0)
    p.add_argument("--force_eos_prob", type=float, default=0.9)
    p.add_argument("--num_runs", type=int, default=1)
    p.add_argument("--top_n", type=int, default=3)
    p.add_argument("--manual_seed", type=int, default=42)
    p.add_argument("--set_top_p", type=float, default=None)
    p.add_argument("--set_min_len", type=int, default=None)
    p.add_argument("--set_max_len", type=int, default=None)
    p.add_argument("--int8_decode", action="store_true",
                   help="int8 BLIP text decoder (the rankers keep full precision)")
    # offline model assets
    p.add_argument("--blip_checkpoint", required=True)
    p.add_argument("--blip_vocab", required=True, help="BERT vocab.txt")
    p.add_argument("--blip_vit_variant", default="ViT-L")
    p.add_argument("--clip_vit_l_checkpoint", default=None)
    p.add_argument("--clip_merges", default=None, help="bpe_simple_vocab_16e6.txt[.gz]")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from PIL import Image

    from ..rank.rankers import BLIPRanker
    from .loading import load_blip_captioner, load_clip_ranker

    blip_params, vit_cfg, text_cfg, tokenizer = load_blip_captioner(
        args.blip_checkpoint, args.blip_vocab, vit_variant=args.blip_vit_variant,
        device=args.device)
    clip_rankers = {}
    if args.clip_vit_l_checkpoint:
        clip_rankers["ViT-L/14"] = load_clip_ranker("ViT-L/14", args.clip_vit_l_checkpoint,
                                                    args.clip_merges, device=args.device)
    engine = SynthesisEngine(
        blip_params=blip_params, blip_vit_cfg=vit_cfg, blip_text_cfg=text_cfg,
        tokenizer=tokenizer, clip_rankers=clip_rankers,
        blip_ranker=BLIPRanker(blip_params, vit_cfg, text_cfg, tokenizer))
    if args.int8_decode:
        engine.enable_int8_decode()

    image = Image.open(args.image).convert("RGB")
    ranked, all_captions = caption_image(
        engine, image, mode=args.mode, sample_count=args.sample_count,
        top_k=args.top_k, typ_p=args.typ_p, force_eos_prob=args.force_eos_prob,
        num_runs=args.num_runs, top_n=args.top_n, seed=args.manual_seed,
        set_top_p=args.set_top_p, set_min_len=args.set_min_len,
        set_max_len=args.set_max_len)
    print(f"{len(all_captions)} distinct candidates; top {len(ranked)}:")
    for i, (caption, score) in enumerate(ranked):
        print(f"{i:02d} [{score:.3f}]: {caption}")
    return ranked, all_captions


if __name__ == "__main__":
    main()
