"""Folder inference demo (port of clipcap_tpu/cli/infer.py; the reference's
shutterstock demo, inference.py:401-558).

For a folder of jpg (+ json with `src`/`alt` metadata): encode each image
with the captioner's visual tower, map it to the prefix, caption it by beam
search (default) or the no-beam top-p sweep, score the generated captions
against the original text (BLEU, METEOR, ROUGE-L, CIDEr, SPICE) and write
`{prefix}_shutterstock.json`.

    python -m clipcap_tpu_torch.cli.infer --checkpoint_path CKPT \\
        --tokenizer_vocab_dir VOCAB --folder_path IMAGES \\
        --clip_checkpoint CLIP.pt --clip_merges bpe_simple_vocab_16e6.txt.gz

CKPT is a directory of clipcap_config.json and consolidated.npz
(train/checkpoints.py), with a GPT-2, a GPT-J or a T5/T0 LM (VOCAB holds
T5's `tokenizer.json`). With
`--speculative_draft_checkpoint DRAFT` each image is captioned by
speculative greedy decode, DRAFT's captioner proposing and CKPT's
verifying (beam search off). `folder_demo_pixels` is the part below the file
reading (pixels in, captions and scores out), callable without PIL. All of
it runs on the bundle's device, the card unless `--device cpu`.

`--tensor_parallel N` shards a GPT-J checkpoint's heads over N cards, as
the JAX CLI's `bundle.enable_tensor_parallel(N)`: run one process per card,
`torchrun --nproc_per_node N -m clipcap_tpu_torch.cli.infer ...`. Every
rank captions every image; only global rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

DEFAULT_TOP_P = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]


def _prompt(bundle, prefix_embed: torch.Tensor, text_prefix: Optional[str]) -> torch.Tensor:
    """The prefix embeddings, followed by the embedded text prefix if any."""
    if text_prefix is None:
        return prefix_embed
    toks = torch.tensor([bundle.tokenizer.encode_text(text_prefix)] * prefix_embed.shape[0],
                        device=prefix_embed.device)
    return torch.cat([prefix_embed, bundle.embed_text(toks).to(prefix_embed.dtype)], dim=1)


def _speculative_captions(bundle, draft_bundle, pixels, visual_feats, prompt,
                          text_prefix: Optional[str], **generation_kwargs) -> List[str]:
    """Speculative greedy decode (decode/speculative.py) of one image: the
    draft bundle's own encoder, or the target's features where the draft has
    none and its mapper takes their width, then the draft's own mapper and
    text prefix; "." stops."""
    from ..decode.engine import trim_and_decode
    from ..decode.speculative import speculative_greedy

    if draft_bundle.model.visual is not None:
        d_feats = draft_bundle.encode_image(pixels)
    else:
        # reusing the target's features is only meaningful when the draft's
        # mapper was trained on the same encoder's feature space
        d_dim = draft_bundle.cap_cfg.mapper.dim_clip
        if visual_feats.shape[-1] != d_dim:
            raise ValueError(
                f"draft bundle has no visual encoder and its mapper expects dim_clip={d_dim}, "
                f"but the target's visual features are {visual_feats.shape[-1]}-wide: the draft "
                "needs its own encoder or a mapper trained on the target's feature space")
        d_feats = visual_feats
    d_prompt = _prompt(draft_bundle, draft_bundle.project_prefix(d_feats), text_prefix)
    out = speculative_greedy(bundle.lm_decode, draft_bundle.lm_decode, prompt, d_prompt,
                             max_new_tokens=generation_kwargs.get("entry_length", 67),
                             gamma=generation_kwargs.get("gamma", 4),
                             eos_token_id=bundle.tokenizer.encode_text(".")[0],
                             device=bundle.device,
                             target_cache_constraint=bundle.cache_constraint)
    return trim_and_decode(out, bundle.tokenizer, strip_special=True)


def _captions_from_pixels(bundle, clip_scoring, image_tensor, number_to_generate: int,
                          text_prefix: Optional[str], use_beam_search: bool,
                          draft_bundle=None, **generation_kwargs):
    """demo_generate_captions after the preprocessing: one image's
    [3, S, S] pixels -> (captions, the scorer's image features)."""
    from ..decode.beam import beam_search, best_beam_text
    from ..eval.samplers import NoBeamCaptionSampler

    pixels = torch.as_tensor(np.asarray(image_tensor))[None]
    # the captioner's own visual encoder makes the prefix features
    visual_feats = bundle.encode_image(pixels)
    prompt = _prompt(bundle, bundle.project_prefix(visual_feats), text_prefix)
    if draft_bundle is not None and not use_beam_search:
        captions = _speculative_captions(bundle, draft_bundle, pixels, visual_feats, prompt,
                                         text_prefix, **generation_kwargs)
    elif use_beam_search:
        out = beam_search(bundle.lm_decode, prompt,
                          beam_size=generation_kwargs.get("beam_size", 5),
                          max_new_tokens=generation_kwargs.get("entry_length", 67),
                          stop_token_id=bundle.tokenizer.encode_text(".")[0],
                          device=bundle.device, cache_constraint=bundle.cache_constraint)
        captions = [best_beam_text(out, bundle.tokenizer)]
    else:
        sampler = NoBeamCaptionSampler(
            top_p_values=generation_kwargs.get("top_p_values", DEFAULT_TOP_P),
            device=bundle.device)
        captions = sampler.generate_captions(bundle, prompt, visual_feats, None)
    captions = captions[:number_to_generate] if number_to_generate else captions
    if text_prefix is not None:
        captions = [text_prefix + c for c in captions]
    return captions, clip_scoring.embed_image(image_tensor)


def demo_generate_captions(bundle, clip_scoring, image, number_to_generate: int = 1,
                           text_prefix: Optional[str] = None, use_beam_search: bool = False,
                           draft_bundle=None, **generation_kwargs):
    """Reference inference.py:295-331: preprocess -> encode -> project ->
    beam, no-beam, or (with a draft bundle and no beam) speculative greedy.
    Returns (captions, the scorer's image features)."""
    return _captions_from_pixels(bundle, clip_scoring, clip_scoring.preprocess_image(image),
                                 number_to_generate, text_prefix, use_beam_search,
                                 draft_bundle=draft_bundle, **generation_kwargs)


def caption_pixels(bundle, clip_scoring, pixels, number_to_generate: int = 1,
                   text_prefix: Optional[str] = None, use_beam_search: bool = True,
                   draft_bundle=None, **generation_kwargs) -> List[List[str]]:
    """Captions for each of N preprocessed images ([N, 3, S, S]).

    Beam: images x beams in one beam_search_batched call per chunk of
    `beam_image_batch` images (default 64, which bounds the memory of a
    call and changes no token); each image gets its best beam, as the JAX
    folder demo gives it (no text prefix prepended). No-beam: image by
    image through demo_generate_captions' path, the scorer's encoder
    included; with a draft bundle, by speculative greedy decode."""
    out: List[List[str]] = []
    if use_beam_search:
        from ..decode.beam import beam_search_batched, best_beam_texts

        pixels = torch.as_tensor(np.asarray(pixels))
        chunk = int(generation_kwargs.get("beam_image_batch", 64))
        for lo in range(0, pixels.shape[0], chunk):
            prompt = _prompt(bundle, bundle.prefix_from_pixels(pixels[lo:lo + chunk]), text_prefix)
            res = beam_search_batched(
                bundle.lm_decode, prompt, beam_size=generation_kwargs.get("beam_size", 5),
                max_new_tokens=generation_kwargs.get("entry_length", 67),
                stop_token_id=bundle.tokenizer.encode_text(".")[0], device=bundle.device,
                cache_constraint=bundle.cache_constraint)
            out.extend([t] for t in best_beam_texts(res, bundle.tokenizer))
        return out
    for image_tensor in pixels:
        captions, _ = _captions_from_pixels(bundle, clip_scoring, image_tensor,
                                            number_to_generate, text_prefix, False,
                                            draft_bundle=draft_bundle, **generation_kwargs)
        out.append(captions)
    return out


def folder_demo_pixels(bundle, clip_scoring, pixels, names: Sequence[str], metadata=None,
                       out_filename_prefix: str = "demo_inference", number_to_generate: int = 1,
                       text_prefix: Optional[str] = None, use_beam_search: bool = True,
                       draft_bundle=None, **generation_kwargs) -> dict:
    """folder_demo below the file reading: preprocessed pixels [N, 3, S, S],
    one name (the image's path) and one metadata dict each -> captions,
    per-image and corpus scores of the captions against each metadata's
    `alt` text, written to `{out_filename_prefix}_shutterstock.json` (by
    global rank 0 only, which alone prints, in a multi-process run)."""
    from ..core.mesh import is_writer
    from ..eval.scoring import generate_scores_full

    say = print if is_writer() else (lambda *a, **k: None)

    metadata = list(metadata) if metadata is not None else [{} for _ in names]
    all_captions = caption_pixels(bundle, clip_scoring, pixels,
                                  number_to_generate=number_to_generate,
                                  text_prefix=text_prefix, use_beam_search=use_beam_search,
                                  draft_bundle=draft_bundle, **generation_kwargs)
    sample_data = {}
    scoring_gts, scoring_res, image_id_to_url = {}, {}, {}
    for image_id, (name, meta, captions) in enumerate(zip(names, metadata, all_captions)):
        say(name)
        say(captions)
        url = meta.get("src", str(name))
        original_caption = meta.get("alt", "")
        sample_data[url] = {"original_caption": original_caption,
                            "generated_captions": captions}
        scoring_res[image_id] = [{"caption": original_caption}]
        scoring_gts[image_id] = [{"caption": c} for c in captions]
        image_id_to_url[image_id] = url

    scores, img_scores = generate_scores_full(scoring_gts, scoring_res)
    say("Scores")
    say(scores)
    for img_id, s in img_scores.items():
        sample_data[image_id_to_url[img_id]]["scores"] = s
    if is_writer():
        out_path = f"{out_filename_prefix}_shutterstock.json"
        with open(out_path, "w+") as f:
            json.dump(sample_data, f)
        print(f"wrote {out_path}")
    return sample_data


def folder_demo(bundle, clip_scoring, folder_path: str,
                out_filename_prefix: str = "demo_inference", total_samples: int = 100,
                number_to_generate: int = 1, text_prefix: Optional[str] = None,
                use_beam_search: bool = True, draft_bundle=None, **generation_kwargs) -> dict:
    """Caption and score the first `total_samples` jpgs of a folder (sorted
    by name), each with its optional same-named json metadata."""
    from PIL import Image

    files = sorted(Path(folder_path).glob("*.jpg"))[:total_samples]
    pixels, metadata = [], []
    for image_file in files:
        with Image.open(image_file) as image:
            pixels.append(clip_scoring.preprocess_image(image.convert("RGB")))
        meta_file = image_file.with_suffix(".json")
        metadata.append(json.loads(meta_file.read_text()) if meta_file.exists() else {})
    size = clip_scoring.vit_cfg.image_size
    pixels = np.stack(pixels) if pixels else np.zeros((0, 3, size, size), np.float32)
    return folder_demo_pixels(bundle, clip_scoring, pixels, [str(f) for f in files], metadata,
                              out_filename_prefix=out_filename_prefix,
                              number_to_generate=number_to_generate, text_prefix=text_prefix,
                              use_beam_search=use_beam_search, draft_bundle=draft_bundle,
                              **generation_kwargs)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="caption and score a folder of jpgs")
    p.add_argument("--checkpoint_path", required=True,
                   help="directory of clipcap_config.json and consolidated.npz")
    p.add_argument("--tokenizer_vocab_dir", required=True)
    p.add_argument("--folder_path", required=True, help="folder of jpg(+json)")
    p.add_argument("--clip_model", default="ViT-B/32")
    p.add_argument("--clip_checkpoint", required=True)
    p.add_argument("--clip_merges", required=True)
    p.add_argument("--out_filename_prefix", default="demo_inference")
    p.add_argument("--total_samples", type=int, default=100)
    p.add_argument("--number_to_generate", type=int, default=1)
    p.add_argument("--text_prefix", default=None)
    p.add_argument("--no_beam", action="store_true")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="model-axis size for tensor-parallel GPT-J decode (heads and KV cache "
                        "sharded over this many cards; one torchrun process per card)")
    p.add_argument("--speculative_draft_checkpoint", default=None,
                   help="checkpoint of a small captioner (its own mapper and LM, the same "
                        "tokenizer) used as the speculative-decode draft; implies no-beam "
                        "greedy decoding")
    p.add_argument("--speculative_gamma", type=int, default=4)
    p.add_argument("--int8_decode", action="store_true",
                   help="int8 weight-streaming decode (gpt2/gptj/t5): int8 weights, and an int8 "
                        "KV cache for gpt2/gptj; "
                        "tokens can differ from the float path at quantization boundaries")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    from ..core.mesh import process_group_scope

    args = build_argparser().parse_args(argv)
    with process_group_scope():
        return _main(args)


def _main(args):
    from ..core.mesh import init_distributed, is_writer, launched_world_size, mesh_shape
    from ..eval.clip_scoring import ClipScoring
    from .loading import load_captioner_bundle, load_clip_ranker

    if launched_world_size() > 1:
        init_distributed(args.device)  # each rank on its own card before the weights load
    bundle = load_captioner_bundle(args.checkpoint_path, args.tokenizer_vocab_dir,
                                   device=args.device)
    if args.tensor_parallel > 1:
        mesh = bundle.enable_tensor_parallel(args.tensor_parallel)
        if is_writer():
            print(f"tensor-parallel decode over mesh {mesh_shape(mesh)}")
    if args.int8_decode:
        bundle.enable_int8_decode()
        print("int8 weight-streaming decode enabled")
    draft_bundle = None
    if args.speculative_draft_checkpoint:
        if args.int8_decode:
            # the int8 modules decode one position per row, so verification
            # runs one weight-streaming step per chunk token
            print("warning: --int8_decode makes speculative verification fall back to "
                  "per-token forwards; expect no speedup over plain int8 greedy")
        draft_bundle = load_captioner_bundle(args.speculative_draft_checkpoint,
                                             args.tokenizer_vocab_dir, device=args.device)
        print(f"speculative decoding with draft checkpoint {args.speculative_draft_checkpoint} "
              f"(gamma={args.speculative_gamma})")
    ranker = load_clip_ranker(args.clip_model, args.clip_checkpoint, args.clip_merges,
                              device=args.device)
    scoring = ClipScoring(ranker.visual, ranker.text, ranker.tokenizer)
    return folder_demo(bundle, scoring, args.folder_path,
                       out_filename_prefix=args.out_filename_prefix,
                       total_samples=args.total_samples,
                       number_to_generate=args.number_to_generate,
                       text_prefix=args.text_prefix,
                       use_beam_search=not args.no_beam and draft_bundle is None,
                       draft_bundle=draft_bundle, gamma=args.speculative_gamma)


if __name__ == "__main__":
    main()
