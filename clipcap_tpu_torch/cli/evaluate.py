"""Checkpoint evaluation (port of clipcap_tpu/cli/evaluate.py; the
reference's evaluate_model.py:538-676).

Load a trained captioner checkpoint and a CLIP model, run the COCO
validator with the no-beam sweep (top-p 0.1 and 0.2) and the CLIP-guided
sampler (branching 2, look-ahead 4) over --max_samples validation images
in chunks of --eval_batch_size, and print the JSON of scores: the caption
metrics per sampler, the validation CE loss and the mean CLIP score.

    python -m clipcap_tpu_torch.cli.evaluate --checkpoint_path CKPT \\
        --tokenizer_vocab_dir VOCAB --clip_checkpoint CLIP.pt \\
        --clip_merges bpe_simple_vocab_16e6.txt.gz \\
        --valid_json_path captions_val2014.json --image_folder_path val2014

CKPT is a directory of clipcap_config.json and consolidated.npz
(train/checkpoints.py), f32 or bf16, with a GPT-2 or a GPT-J LM; VOCAB
holds its LM's BPE files. Everything runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json


def build_validator(bundle, clip_scoring, dataset, nobeam_top_p=(0.1, 0.2),
                    branching_factor: int = 2, look_ahead: int = 4, preprocess=None):
    """The COCO validator that `evaluate` runs: the no-beam sweep and the
    CLIP-guided sampler on the bundle's device, and the CLIP scorer."""
    from ..data.preprocessing import blip_preprocess, clip_preprocess
    from ..eval.samplers import ClipGuidedCaptionSampler, NoBeamCaptionSampler
    from ..eval.validator import CocoCaptionValidator

    if preprocess is None:
        size = bundle.vit_cfg.image_size
        if bundle.vit_cfg.style == "blip":
            preprocess = lambda img: blip_preprocess(img, size)  # noqa: E731
        else:
            preprocess = lambda img: clip_preprocess(img, size)  # noqa: E731
    return CocoCaptionValidator(
        dataset, preprocess,
        {
            "nobeam": NoBeamCaptionSampler(top_p_values=list(nobeam_top_p), device=bundle.device),
            "clip_guided": ClipGuidedCaptionSampler(
                clip_scoring, branching_factor=branching_factor, look_ahead=look_ahead,
                device=bundle.device),
        },
        clip_scoring,
    )


def evaluate(
    bundle,  # models.bundle.CaptionerBundle
    clip_scoring,  # eval.clip_scoring.ClipScoring
    valid_json_path: str,
    image_folder_path: str,
    max_samples: int = 10,
    nobeam_top_p=(0.1, 0.2),
    branching_factor: int = 2,
    look_ahead: int = 4,
    preprocess=None,
    eval_batch_size: int = 8,
) -> dict:
    """Run the validator over the first max_samples images of the COCO
    annotation file, eval_batch_size images per process() chunk (samplers
    with a sample_batch run once per chunk; 1 gives image-at-a-time
    trajectories), print the scores as JSON and return the results."""
    from ..data.coco import CocoImageDataset

    dataset = CocoImageDataset(valid_json_path, image_folder_path)
    validator = build_validator(bundle, clip_scoring, dataset, nobeam_top_p, branching_factor,
                                look_ahead, preprocess)
    n = min(max_samples, len(dataset))
    step = max(1, int(eval_batch_size))
    for i in range(0, n, step):
        validator.process(bundle, [dataset[j] for j in range(i, min(i + step, n))])
    results = validator.get_results()
    print(json.dumps({k: v for k, v in results.items() if k != "captions"}, indent=2,
                     default=float))
    return results


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluate a captioner checkpoint on COCO")
    p.add_argument("--checkpoint_path", required=True,
                   help="directory of clipcap_config.json and consolidated.npz")
    p.add_argument("--tokenizer_vocab_dir", required=True)
    p.add_argument("--clip_model", default="ViT-B/32")
    p.add_argument("--clip_checkpoint", required=True)
    p.add_argument("--clip_merges", required=True)
    p.add_argument("--valid_json_path", required=True)
    p.add_argument("--image_folder_path", required=True)
    p.add_argument("--prefix_only", action="store_true")
    p.add_argument("--max_samples", type=int, default=10)
    p.add_argument("--manual_seed", type=int, default=42)
    p.add_argument("--int8_decode", action="store_true",
                   help="int8 weight-streaming decode for the samplers (gpt2/gptj/t5; see "
                        "models/bundle.enable_int8_decode)")
    p.add_argument("--eval_batch_size", type=int, default=8,
                   help="images per validator chunk; samplers with a batched path run once "
                        "per chunk (1 = reference-exact image-at-a-time)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)

    from ..eval.clip_scoring import ClipScoring
    from .loading import load_captioner_bundle, load_clip_ranker

    bundle = load_captioner_bundle(args.checkpoint_path, args.tokenizer_vocab_dir,
                                   prefix_only=args.prefix_only, device=args.device)
    if args.int8_decode:
        bundle.enable_int8_decode()
    ranker = load_clip_ranker(args.clip_model, args.clip_checkpoint, args.clip_merges,
                              device=args.device)
    scoring = ClipScoring(ranker.visual, ranker.text, ranker.tokenizer)
    return evaluate(bundle, scoring, args.valid_json_path, args.image_folder_path,
                    max_samples=args.max_samples, eval_batch_size=args.eval_batch_size)


if __name__ == "__main__":
    main()
