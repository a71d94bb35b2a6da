"""COCO-val sampling sweep on the card (port of clipcap_tpu/cli/sweep.py;
reference blip_coco_val_sample_sweep.py:91-165 and the two bayes sweep
YAMLs).

One trial samples n random val images, synthesizes candidates with the
trial's hyperparameters, ranks them to one caption per image, scores the
captions against the COCO ground truth (Bleu 1-4 and CIDEr) and logs the
metrics. `run_sweep` drives trials over the wandb-style parameter space of
a sweep YAML: `method: bayes` runs TPE (utils/tpe.py, the committed YAMLs'
method), `method: random` plain random search; the trials go to wandb
when it is installed and enabled, and `main` returns them.

    python -m clipcap_tpu_torch.cli.sweep --valid_json_path captions.json \
        --image_folder_path val2017 --sweep_yaml configs/sweep_bayes_01.yaml \
        --blip_checkpoint B.pth --blip_vocab vocab.txt \
        --clip_vit_l_checkpoint ViT-L-14.pt --clip_merges merges.txt

Every model is built on --device, the card unless asked for the CPU. A
trial's sampling seed is its own (manual_seed + image), as in JAX; the
port's random draws differ from jax.random's. JAX's main builds its BLIP
ranker on the captioner's modules, so a trial in ITC or ITM mode raises
KeyError there; the port's main keeps that behaviour.
"""

from __future__ import annotations

import argparse
import json
import math
import random
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.coco import CocoJsonIndex
from ..data.preprocessing import blip_preprocess
from ..eval.scoring import generate_scores
from ..utils.logging import MetricLogger
from .synthesis import SynthesisEngine, build_engine, default_grids


def run_eval(
    engine: SynthesisEngine,
    valid_json_path: str,
    image_folder_path: str,
    n: int = 100,
    mode: str = "CLIP-ViT-L",
    batch_size: int = 40,
    top_k: float = 2500,
    top_p: Optional[float] = None,
    typ_p: float = 0.0,
    min_len: Optional[int] = None,
    max_len: Optional[int] = None,
    force_eos_prob: float = 0.9,
    manual_seed: int = 42,
    logger: Optional[MetricLogger] = None,
) -> dict:
    """One sweep trial: synthesize and rank one caption an image, then the
    pycocoevalcap-style scores (reference :144-161)."""
    np_rng = np.random.default_rng(manual_seed)
    index = CocoJsonIndex(valid_json_path)
    order = np_rng.permutation(len(index))[:n]
    image_folder = Path(image_folder_path)

    from PIL import Image

    top_p_g, min_g, max_g = default_grids(top_p, min_len, max_len, n=batch_size)
    gts, res = {}, {}
    caps_by_img = index.get_captions_by_image_id()

    for i, idx in enumerate(order):
        entry = index[int(idx)]
        img_id = entry.image.id
        if img_id in res:
            continue
        src = image_folder / entry.image.file_name
        try:
            raw_image = Image.open(src).convert("RGB")
        except Exception as err:
            print(f"skipping {src}: {err}")
            continue
        pixels = torch.from_numpy(blip_preprocess(raw_image, engine.blip_vit_cfg.image_size))[None]
        captions, _, _ = engine.synthesize(
            pixels, sample_count=batch_size, top_p=top_p_g, top_k=top_k, typ_p=typ_p,
            min_len=min_g, max_len=max_g, force_eos_prob=force_eos_prob,
            seed=manual_seed + i)
        if not captions:
            continue
        ranked = engine.rank(raw_image, captions, mode=mode, top_n=1)
        res[img_id] = [{"caption": ranked[0][0]}]
        gts[img_id] = [{"caption": c} for c in caps_by_img[img_id]]

    scores, _ = generate_scores(gts, res)
    if logger is not None:
        logger.log(scores)
    return scores


def _draw(space: dict, rng: random.Random):
    """Draw one value from a wandb-style parameter spec."""
    if "values" in space:
        return rng.choice(space["values"])
    if "min" in space and "max" in space:
        lo, hi = space["min"], space["max"]
        if isinstance(lo, int) and isinstance(hi, int):
            return rng.randint(lo, hi)
        if space.get("distribution") == "log_uniform_values":
            return math.exp(rng.uniform(math.log(lo), math.log(hi)))
        return rng.uniform(lo, hi)
    if "value" in space:
        return space["value"]
    raise ValueError(f"unsupported parameter spec {space}")


def run_sweep(
    engine: SynthesisEngine,
    sweep_config: dict,
    valid_json_path: str,
    image_folder_path: str,
    trials: int = 10,
    n_images: int = 100,
    seed: int = 0,
    logger: Optional[MetricLogger] = None,
) -> list:
    """Trials over a wandb-sweep-style parameter space, maximizing or
    minimizing `metric.name` (default: maximize Bleu_4). `method: bayes`
    (the reference's, blip_coco_val_sample_sweep_bayes_01.yaml:2) runs
    TPE; `method: random` random search. Returns [(trial, scores)], best
    first."""
    method = sweep_config.get("method", "bayes")
    metric_cfg = sweep_config.get("metric", {})
    metric_name = metric_cfg.get("name", "Bleu_4")
    maximize = metric_cfg.get("goal", "maximize") != "minimize"
    params_space = sweep_config.get("parameters", {})
    logger = logger or MetricLogger()

    if method == "bayes":
        from ..utils.tpe import TPEOptimizer

        opt = TPEOptimizer(params_space, seed=seed, maximize=maximize)
        draw = opt.suggest
    elif method == "random":
        rng = random.Random(seed)
        opt = None

        def draw():
            return {k: _draw(v, rng) for k, v in params_space.items()}
    else:
        raise ValueError(f"unsupported sweep method {method!r} (bayes | random)")

    results = []
    for t in range(trials):
        trial = draw()
        kwargs = {k: trial[k]
                  for k in ("mode", "batch_size", "top_k", "top_p", "typ_p", "min_len",
                            "max_len", "force_eos_prob")
                  if k in trial}
        scores = run_eval(engine, valid_json_path, image_folder_path,
                          n=n_images, manual_seed=seed + t, **kwargs)
        if opt is not None:
            opt.observe(trial, scores.get(metric_name, float("nan")))
        logger.log({"trial": t, **trial, **scores})
        results.append((trial, scores))
    sign = -1.0 if maximize else 1.0
    results.sort(key=lambda x: sign * x[1].get(metric_name, 0.0))
    best_trial, best_scores = results[0]
    print(f"best {metric_name}={best_scores.get(metric_name):.4f} with {best_trial}")
    return results


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="COCO-val sampling sweep on the card (Gen B)")
    p.add_argument("--valid_json_path", required=True)
    p.add_argument("--image_folder_path", required=True)
    p.add_argument("--sweep_yaml", default=None, help="wandb-style sweep config")
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--mode", default="CLIP-ViT-L")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--blip_checkpoint", required=True)
    p.add_argument("--blip_vocab", required=True)
    p.add_argument("--blip_vit_variant", default="ViT-L")
    p.add_argument("--clip_vit_l_checkpoint", default=None)
    p.add_argument("--clip_merges", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    engine = build_engine(args)
    logger = MetricLogger(use_wandb=args.use_wandb)
    try:
        if args.sweep_yaml:
            import yaml

            cfg = yaml.safe_load(Path(args.sweep_yaml).read_text())
            return run_sweep(engine, cfg, args.valid_json_path, args.image_folder_path,
                             trials=args.trials, n_images=args.n, logger=logger)
        scores = run_eval(engine, args.valid_json_path, args.image_folder_path,
                          n=args.n, mode=args.mode, logger=logger)
        print(json.dumps(scores, indent=2))
        return scores
    finally:
        logger.close()


if __name__ == "__main__":
    main()
