"""Human-evaluation packet preparation on the card (port of
clipcap_tpu/cli/human_eval.py; reference prepare_human_eval.py:58-265 and
prepare_human_eval_multi_filter.py:53-243, the latter by --multi_filter):

- sample n random COCO-val images and copy each under a uuid name;
- synthesize candidates (the default 40-slot grid), then in plain mode rank
  them by --mode, keep the winner, and show half the packet the human
  caption and half the synthetic one, blinded (:98-104); in multi-filter
  mode run the 4-stage threshold cascade CLIP-L 0.3 -> RN50x64 0.3 -> ITM
  0.99 -> ITC 0.55, each stage falling back to its top 10 %
  (multi_filter.py:158-191);
- write params.json, eval.html, the blinded eval.csv, gt.csv and the score
  histograms (png and svg).

    python -m clipcap_tpu_torch.cli.human_eval --valid_json_path captions.json \
        --image_folder_path val2017 --output_folder eval1 --mode CLIP-ViT-L \
        --blip_checkpoint B.pth --blip_vocab vocab.txt \
        --clip_vit_l_checkpoint ViT-L-14.pt --clip_merges merges.txt

Every model is built on --device, the card unless asked for the CPU. JAX's
behaviours are kept: the output folder must not exist yet; `main` loads no
RN50x64 ranker, so the default mode CLIP-ViT-L+RN50x64 raises KeyError;
`main` always plots (matplotlib); its BLIP ranker is the captioner's
modules, so --multi_filter's ITM stage raises KeyError (prepare_human_eval
runs the cascade on an engine whose BLIP ranker is a retrieval model).
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import uuid
from pathlib import Path

import numpy as np
import torch

from ..data.coco import CocoJsonIndex
from ..data.preprocessing import blip_preprocess
from .synthesis import SynthesisEngine, build_engine, default_grids, ranker_preprocess


def plot_histogram(data, label, title, x_label, y_label="Frequency", bins=100):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 6))
    plt.hist(data, alpha=1.0, label=label, bins=bins)
    plt.xlabel(x_label, size=14)
    plt.ylabel(y_label, size=14)
    plt.title(title)
    plt.legend(loc="upper right")
    return plt


def cascade_filter(engine: SynthesisEngine, image, captions, thresholds=None):
    """The 4-stage filter (multi_filter.py:158-191). Returns
    (kept_captions, itc_scores, clipl_scores), ordered by ITC."""
    from ..rank.cascade import threshold_cascade

    thresholds = thresholds or {"CLIP-L": 0.3, "RN50x64": 0.3, "ITM": 0.99, "ITC": 0.55}

    def clip_scorer(name):
        ranker = engine.clip_rankers[name]
        px = torch.from_numpy(ranker_preprocess(engine, name, image))[None]
        return lambda caps: ranker.rank(px, caps)

    def blip_scorer(m):
        px = torch.from_numpy(ranker_preprocess(engine, "blip", image))[None]
        return lambda caps: engine.blip_ranker.rank(px, caps, mode=m)

    stages = []
    clipl = clip_scorer("ViT-L/14")
    stages.append((clipl, thresholds["CLIP-L"]))
    if "RN50x64" in engine.clip_rankers:
        stages.append((clip_scorer("RN50x64"), thresholds["RN50x64"]))
    stages.append((blip_scorer("itm"), thresholds["ITM"]))
    itc = blip_scorer("itc")
    stages.append((itc, thresholds["ITC"]))

    kept = threshold_cascade(captions, stages, fallback_fraction=0.1)
    itc_scores = itc(kept)
    clipl_scores = clipl(kept)
    order = np.argsort(itc_scores)[::-1]
    return ([kept[i] for i in order], [float(itc_scores[i]) for i in order],
            [float(clipl_scores[i]) for i in order])


def prepare_human_eval(
    engine: SynthesisEngine,
    valid_json_path: str,
    image_folder_path: str,
    output_folder: str,
    n: int = 200,
    id_prefix: str = "A",
    mode: str = "CLIP-ViT-L+RN50x64",
    multi_filter: bool = False,
    top_k: float = 2500,
    typ_p: float = 0.0,
    force_eos_prob: float = 0.9,
    num_sampling_runs: int = 1,
    set_top_p=None, set_min_len=None, set_max_len=None,
    manual_seed: int = 42,
    params_json_fn: str = "params.json",
    make_plots: bool = True,
):
    """Write the packet into `output_folder` (which must not exist);
    returns the per-image records of params.json."""
    np_rng = np.random.default_rng(manual_seed)

    out = Path(output_folder)
    img_out = out / "images"
    print("creating output directory:", out)
    out.mkdir(parents=True, exist_ok=False)  # fail loudly on rerun (reference :121-124)
    img_out.mkdir(exist_ok=False)

    # blinded human/synth split (reference :98-104)
    gt_mask = np.zeros(n, dtype=bool)
    gt_mask[np_rng.permutation(n)[: n // 2]] = True

    index = CocoJsonIndex(valid_json_path)
    order = np_rng.permutation(len(index))[:n]
    image_folder = Path(image_folder_path)

    from PIL import Image

    top_p, min_len, max_len = default_grids(set_top_p, set_min_len, set_max_len)
    priv = []
    all_sims, winner_sims = [], []

    for i, idx in enumerate(order):
        entry = index[int(idx)]
        caption = entry.caption.lower().rstrip()
        if caption.endswith("."):
            caption = caption[:-1]

        src = image_folder / entry.image.file_name
        new_fn = img_out / (uuid.uuid4().hex + ".jpg")
        shutil.copyfile(src, new_fn)
        raw_image = Image.open(src).convert("RGB")
        w, h = raw_image.size

        pixels = torch.from_numpy(blip_preprocess(raw_image, engine.blip_vit_cfg.image_size))[None]
        captions, _, _ = engine.synthesize(
            pixels, sample_count=len(top_p), top_p=top_p, top_k=top_k, typ_p=typ_p,
            min_len=min_len, max_len=max_len, force_eos_prob=force_eos_prob,
            num_runs=num_sampling_runs, seed=manual_seed + i)

        record = {
            "id": f"{id_prefix}{i:04d}",
            "file_name": str(new_fn.relative_to(out)),
            "original_file_name": str(src),
            "image_size": [w, h],
        }
        if multi_filter:
            kept, itc_scores, clipl_scores = cascade_filter(engine, raw_image, captions)
            record.update(ground_truth=caption, synth_captions=kept,
                          synth_captions_scores_itc=itc_scores,
                          synth_captions_scores_clipl=clipl_scores)
        else:
            ranked = engine.rank(raw_image, captions, mode=mode, top_n=1)
            synth_caption, best_sim = ranked[0]
            winner_sims.append(best_sim)
            all_sims.append(best_sim)
            record.update(human_caption=caption, synth_caption=synth_caption,
                          synth_candidates=len(captions))
        priv.append(record)

    args_record = dict(valid_json_path=valid_json_path, n=n, mode=mode,
                       multi_filter=multi_filter, top_k=top_k, typ_p=typ_p,
                       force_eos_prob=force_eos_prob, manual_seed=manual_seed)
    (out / params_json_fn).write_text(json.dumps({"args": args_record, "captions": priv}, indent=2))

    with open(out / "eval.html", "w") as f:
        print("<!DOCTYPE html>", file=f)
        print(f"<html><head><title>{out}</title>", file=f)
        print("<style>img { max-width: 512px; max-height: 512px; width: auto; "
              "height: auto; } li { margin-bottom: 75px; }</style></head><body>", file=f)
        print(f"<h1>{out}</h1><ul>", file=f)
        for i, e in enumerate(priv):
            if multi_filter:
                caps = "".join(f"<li>[{s:.3f}] {c}</li>" for c, s in
                               zip(e["synth_captions"][:25], e["synth_captions_scores_itc"][:25]))
                print(f'<li><p><img src="{e["file_name"]}" /><br /><ul>{caps}</ul>'
                      f'Ground truth: {e["ground_truth"]}</p></li>', file=f)
            else:
                caption = e["human_caption" if gt_mask[i] else "synth_caption"]
                print(f'<li><p><img src="{e["file_name"]}" alt="{caption}" /><br />'
                      f'{e["id"]}: {caption}</p></li>', file=f)
        print("</ul></body></html>", file=f)

    if not multi_filter:
        with open(out / "eval.csv", "w", newline="") as f:
            w = csv.writer(f, dialect="excel")
            w.writerow(["id", "file_name", "caption", "human", "rating"])
            for i, e in enumerate(priv):
                caption = e["human_caption" if gt_mask[i] else "synth_caption"]
                w.writerow([e["id"], e["file_name"], caption, False, -1])

        with open(out / "gt.csv", "w", newline="") as f:
            w = csv.writer(f, dialect="excel")
            w.writerow(["id", "file_name", "human", "human_caption", "synth_caption",
                        "synth_candidates", "original_file_name"])
            for i, e in enumerate(priv):
                w.writerow([e["id"], e["file_name"], bool(gt_mask[i]), e["human_caption"],
                            e["synth_caption"], e["synth_candidates"], e["original_file_name"]])

        if make_plots and all_sims:
            plt = plot_histogram(all_sims, mode, f"All Scores Histogram {mode}", f"{mode} score")
            plt.savefig(out / f"score_{mode}_hist_all.png")
            plt.savefig(out / f"score_{mode}_hist_all.svg")
            plt = plot_histogram(winner_sims, mode, f"Winner Score Histogram {mode}",
                                 f"{mode} score", bins=25)
            plt.savefig(out / f"score_{mode}_hist_winner.png")
            plt.savefig(out / f"score_{mode}_hist_winner.svg")
    return priv


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="prepare a human-evaluation packet on the card")
    p.add_argument("--manual_seed", type=int, default=42)
    p.add_argument("--valid_json_path", required=True)
    p.add_argument("--image_folder_path", required=True)
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--id_prefix", default="A")
    p.add_argument("--output_folder", default="eval1")
    p.add_argument("--params_json_fn", default="params.json")
    p.add_argument("--top_k", type=float, default=2500)
    p.add_argument("--typ_p", type=float, default=0.0)
    p.add_argument("--force_eos_prob", type=float, default=0.9)
    p.add_argument("--num_sampling_runs", type=int, default=1)
    p.add_argument("--mode", default="CLIP-ViT-L+RN50x64")
    p.add_argument("--multi_filter", action="store_true")
    p.add_argument("--set_max_len", type=int, default=None)
    p.add_argument("--set_min_len", type=int, default=None)
    p.add_argument("--set_top_p", type=float, default=None)
    p.add_argument("--blip_checkpoint", required=True)
    p.add_argument("--blip_vocab", required=True)
    p.add_argument("--blip_vit_variant", default="ViT-L")
    p.add_argument("--clip_vit_l_checkpoint", default=None)
    p.add_argument("--clip_merges", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return prepare_human_eval(
        build_engine(args), args.valid_json_path, args.image_folder_path, args.output_folder,
        n=args.n, id_prefix=args.id_prefix, mode=args.mode,
        multi_filter=args.multi_filter, top_k=args.top_k, typ_p=args.typ_p,
        force_eos_prob=args.force_eos_prob, num_sampling_runs=args.num_sampling_runs,
        set_top_p=args.set_top_p, set_min_len=args.set_min_len,
        set_max_len=args.set_max_len, manual_seed=args.manual_seed,
        params_json_fn=args.params_json_fn)


if __name__ == "__main__":
    main()
