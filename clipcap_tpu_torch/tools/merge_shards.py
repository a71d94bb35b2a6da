"""Merge preprocessed shard directories from several runs into one (the
port's own copy of clipcap_tpu/tools/merge_shards.py; host only).

Rebuild of reference utils/merge_preprocessed_datasets.py:6-48: each input
run directory contributes its shard files, renamed `{run}-{file}` so
name-sorted pairing stays consistent. Supports this framework's
{prefixes,tokens} layout and the reference's legacy
{img_embeddings,text_tokens,text_masks} layout.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

LAYOUTS = {
    "prefix_tokens": ("prefixes", "tokens"),
    "legacy": ("img_embeddings", "text_tokens", "text_masks"),
}


def merge_datasets(
    base_dir: str,
    out_dir: str,
    move_files: bool = False,
    layout: str = "prefix_tokens",
) -> int:
    subdirs = LAYOUTS[layout]
    base = Path(base_dir)
    out = Path(out_dir)
    for sub in subdirs:
        (out / sub).mkdir(parents=True, exist_ok=True)

    op = shutil.move if move_files else shutil.copy
    merged = 0
    for run in sorted(p for p in base.iterdir() if p.is_dir()):
        primary = run / subdirs[0]
        if not primary.is_dir():
            continue
        for f in sorted(primary.glob("*.npy")):
            partners = [run / sub / f.name for sub in subdirs[1:]]
            if not all(p.exists() for p in partners):
                print(f"skipping {run.name}/{f.name}: incomplete shard pair")
                continue
            op(str(f), str(out / subdirs[0] / f"{run.name}-{f.name}"))
            for sub, p in zip(subdirs[1:], partners):
                op(str(p), str(out / sub / f"{run.name}-{f.name}"))
            merged += 1
    print(f"merged {merged} shard groups into {out}")
    return merged


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", default="../datasets/")
    p.add_argument("--out_dir", default="../final_dataset/")
    p.add_argument("--move_files", action="store_true")
    p.add_argument("--layout", default="prefix_tokens", choices=list(LAYOUTS))
    args = p.parse_args(argv)
    merge_datasets(**vars(args))


if __name__ == "__main__":
    main()
