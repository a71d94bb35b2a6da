"""Image content-hash indexing, dedup, and caption merging (the port's own
copy of clipcap_tpu/tools/file_hashes.py; host only).

Rebuild of the reference's compute_file_hashes.py (:11-232) with the
hard-coded paths lifted into arguments:

- create/store/load/add-dir: sha256 index over image folders
  ({file -> hash}, {hash -> [files]});
- merge_captions: merge caption sources across datasets by content hash,
  skipping any image whose hash appears in a validation index (the
  val-set-leakage guard, reference :121-122), union-ing folder .txt
  captions with COCO captions for the same bytes, emitting a COCO-format
  json.

Indexes are JSON (string paths) rather than the reference's pickles.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

EXTENSIONS = ("png", "jpg", "jpeg", "bmp")


def create_index(path: Path) -> Tuple[Dict[str, str], Dict[str, List[str]]]:
    file_to_hash: Dict[str, str] = {}
    hash_to_files: Dict[str, List[str]] = {}
    image_files = []
    for ext in EXTENSIONS:
        image_files.extend(path.glob(f"**/*.{ext}"))
    print("found:", len(image_files))
    for fn in sorted(image_files):
        digest = hashlib.sha256(fn.read_bytes()).hexdigest()
        file_to_hash[str(fn)] = digest
        hash_to_files.setdefault(digest, []).append(str(fn))
    return file_to_hash, hash_to_files


def store_index(path: str, out_filename: str) -> None:
    file_to_hash, hash_to_files = create_index(Path(path))
    with open(out_filename, "w") as f:
        json.dump({"file_to_hash": file_to_hash, "hash_to_file": hash_to_files}, f)


def load_index(filename: str) -> dict:
    with open(filename) as f:
        return json.load(f)


def add_dir_to_index(in_filename: str, dir_path: str, out_filename: str) -> None:
    index = load_index(in_filename)
    print("unique files before:", len(index["hash_to_file"]))
    file_to_hash, hash_to_files = create_index(Path(dir_path))
    index["file_to_hash"].update(file_to_hash)
    for digest, fns in hash_to_files.items():
        index["hash_to_file"].setdefault(digest, []).extend(fns)
    print("unique files after:", len(index["hash_to_file"]))
    with open(out_filename, "w") as f:
        json.dump(index, f)


def normalize_caption(s: str) -> str:
    """reference :80-85: join 1-char-per-line strings, else squeeze spaces."""
    lines = s.split("\n")
    joined = "".join(lines)
    if len(joined) <= len(lines):
        return joined
    return re.sub(r"\s+", " ", s).strip()


def merge_captions(
    coco_annotation_json: str,
    coco_image_dir: str,
    coco_index_file: str,
    source_index_file: str,
    output_json_path: str,
    val_index_file: Optional[str] = None,
    base_path: Optional[str] = None,
) -> dict:
    """Build a merged COCO-format caption json keyed by content hash."""
    from ..data.coco import CocoJsonIndex

    annotations_index = CocoJsonIndex(coco_annotation_json)
    coco_file_index = load_index(coco_index_file)["file_to_hash"]
    coco_dir = Path(coco_image_dir)

    coco_captions_by_hash: Dict[str, List[str]] = {}
    for i in range(len(annotations_index)):
        entry = annotations_index[i]
        caption = normalize_caption(entry.caption)
        source_path = str(coco_dir / entry.image.file_name)
        digest = coco_file_index.get(source_path)
        if digest is not None:
            coco_captions_by_hash.setdefault(digest, []).append(caption)

    val_hashes = set()
    if val_index_file:
        val_hashes = set(load_index(val_index_file)["hash_to_file"].keys())

    source_hash_index = load_index(source_index_file)["hash_to_file"]

    images, annotations = [], []
    next_image_id = 0
    next_caption_id = 0
    skipped_val = 0
    for digest, fns in source_hash_index.items():
        if digest in val_hashes:  # val-set leakage guard (reference :121-122)
            skipped_val += 1
            continue
        captions: List[str] = []
        for fn in fns:
            fn = Path(fn)
            txt = fn.parent / (fn.stem + ".txt")
            if txt.is_file():
                c = normalize_caption(txt.read_text())
                if c not in captions:
                    captions.append(c)
        for c in coco_captions_by_hash.get(digest, []):
            if c not in captions:
                captions.append(c)
        if not captions:
            continue
        fns = sorted(fns)
        file_name = str(Path(fns[0]).relative_to(base_path)) if base_path else fns[0]
        image_id = next_image_id
        next_image_id += 1
        images.append({"file_name": file_name, "id": image_id})
        for c in captions:
            annotations.append({"image_id": image_id, "id": next_caption_id, "caption": c})
            next_caption_id += 1

    data = {"images": images, "annotations": annotations}
    print(f"writing: {output_json_path} ({len(images)} images, "
          f"{len(annotations)} captions, {skipped_val} val-leaks removed)")
    with open(output_json_path, "w") as f:
        json.dump(data, f)
    return data


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("store-index")
    s.add_argument("--path", required=True)
    s.add_argument("--out", required=True)

    a = sub.add_parser("add-dir")
    a.add_argument("--index", required=True)
    a.add_argument("--dir", required=True)
    a.add_argument("--out", required=True)

    m = sub.add_parser("merge-captions")
    m.add_argument("--coco_annotation_json", required=True)
    m.add_argument("--coco_image_dir", required=True)
    m.add_argument("--coco_index", required=True)
    m.add_argument("--source_index", required=True)
    m.add_argument("--val_index", default=None)
    m.add_argument("--base_path", default=None)
    m.add_argument("--out", required=True)

    args = p.parse_args(argv)
    if args.cmd == "store-index":
        store_index(args.path, args.out)
    elif args.cmd == "add-dir":
        add_dir_to_index(args.index, args.dir, args.out)
    else:
        merge_captions(args.coco_annotation_json, args.coco_image_dir,
                       args.coco_index, args.source_index, args.out,
                       val_index_file=args.val_index, base_path=args.base_path)


if __name__ == "__main__":
    main()
