"""COCO-json and image/text-folder datasets (the port's own copy of
clipcap_tpu/data/coco.py; PIL is imported only inside the function that
opens images, so importing this module needs no PIL).

Rebuild of the reference's index + dataset classes
(create_dataset.py:26-355): plain sequence classes the trainer and the
validator iterate. Semantics kept exactly:

- CocoJsonIndex: captions_*.json -> image_by_id + flat annotations,
  get_captions_by_image_id grouping (reference :26-87);
- FileFolderIndex: image/text pairing by filename-stem intersection with
  whitespace-normalized captions (reference :90-124);
- image datasets (eval): {"image": PIL, "image_entry": entry}, path
  resolution with image_folder_path override + replace_extension, loader
  errors -> None filtered by the collate (reference :127-185);
- caption datasets (train): {"image_tensor", "tokens", "image_id"} with
  encode_text(add_bos=True, add_eos=True) and **-1 padding** to
  max_token_length (reference :217-234) — the -1 padding is what the
  training mask keys on (model.py:203).
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np


def _open_rgb(path):
    from PIL import Image

    return Image.open(path).convert("RGB")


@dataclasses.dataclass
class CocoJsonImageEntry:
    id: object
    file_name: Union[str, Path]
    url: Optional[str]


@dataclasses.dataclass
class CocoJsonCaptionEntry:
    caption: str
    image: CocoJsonImageEntry


class DatasetIndexBase:
    image_by_id: Dict[object, CocoJsonImageEntry]

    def get_captions_by_image_id(self) -> Dict[object, List[str]]:
        captions: Dict[object, List[str]] = {}
        for i in range(len(self)):
            entry = self[i]
            captions.setdefault(entry.image.id, []).append(entry.caption)
        return captions

    def __len__(self):
        raise NotImplementedError()

    def __getitem__(self, index: int) -> CocoJsonCaptionEntry:
        raise NotImplementedError()


class CocoJsonIndex(DatasetIndexBase):
    """COCO captions_*.json parser (reference create_dataset.py:56-87)."""

    def __init__(self, annotation_json_path: str):
        with open(annotation_json_path) as f:
            j = json.load(f)
        self.image_by_id = {
            img["id"]: CocoJsonImageEntry(
                id=img["id"], file_name=img["file_name"], url=img.get("coco_url")
            )
            for img in j["images"]
        }
        self.annotations = j["annotations"]
        print(
            f"total annotations: {len(self.annotations)}; "
            f"total images: {len(self.image_by_id)};"
        )

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, index):
        a = self.annotations[index]
        return CocoJsonCaptionEntry(
            caption=a["caption"], image=self.image_by_id[a["image_id"]]
        )


class FileFolderIndex(DatasetIndexBase):
    """Filename-stem pairing of **/*.{png,jpg,jpeg,bmp} with **/*.txt
    (reference create_dataset.py:90-124)."""

    def __init__(self, folder_path: str):
        path = Path(folder_path)
        text_files = {fn.stem: fn for fn in path.glob("**/*.txt")}
        image_files = {}
        for ext in ("png", "jpg", "jpeg", "bmp"):
            for fn in path.glob(f"**/*.{ext}"):
                image_files[fn.stem] = fn
        keys = text_files.keys() & image_files.keys()
        self.image_by_id = {
            k: CocoJsonImageEntry(id=k, file_name=v, url=None)
            for k, v in image_files.items()
            if k in keys
        }
        self.text_files = {k: v for k, v in text_files.items() if k in keys}
        self.keys = sorted(keys)
        print(f"total images-text pairs: {len(self.image_by_id)};")

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        key = self.keys[index]
        caption = re.sub(r"\s+", " ", self.text_files[key].read_text())
        return CocoJsonCaptionEntry(caption=caption, image=self.image_by_id[key])


class CocoImageDatasetBase:
    """Eval dataset: PIL image + entry (reference create_dataset.py:127-172)."""

    def __init__(self, annotations: DatasetIndexBase, image_folder_path, replace_extension=None):
        self.annotations = annotations
        self.keys = list(annotations.image_by_id.keys())
        self.image_folder_path = Path(image_folder_path) if isinstance(image_folder_path, str) else image_folder_path
        self.replace_extension = replace_extension

    def get_index(self):
        return self.annotations

    def __len__(self):
        return len(self.keys)

    def get_image_path_by_id(self, image_id):
        entry = self.annotations.image_by_id[image_id]
        file_path = Path(entry.file_name) if isinstance(entry.file_name, str) else entry.file_name
        parent_path = self.image_folder_path or file_path.parent
        if self.replace_extension is not None:
            file_path = file_path.stem + self.replace_extension
        return parent_path / file_path

    def load_image_by_id(self, image_id):
        return _open_rgb(self.get_image_path_by_id(image_id))

    def __getitem__(self, index):
        image_id = self.keys[index]
        entry = self.annotations.image_by_id[image_id]
        try:
            image = self.load_image_by_id(image_id)
        except Exception as err:  # a load error; interrupts propagate
            print(
                f"Failed to load image '{self.get_image_path_by_id(image_id)}' "
                f"(error='{err}'; type(err)={type(err)}). Skipping."
            )
            return None  # filtered by the batch collate
        return {"image": image, "image_entry": entry}


class CocoImageDataset(CocoImageDatasetBase):
    def __init__(self, annotation_json_path, image_folder_path, replace_extension=None):
        super().__init__(CocoJsonIndex(annotation_json_path), image_folder_path, replace_extension)


class FolderImageDataset(CocoImageDatasetBase):
    def __init__(self, folder_path):
        super().__init__(FileFolderIndex(folder_path), image_folder_path=None)


def pad_tokens(tokens: List[int], max_token_length: int) -> np.ndarray:
    """-1 pad / truncate to max_token_length (reference :230-234)."""
    arr = np.asarray(tokens, np.int64)
    padding = max_token_length - arr.shape[0]
    if padding > 0:
        arr = np.concatenate([arr, np.full((padding,), -1, np.int64)])
    elif padding < 0:
        arr = arr[:max_token_length]
    return arr


class CocoCaptionDatasetBase:
    """Train dataset: image tensor + -1-padded tokens (reference :188-255)."""

    def __init__(self, annotations: DatasetIndexBase, image_folder_path, tokenizer,
                 image_transform: Optional[Callable], max_token_length: int = 128,
                 replace_extension=None):
        self.annotations = annotations
        self.image_folder_path = Path(image_folder_path) if isinstance(image_folder_path, str) else image_folder_path
        self.image_transform = image_transform
        self.tokenizer = tokenizer
        self.max_token_length = max_token_length
        self.replace_extension = replace_extension

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, index):
        entry = self.annotations[index]
        file_path = Path(entry.image.file_name) if isinstance(entry.image.file_name, str) else entry.image.file_name
        parent_path = self.image_folder_path or file_path.parent
        if self.replace_extension is not None:
            file_path = file_path.stem + self.replace_extension
        image_path = parent_path / file_path

        try:
            image = _open_rgb(image_path)
            if self.image_transform is not None:
                image_tensor = np.asarray(self.image_transform(image), np.float32)
            else:
                image_tensor = np.asarray(image, np.float32).transpose(2, 0, 1) / 255.0
        except Exception as err:  # a load error; interrupts propagate
            print(
                f"Failed to load image '{image_path}' (error='{err}'; "
                f"type(err)={type(err)}). Skipping."
            )
            return None

        tokens = self.tokenizer.encode_text(
            entry.caption, max_token_length=self.max_token_length,
            add_bos=True, add_eos=True,
        )
        return {
            "image_tensor": image_tensor,
            "tokens": pad_tokens(tokens, self.max_token_length),
            "image_id": entry.image.id,
        }


class CocoCaptionDataset(CocoCaptionDatasetBase):
    def __init__(self, annotation_json_path, image_folder_path, tokenizer,
                 image_transform, max_token_length: int = 128, replace_extension=None):
        super().__init__(CocoJsonIndex(annotation_json_path), image_folder_path,
                         tokenizer, image_transform, max_token_length, replace_extension)


class FolderCaptionDataset(CocoCaptionDatasetBase):
    def __init__(self, folder_path, tokenizer, image_transform, max_token_length: int = 128):
        super().__init__(FileFolderIndex(folder_path), image_folder_path=None,
                         tokenizer=tokenizer, image_transform=image_transform,
                         max_token_length=max_token_length)


def collate_filter_none(batch: List[Optional[dict]]) -> Optional[dict]:
    """The reference's None-filtering collate (train.py:262-264)."""
    batch = [x for x in batch if x is not None]
    if not batch:
        return None
    out = {}
    for key in batch[0]:
        vals = [b[key] for b in batch]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class BatchLoader:
    """Minimal shuffling batch iterator over a map-style dataset —
    the DataLoader role (reference train.py:266) without worker procs;
    the C++ prefetcher (native/) covers the hot preprocessed-shard path."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        return n if self.drop_last else -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        epoch = 0
        while True:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                rng = np.random.default_rng(self.seed + epoch)
                rng.shuffle(order)
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                batch = [self.dataset[int(j)] for j in order[i : i + self.batch_size]]
                collated = collate_filter_none(batch)
                if collated is not None:
                    yield collated
            epoch += 1
