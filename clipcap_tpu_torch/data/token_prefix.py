"""Preprocessed-shard dataset: pre-batched (tokens, prefixes) pairs (the
port's own copy of clipcap_tpu/data/token_prefix.py).

Behavioral rebuild of the reference's TokenPrefixDataset /
MultiplePrefixDataset (reference dataset.py:76-205):

- directory layout `{data_path}/prefixes/*.npy` + `{data_path}/tokens/*.npy`
  with name-sorted pairing (reference :86-90);
- yields batches of *exactly* batch_size, carrying an overflow remainder
  across shard-file boundaries (reference :109-157);
- iterates forever, wrapping at the last file (reference :115-116);
- optional L2 prefix normalization (reference :167-168 — note the
  reference divides by the norm's last axis without keepdims, which
  broadcasts only because prefixes there are 2-D; we normalize along the
  last axis explicitly);
- __len__ = total_samples // batch_size (reference :102-103).

Output arrays are numpy (tokens int64 [B, T], prefixes float32 [B, ...]);
the trainer (train/trainer.py) copies each batch to the card.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .npy_reader import NumpyShardReader, read_row_count


class TokenPrefixDataset:
    def __init__(self, data_path: str, batch_size: int = 5, normalize_prefix: bool = False):
        self.batch_size = batch_size
        self.normalize_prefix = normalize_prefix

        path = Path(data_path)
        self.prefix_files: List[Path] = sorted((path / "prefixes").glob("*.npy"), key=lambda x: x.name)
        self.tokens_files: List[Path] = sorted((path / "tokens").glob("*.npy"), key=lambda x: x.name)
        if not self.prefix_files:
            raise FileNotFoundError(f"no prefix shards under {path}/prefixes")
        if len(self.prefix_files) != len(self.tokens_files):
            raise ValueError(
                f"shard count mismatch: {len(self.prefix_files)} prefixes vs "
                f"{len(self.tokens_files)} tokens"
            )

        self.sample_count = sum(read_row_count(f) for f in self.prefix_files)

    def __len__(self) -> int:
        return self.sample_count // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        file_index = 0
        overflow: Optional[Tuple[np.ndarray, np.ndarray]] = None

        while True:
            if file_index >= len(self.prefix_files):
                file_index = 0

            with NumpyShardReader(self.prefix_files[file_index]) as prefix_reader, \
                 NumpyShardReader(self.tokens_files[file_index]) as tokens_reader:

                if prefix_reader.num_rows != tokens_reader.num_rows:
                    raise ValueError(
                        f"row mismatch in shard pair {self.prefix_files[file_index].name}"
                    )

                sample_index = 0
                max_sample_index = prefix_reader.num_rows

                while sample_index < max_sample_index:
                    need = self.batch_size - (0 if overflow is None else overflow[0].shape[0])
                    take = min(need, max_sample_index - sample_index)

                    prefix_np = prefix_reader.get_rows(sample_index, sample_index + take)
                    tokens_np = tokens_reader.get_rows(sample_index, sample_index + take)
                    sample_index += take

                    if overflow is not None:
                        prefix_np = np.concatenate([overflow[0], prefix_np], axis=0)
                        tokens_np = np.concatenate([overflow[1], tokens_np], axis=0)
                        overflow = None

                    if prefix_np.shape[0] < self.batch_size:
                        # shard exhausted mid-batch: carry remainder to next file
                        overflow = (prefix_np, tokens_np)
                        break

                    tokens = np.asarray(tokens_np, dtype=np.int64)
                    prefixes = np.asarray(prefix_np, dtype=np.float32)
                    if self.normalize_prefix:
                        norms = np.linalg.norm(prefixes, axis=-1, keepdims=True)
                        prefixes = prefixes / np.where(norms > 0, norms, 1.0)

                    yield (tokens, prefixes)

            file_index += 1


class MultiplePrefixDataset:
    """Round-robin interleave several TokenPrefixDatasets batch-by-batch
    (reference dataset.py:183-205)."""

    def __init__(self, *datasets: TokenPrefixDataset):
        self.datasets = datasets
        self.total_samples = sum(len(d) for d in datasets)

    def __len__(self) -> int:
        return self.total_samples

    def __iter__(self):
        iters = [iter(d) for d in self.datasets]
        i = 0
        while True:
            yield next(iters[i % len(iters)])
            i += 1
