"""Random-access .npy shard reader + writer (the port's own copy of
clipcap_tpu/data/npy_reader.py).

Host-side equivalent of the reference's lazy numpy reader
(reference dataset.py:12-73: header parse, then seek + frombuffer row
ranges, deliberately not mmap so memory stays bounded). Header parsing
uses numpy's public `np.lib.format` readers (format versions 1.0 and 2.0,
what np.save writes) instead of the reference's regex.
The C++ prefetching reader of native/npy_loader.cpp is bound by
native_loader.py.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np


def _read_header(f) -> Tuple[Tuple[int, ...], bool, np.dtype]:
    """(shape, fortran_order, dtype) of the .npy file open at its start."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        return np.lib.format.read_array_header_1_0(f)
    if version == (2, 0):
        return np.lib.format.read_array_header_2_0(f)
    raise ValueError(f"unsupported .npy format version {version}")


class NumpyShardReader:
    """Open one .npy file for random row-range access. Context manager."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.f = open(self.path, "rb")
        shape, fortran, dtype = _read_header(self.f)
        if fortran:
            raise ValueError(f"{path}: Fortran-ordered .npy shards are not supported")
        self.shape: Tuple[int, ...] = shape
        self.dtype = np.dtype(dtype)
        self.header_offset = self.f.tell()
        self.bytes_per_row = self.dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    def get_rows(self, start: int, end: int) -> np.ndarray:
        if not (0 <= start <= end <= self.num_rows):
            raise IndexError(f"rows [{start}:{end}] out of range for {self.shape}")
        length = end - start
        self.f.seek(self.header_offset + start * self.bytes_per_row)
        buf = self.f.read(length * self.bytes_per_row)
        return np.frombuffer(buf, dtype=self.dtype).reshape((length,) + self.shape[1:])

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_row_count(path: Union[str, Path]) -> int:
    with open(path, "rb") as f:
        shape, _, _ = _read_header(f)
    return shape[0]


def write_npy_shard(path: Union[str, Path], array: np.ndarray) -> None:
    """Write one shard (plain .npy; the preprocess tool's output format)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.ascontiguousarray(array))
