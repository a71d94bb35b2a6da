"""ctypes binding of the native shard loader (the port's own copy of
clipcap_tpu/data/native_loader.py, over its own build of
native/npy_loader.cpp; see _native.py).

Drop-in replacement for TokenPrefixDataset on the training hot path:
identical batch semantics (exact batch_size, overflow across shard files,
infinite wrap), but file IO and batch assembly run on a C++ thread with a
bounded prefetch queue, so `next()` overlaps with the train step.
`make_token_prefix_dataset` falls back to the Python reader when the
library cannot be built, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from . import _native

_lib = None
_lock = threading.Lock()


def build_native() -> Optional[Path]:
    """Build the loader library; its path, or None if it cannot be built."""
    try:
        return _native.build("npy_loader")
    except (OSError, RuntimeError) as err:
        print(f"native loader build failed: {err}")
        return None


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_native()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int]
        lib.loader_row_info.restype = None
        lib.loader_row_info.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 3
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeTokenPrefixDataset:
    """Same iteration contract as data.token_prefix.TokenPrefixDataset:
    (tokens int64 [B, T], prefixes float32 [B, row]) batches, prefix rows
    flattened by the C side."""

    def __init__(self, data_path: str, batch_size: int = 5, normalize_prefix: bool = False,
                 queue_depth: int = 4):
        self._handle = None
        self._lib = _load_lib()
        if self._lib is None:
            raise RuntimeError("native loader unavailable (g++ could not build "
                               "native/npy_loader.cpp)")
        path = Path(data_path)
        self.batch_size = batch_size
        self.normalize_prefix = normalize_prefix
        self._handle = self._lib.loader_create(str(path / "prefixes").encode(),
                                               str(path / "tokens").encode(), batch_size,
                                               queue_depth)
        if not self._handle:
            raise FileNotFoundError(f"no valid shard pairs under {path}")
        pr, tr, n = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.loader_row_info(self._handle, ctypes.byref(pr), ctypes.byref(tr),
                                  ctypes.byref(n))
        self.prefix_row_elems = pr.value
        self.tokens_row_elems = tr.value
        self.sample_count = n.value
        self._prefix_buf = np.empty((batch_size, self.prefix_row_elems), np.float32)
        self._tokens_buf = np.empty((batch_size, self.tokens_row_elems), np.int64)

    def __len__(self) -> int:
        return self.sample_count // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while self._handle:
            rc = self._lib.loader_next(self._handle,
                                       self._prefix_buf.ctypes.data_as(ctypes.c_void_p),
                                       self._tokens_buf.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                return
            prefixes = self._prefix_buf.copy()
            tokens = self._tokens_buf.copy()
            if self.normalize_prefix:
                norms = np.linalg.norm(prefixes, axis=-1, keepdims=True)
                prefixes = prefixes / np.where(norms > 0, norms, 1.0)
            yield tokens, prefixes

    def close(self) -> None:
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def make_token_prefix_dataset(data_path: str, batch_size: int, normalize_prefix: bool = False,
                              prefer_native: bool = True):
    """The native loader when it can be built, else the Python reader."""
    if prefer_native:
        try:
            return NativeTokenPrefixDataset(data_path, batch_size, normalize_prefix)
        except (RuntimeError, FileNotFoundError) as err:
            print(f"native loader unavailable ({err}); using Python reader")
    from .token_prefix import TokenPrefixDataset

    return TokenPrefixDataset(data_path, batch_size, normalize_prefix)
