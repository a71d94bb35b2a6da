"""ctypes binding of the native JPEG decoder (the port's own copy of
clipcap_tpu/data/native_jpeg.py, over its own build of
native/jpeg_decoder.cpp; see _native.py).

One C call replaces the PIL decode -> BICUBIC resize -> center-crop host
path of the preprocessor (tools/preprocess.py, the rebuild of the
reference's create_dataset.py flow, reference README.md:5-22):
libjpeg decode with optional M/8 IDCT prescaling, PIL-style antialiased
cubic resampling (a = -0.5) fused with the crop, CHW output (float32 in
0..1, or uint8; normalization runs on the device).

Geometry matches data/preprocessing.clip_preprocess / blip_preprocess
exactly; pixel values differ only by PIL's fixed-point resampling
arithmetic plus, when ``use_dct_scale=True``, the IDCT-prescale
approximation. The library is built at first use with `g++ ... -ljpeg`;
without a compiler or libjpeg, ``available()`` is False and the decoders
raise ImportError.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import _native

MODE_CLIP = 0  # short-side resize + center crop (openai clip _transform)
MODE_BLIP = 1  # square resize (reference train.py:121)

# per-image status codes from the C side
OK = 0
ERR_BAD_ARGS = -1
ERR_DECODE = -2
ERR_COLOR_SPACE = -3  # e.g. CMYK: the caller falls back to PIL

_LINK = ("-ljpeg",)
_lib = None
_error: Optional[str] = None
_lock = threading.Lock()


def build_native() -> Optional[Path]:
    """Build the decoder library; its path, or None if it cannot be built."""
    try:
        return _native.build("jpeg_decoder", _LINK)
    except (OSError, RuntimeError):
        return None


def _load_lib():
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            try:
                lib = ctypes.CDLL(str(_native.build("jpeg_decoder", _LINK)))
            except (OSError, RuntimeError) as err:
                _error = str(err)
            else:
                _declare(lib)
                _lib = lib
                return lib
    raise ImportError(f"native JPEG decoder unavailable: {_error}")


def _declare(lib) -> None:
    u8p, f32p = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_float)
    szp, intp = ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)
    one = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    batch = [ctypes.c_char_p, szp, szp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int]
    for fn, args in ((lib.clip_jpeg_decode, one + [f32p]),
                     (lib.clip_jpeg_decode_u8, one + [u8p]),
                     (lib.clip_jpeg_decode_batch, batch + [f32p, intp]),
                     (lib.clip_jpeg_decode_batch_u8, batch + [u8p, intp])):
        fn.restype = ctypes.c_int
        fn.argtypes = args


def available() -> bool:
    try:
        _load_lib()
        return True
    except ImportError:
        return False


def decode_jpeg(data: bytes, image_size: int = 224, mode: int = MODE_CLIP,
                use_dct_scale: bool = True) -> np.ndarray:
    """Decode one JPEG -> [3, S, S] float32 in 0..1. Raises ValueError on
    undecodable input; :func:`decode_jpeg_or_none` returns None instead."""
    arr = decode_jpeg_or_none(data, image_size, mode, use_dct_scale)
    if arr is None:
        raise ValueError("native JPEG decode failed")
    return arr


def decode_jpeg_or_none(data: bytes, image_size: int = 224, mode: int = MODE_CLIP,
                        use_dct_scale: bool = True) -> Optional[np.ndarray]:
    lib = _load_lib()
    out = np.empty((3, image_size, image_size), np.float32)
    status = lib.clip_jpeg_decode(data, len(data), image_size, mode, int(use_dct_scale),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if status == OK else None


def decode_jpeg_u8_or_none(data: bytes, image_size: int = 224, mode: int = MODE_CLIP,
                           use_dct_scale: bool = True) -> Optional[np.ndarray]:
    """Decode one JPEG -> [3, S, S] uint8 (the C side rounds its float
    resample), or None on failure. uint8 is the preprocessor's transfer
    dtype: PIL's resize output is itself uint8, so nothing is lost, and it
    is a quarter of f32's bytes over PCIe."""
    lib = _load_lib()
    out = np.empty((3, image_size, image_size), np.uint8)
    status = lib.clip_jpeg_decode_u8(data, len(data), image_size, mode, int(use_dct_scale),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out if status == OK else None


def _batch(fn, datas: Sequence[bytes], image_size: int, mode: int, use_dct_scale: bool,
           n_threads: int, dtype, ctype):
    n = len(datas)
    blob = b"".join(datas)
    offsets = np.zeros(n, np.uintp)
    lens = np.asarray([len(d) for d in datas], np.uintp)
    if n > 1:
        np.cumsum(lens[:-1], out=offsets[1:])
    out = np.empty((n, 3, image_size, image_size), dtype)
    status = np.empty(n, np.int32)
    fn(blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
       lens.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)), n, image_size, mode,
       int(use_dct_scale), n_threads, out.ctypes.data_as(ctypes.POINTER(ctype)),
       status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, status


def decode_batch(datas: Sequence[bytes], image_size: int = 224, mode: int = MODE_CLIP,
                 use_dct_scale: bool = True, n_threads: int = 1):
    """Decode many JPEGs on `n_threads` native threads (no GIL in the C loop).
    Returns (out [N, 3, S, S] float32, status [N] int32); rows whose status
    is not OK are undefined and must be skipped or PIL-retried."""
    return _batch(_load_lib().clip_jpeg_decode_batch, datas, image_size, mode, use_dct_scale,
                  n_threads, np.float32, ctypes.c_float)


def decode_batch_u8(datas: Sequence[bytes], image_size: int = 224, mode: int = MODE_CLIP,
                    use_dct_scale: bool = True, n_threads: int = 1):
    """uint8 variant of :func:`decode_batch` (the preprocessor's transfer dtype)."""
    return _batch(_load_lib().clip_jpeg_decode_batch_u8, datas, image_size, mode,
                  use_dct_scale, n_threads, np.uint8, ctypes.c_ubyte)
