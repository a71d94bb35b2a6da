"""Image preprocessing (port of clipcap_tpu/data/preprocessing.py).

The reference's two transforms, as host numpy over PIL images:
- BLIP (reference train.py:119-130): BICUBIC resize to (S, S), to-tensor,
  normalise with CLIP's statistics;
- CLIP (what `clip.load` returns): BICUBIC resize of the short side to S,
  centre crop S, normalise with the same statistics.

PIL is imported inside the functions that take an image, so the module
imports without it. `normalize_on_device` normalises pixels already on
the device.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _bicubic():
    from PIL import Image

    return Image.Resampling.BICUBIC


def to_chw_float(image) -> np.ndarray:
    arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
    return arr.transpose(2, 0, 1)  # [3, H, W]


def normalize(arr_chw: np.ndarray) -> np.ndarray:
    return (arr_chw - CLIP_MEAN[:, None, None]) / CLIP_STD[:, None, None]


def blip_preprocess(image, image_size: int = 384, do_normalize: bool = True) -> np.ndarray:
    """Square BICUBIC resize (reference train.py:121) -> [3, S, S] f32."""
    image = image.convert("RGB").resize((image_size, image_size), _bicubic())
    arr = to_chw_float(image)
    return normalize(arr) if do_normalize else arr


def _clip_geometry(image, image_size: int):
    """Short side resized to image_size (BICUBIC), then the centre crop."""
    image = image.convert("RGB")
    w, h = image.size
    scale = image_size / min(w, h)
    new_w, new_h = round(w * scale), round(h * scale)
    image = image.resize((new_w, new_h), _bicubic())
    left = (new_w - image_size) // 2
    top = (new_h - image_size) // 2
    return image.crop((left, top, left + image_size, top + image_size))


def clip_preprocess(image, image_size: int = 224, do_normalize: bool = True) -> np.ndarray:
    """Short-side resize + centre crop (openai clip _transform) -> [3, S, S] f32."""
    arr = to_chw_float(_clip_geometry(image, image_size))
    return normalize(arr) if do_normalize else arr


def clip_preprocess_u8(image, image_size: int = 224) -> np.ndarray:
    """clip_preprocess's geometry -> CHW uint8: exactly
    clip_preprocess(..., do_normalize=False) * 255, since PIL's resize
    output is uint8."""
    return np.asarray(_clip_geometry(image, image_size), np.uint8).transpose(2, 0, 1)


def normalize_on_device(pixels: torch.Tensor) -> torch.Tensor:
    """(pixels - mean) / std with CLIP's statistics, for pixels [..., 3, H, W] in 0..1."""
    mean = torch.from_numpy(CLIP_MEAN).to(pixels.device)[:, None, None]
    std = torch.from_numpy(CLIP_STD).to(pixels.device)[:, None, None]
    return (pixels - mean) / std
