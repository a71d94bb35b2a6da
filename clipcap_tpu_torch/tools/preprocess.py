"""Dataset preprocessor: images + captions -> {prefixes,tokens}/*.npy shards
on the card (the port of clipcap_tpu/tools/preprocess.py).

This rebuilds the `create_dataset.py` CLI the reference documents but no
longer contains (README.md:5-22 documents
`--input_dataset "./webdataset/{000..123}.tar" --input_format webdataset
 --wds_image_key jpg --wds_caption_key txt --clip_model ViT-B/32
 --batch_size 1024 ...`; the fork kept only the Dataset classes,
create_dataset.py:1). Output layout matches what TokenPrefixDataset reads
(reference dataset.py:86-90): `{out}/prefixes/NNNNN.npy` (f32 CLIP
embeddings) + `{out}/tokens/NNNNN.npy` (int64, -1-padded).

The path: host threads decode and resize each image (the native libjpeg
decoder, data/native_jpeg.py, with PIL for each image it refuses) and
tokenize its caption; each batch of CHW uint8 pixels (lossless, since
PIL's resize output is itself uint8, and a quarter of f32's bytes over
PCIe) is copied from pinned memory to the card and encoded there, the
/255 and CLIP's normalization included, once per batch, by the CLIP ViT
(K1 in every block). Results stay in order whatever the number of
upload threads, and shards are written every `shard_size` samples.

    python -m clipcap_tpu_torch.tools.preprocess --input_dataset "tars/{000..001}.tar" \
        --output_folder out --tokenizer_vocab_dir gpt2_vocab \
        --clip_checkpoint ViT-B-32.pt --batch_size 1024 --num_prepro_workers 8
"""

from __future__ import annotations

import argparse
import io
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import ViTConfig
from ..data import native_jpeg
from ..data.coco import CocoJsonIndex, FileFolderIndex, pad_tokens
from ..data.npy_reader import write_npy_shard
from ..data.preprocessing import clip_preprocess_u8, normalize_on_device
from ..data.webdataset import iter_samples


def _decode_image(data: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(data)).convert("RGB")


def iter_pairs(input_dataset: str, input_format: str, wds_image_key: str,
               wds_caption_key: str) -> Iterator[Tuple[object, str]]:
    """Yield (image, caption) pairs from any supported input format.

    webdataset yields the image as raw encoded bytes (the decoder choice,
    native libjpeg or PIL, happens in the worker so threads overlap);
    coco/files yield PIL images."""
    if input_format == "webdataset":
        for sample in iter_samples(input_dataset, keys=(wds_image_key, wds_caption_key)):
            yield sample[wds_image_key], sample[wds_caption_key].decode("utf-8",
                                                                        errors="replace")
    elif input_format in ("coco", "files"):
        from PIL import Image

        if input_format == "coco":
            json_path, image_folder = input_dataset.split(":", 1)
            index = CocoJsonIndex(json_path)
            folder = Path(image_folder)
        else:
            index = FileFolderIndex(input_dataset)
            folder = None
        for i in range(len(index)):
            entry = index[i]
            path = Path(entry.image.file_name)
            if folder is not None:
                path = folder / path
            try:
                img = Image.open(path).convert("RGB")
            except Exception as err:
                print(f"Failed to load image '{path}' ({err}). Skipping.")
                continue
            yield img, entry.caption
    else:
        raise ValueError(f"unknown input_format {input_format!r}")


def make_clip_encoder(clip_model: str, checkpoint: Optional[str], pooled: bool,
                      quantize_int8: bool = False, device="cuda"):
    """The CLIP image encoder on `device`: encode(pixels [B, 3, S, S] uint8
    or float 0..1 on the device) -> features. Weights come from an OpenAI
    (keys `visual.*`) or HF CLIP state dict (.pth/.bin or .npz); with no
    checkpoint they are seeded random ones (pipeline testing; the draws
    are not the JAX package's). `quantize_int8` gives the int8 encoder
    (models/vit.quantize_params: int8 linears, attention still K1 in f32)."""
    from .. import convert
    from ..cli.loading import load_state_dict
    from ..models import vit
    from .import_weights import clip_vit_from_hf_state_dict, clip_vit_from_openai_state_dict

    cfg = ViTConfig.clip_variant(clip_model)
    model = vit.ViT(cfg, device=device, seed=0)
    if checkpoint:
        sd = load_state_dict(checkpoint)
        if any(k.startswith("visual.") for k in sd):
            model = convert.load(model, clip_vit_from_openai_state_dict(sd, cfg))
        else:
            model = convert.load(model, clip_vit_from_hf_state_dict(sd, cfg))
    else:
        print("WARNING: no --clip_checkpoint given; using random ViT weights")
    model.requires_grad_(False)
    if quantize_int8:
        model = vit.quantize_params(model)

    mode = "pooled" if pooled else "tokens_proj"
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python scalar
    scale = torch.tensor(255.0, device=device)

    def encode(pixels: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if pixels.dtype == torch.uint8:
                pixels = pixels.float() / scale
            return model(normalize_on_device(pixels), output=mode)

    encode.handles_uint8 = True  # preprocess_dataset skips its /255 wrapper
    return encode, cfg


def _ordered_map(pool: ThreadPoolExecutor, fn: Callable, items: Iterable,
                 window: int) -> Iterator:
    """pool.map(fn, items) in order, with at most `window` items submitted
    ahead: Executor.map submits the whole iterable at once, which would
    hold a whole dataset's decoded pixels in memory."""
    pending: deque = deque()
    for item in items:
        pending.append(pool.submit(fn, item))
        if len(pending) >= window:
            yield pending.popleft().result()
    while pending:
        yield pending.popleft().result()


def preprocess_dataset(
    input_dataset: str,
    output_folder: str,
    input_format: str = "webdataset",
    wds_image_key: str = "jpg",
    wds_caption_key: str = "txt",
    clip_model: str = "ViT-B/32",
    clip_checkpoint: Optional[str] = None,
    tokenizer_model_type: str = "gpt2",
    tokenizer_vocab_dir: Optional[str] = None,
    tokenizer=None,
    batch_size: int = 256,
    max_token_length: int = 128,
    shard_size: int = 10000,
    use_all_vit_features: bool = False,
    encode_fn: Optional[Callable] = None,
    image_size: Optional[int] = None,
    num_prepro_workers: int = 0,
    quantize_int8: bool = False,
    use_native_jpeg: bool = True,
    native_dct_scale: bool = True,
    upload_workers: int = 1,
    device="cuda",
) -> dict:
    """Run preprocessing; returns {"samples": n, "shards": k, "ips": rate}.
    An injected `encode_fn` takes float pixels in 0..1 on `device` (unless
    it has `handles_uint8`) and needs `image_size`."""
    device = torch.device(device)
    if tokenizer is None:
        from ..tokenizers import create_tokenizer

        tokenizer = create_tokenizer(tokenizer_model_type, tokenizer_vocab_dir)
    if encode_fn is None:
        encode_fn, vit_cfg = make_clip_encoder(clip_model, clip_checkpoint,
                                               pooled=not use_all_vit_features,
                                               quantize_int8=quantize_int8, device=device)
        image_size = image_size or vit_cfg.image_size
    if image_size is None:
        raise ValueError("image_size is required with an injected encode_fn")

    out = Path(output_folder)
    (out / "prefixes").mkdir(parents=True, exist_ok=True)
    (out / "tokens").mkdir(parents=True, exist_ok=True)

    if getattr(encode_fn, "handles_uint8", False):
        encode_u8 = encode_fn
    else:
        raw_encode, scale = encode_fn, torch.tensor(255.0, device=device)

        def encode_u8(px_u8: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return raw_encode(px_u8.float() / scale)

    def upload_encode(pixels: np.ndarray) -> torch.Tensor:
        # runs on an uploader thread; returns as soon as the encode is queued
        # on the card, so the copy and encode overlap the host's decode
        x = torch.from_numpy(pixels)
        if device.type == "cuda":
            x = x.pin_memory()
        return encode_u8(x.to(device, non_blocking=True))

    shard_prefixes: List[Future] = []
    shard_tokens: List[np.ndarray] = []
    shard_in_flight = 0
    shard_idx = 0
    n_samples = 0
    t0 = time.perf_counter()

    # results stay ordered whatever the worker count: shard_prefixes holds
    # futures in submit order and flush() reads them in order
    uploader = ThreadPoolExecutor(max_workers=max(1, upload_workers))
    decoders = ThreadPoolExecutor(max_workers=num_prepro_workers) if num_prepro_workers else None

    def flush():
        nonlocal shard_idx, shard_prefixes, shard_tokens, shard_in_flight
        if not shard_prefixes:
            return
        # the one device -> host copy of a shard's features: reading them here
        # (not per batch) keeps copy and encode pipelined with the decode
        write_npy_shard(out / "prefixes" / f"{shard_idx:05d}.npy",
                        np.concatenate([f.result().to(torch.float32).cpu().numpy()
                                        for f in shard_prefixes], axis=0))
        write_npy_shard(out / "tokens" / f"{shard_idx:05d}.npy",
                        np.concatenate(shard_tokens, axis=0))
        shard_idx += 1
        shard_prefixes, shard_tokens = [], []
        shard_in_flight = 0

    batch_imgs, batch_toks = [], []
    inflight: deque = deque()  # backpressure: pixel batches queued on the uploader

    def run_batch():
        nonlocal batch_imgs, batch_toks, n_samples, shard_in_flight
        if not batch_imgs:
            return
        fut = uploader.submit(upload_encode, np.stack(batch_imgs))
        shard_prefixes.append(fut)
        inflight.append(fut)
        while len(inflight) > 4:  # ~4 batches of pixels held at most
            inflight.popleft().result()
        shard_tokens.append(np.stack(batch_toks))
        n_samples += len(batch_imgs)
        shard_in_flight += len(batch_imgs)
        batch_imgs, batch_toks = [], []

    native_decode = None
    if use_native_jpeg and native_jpeg.available():
        def native_decode(data):
            return native_jpeg.decode_jpeg_u8_or_none(data, image_size, native_jpeg.MODE_CLIP,
                                                      use_dct_scale=native_dct_scale)

    def prep(pair):
        img, caption = pair
        if isinstance(img, (bytes, bytearray)):
            pixels = native_decode(img) if native_decode is not None else None
            if pixels is None:  # non-JPEG / exotic colorspace / corrupt
                try:
                    img = _decode_image(img)
                except Exception as err:
                    print(f"Failed to decode sample: {err}. Skipping.")
                    return None
                pixels = clip_preprocess_u8(img, image_size=image_size)
        else:
            pixels = clip_preprocess_u8(img, image_size=image_size)
        toks = tokenizer.encode_text(caption, max_token_length=max_token_length,
                                     add_bos=True, add_eos=True)
        return pixels, pad_tokens(toks, max_token_length)

    pairs = iter_pairs(input_dataset, input_format, wds_image_key, wds_caption_key)
    # parallel host decode and resize (the reference README's
    # --num_prepro_workers, README.md:13): both decoders release the GIL
    prepped = (map(prep, pairs) if decoders is None
               else _ordered_map(decoders, prep, pairs, window=2 * max(batch_size, 8)))
    try:
        for item in prepped:
            if item is None:
                continue
            pixels, toks = item
            batch_imgs.append(pixels)
            batch_toks.append(toks)
            if len(batch_imgs) >= batch_size:
                run_batch()
                if shard_in_flight >= shard_size:
                    flush()
        run_batch()
        flush()
    finally:
        if decoders is not None:
            decoders.shutdown(cancel_futures=True)
        uploader.shutdown()
    dt = max(time.perf_counter() - t0, 1e-9)
    stats = {"samples": n_samples, "shards": shard_idx, "ips": n_samples / dt}
    print(f"preprocessed {n_samples} samples into {shard_idx} shards "
          f"({stats['ips']:.1f} images/sec)")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="images+captions -> npy shards")
    p.add_argument("--input_dataset", required=True,
                   help='tar pattern "{000..123}.tar", "captions.json:/images" (coco), '
                        'or folder (files)')
    p.add_argument("--output_folder", required=True)
    p.add_argument("--input_format", default="webdataset",
                   choices=["webdataset", "coco", "files"])
    p.add_argument("--wds_image_key", default="jpg")
    p.add_argument("--wds_caption_key", default="txt")
    p.add_argument("--clip_model", default="ViT-B/32")
    p.add_argument("--clip_checkpoint", default=None)
    p.add_argument("--tokenizer_model_type", default="gpt2")
    p.add_argument("--tokenizer_vocab_dir", required=True)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--num_prepro_workers", type=int, default=0)
    p.add_argument("--max_token_length", type=int, default=128)
    p.add_argument("--shard_size", type=int, default=10000)
    p.add_argument("--use_all_vit_features", action="store_true")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8-quantize the frozen encoder (int8 linears, f32 attention)")
    p.add_argument("--no_native_jpeg", dest="use_native_jpeg", action="store_false",
                   help="force the PIL decode path (native libjpeg is the default when it "
                        "builds)")
    p.add_argument("--no_dct_scale", dest="native_dct_scale", action="store_false",
                   help="disable the native decoder's M/8 IDCT prescale (exact-PIL-geometry "
                        "pixels, slower)")
    p.add_argument("--upload_workers", type=int, default=1,
                   help="concurrent host->device pixel uploads (results stay ordered)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return preprocess_dataset(**vars(args))


if __name__ == "__main__":
    main()
