"""The port's tools/preprocess.py against the JAX package's, on the CPU.

Both packages get the same tiny CLIP ViT (swapped in for
`ViTConfig.clip_variant`, as tests/test_torch_cli.py does) from the same
OpenAI-layout state dict file, and preprocess the same seeded inputs:
two webdataset tars (with a PNG stored under the jpg key, which the
native decoder refuses and PIL decodes, and a sample without a caption,
which is skipped), a COCO json beside a folder of JPEGs, and a folder of
image/text pairs. Cases: native decode on and off, --quantize_int8,
--use_all_vit_features, a batch that does not divide the sample count and
a shard_size boundary inside a batch.

Token shards, sample and shard counts are equal; f32 prefixes match
within atol = rtol = 1e-5 (a ViT of two blocks in f32, summation order
only), and int8 prefixes within the int8 ViT bound of
tests/test_torch_quant.py (rtol = atol = 1e-5).
"""

import io
import json
import tarfile

import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.data import native_jpeg as JN
from clipcap_tpu.tools import preprocess as JP
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.data import native_jpeg as TN
from clipcap_tpu_torch.data.native_loader import NativeTokenPrefixDataset
from clipcap_tpu_torch.data.token_prefix import TokenPrefixDataset
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode
from clipcap_tpu_torch.tools import preprocess as TP

from test_torch_import_weights import openai_clip_state_dict

VIT = dict(image_size=32, patch_size=16, width=32, layers=2, heads=2, output_dim=16)
TEXT = dict(vocab_size=40, context_length=8, width=16, layers=1, heads=2, output_dim=16)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
INT8_TOL = dict(atol=1e-5, rtol=1e-5)
WORDS = ["a", "the", "cat", "photo", "of", "two", "dogs", "on", "red", "bus"]
N_WDS = 14  # of the 15 samples in the tars, those with both keys


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tiny_clip_variant(monkeypatch):
    for cfg in (JC.ViTConfig, TC.ViTConfig):
        monkeypatch.setattr(cfg, "clip_variant",
                            classmethod(lambda cls, name: cls(style="clip", **VIT)))


def _jpeg(rng, fmt="JPEG") -> bytes:
    from PIL import Image

    w, h = (int(x) for x in rng.integers(24, 72, size=2))
    small = rng.integers(0, 255, (h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.Resampling.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _caption(rng) -> str:
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), int(rng.integers(2, 9))))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("prep")
    rng = np.random.default_rng(0)
    base = list(bytes_to_unicode().values())
    merges = [("Ġ", "a"), ("c", "a"), ("ca", "t"), ("Ġ", "cat"), ("t", "h"), ("th", "e"),
              ("Ġ", "the")]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        base + ["".join(m) for m in merges] + ["<|endoftext|>"]))}
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (d / "vocab" / "merges.txt").write_text("\n".join(f"{a} {b}" for a, b in merges) + "\n")

    sd = openai_clip_state_dict(VIT, TEXT)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "clip.pt")

    (d / "wds").mkdir()
    idx = 0
    for shard, n in enumerate((8, 7)):
        with tarfile.open(d / "wds" / f"{shard:03d}.tar", "w") as tf:
            for j in range(n):
                members = {"jpg": _jpeg(rng, "PNG" if idx == 3 else "JPEG"),
                           "txt": _caption(rng).encode()}
                if idx == 5:  # no caption: the sample is skipped
                    del members["txt"]
                if idx == 9:  # an extra member the reader ignores
                    members["json"] = b"{}"
                for ext, data in members.items():
                    info = tarfile.TarInfo(f"{idx:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                idx += 1
    (d / "coco").mkdir()
    images, anns = [], []
    for i in range(6):
        (d / "coco" / f"im{i}.jpg").write_bytes(_jpeg(rng))
        images.append({"id": i, "file_name": f"im{i}.jpg"})
        for c in range(1 + i % 2):
            anns.append({"id": len(anns), "image_id": i, "caption": _caption(rng)})
    (d / "captions.json").write_text(json.dumps({"images": images, "annotations": anns}))
    (d / "files").mkdir()
    for i in range(7):
        (d / "files" / f"f{i}.jpg").write_bytes(_jpeg(rng))
        (d / "files" / f"f{i}.txt").write_text(_caption(rng) + "\n")
    return d


def _inputs(world, fmt):
    if fmt == "webdataset":
        return str(world / "wds" / "{000..001}.tar")
    if fmt == "coco":
        return f"{world / 'captions.json'}:{world / 'coco'}"
    return str(world / "files")


def _shards(out):
    names = sorted(p.name for p in (out / "prefixes").glob("*.npy"))
    assert names == sorted(p.name for p in (out / "tokens").glob("*.npy"))
    return ([np.load(out / "prefixes" / n) for n in names],
            [np.load(out / "tokens" / n) for n in names])


CASES = {
    "wds_native": dict(input_format="webdataset", batch_size=4, shard_size=6,
                       num_prepro_workers=2),
    "wds_pil": dict(input_format="webdataset", batch_size=4, shard_size=100,
                    use_native_jpeg=False),
    "wds_no_dct_scale": dict(input_format="webdataset", batch_size=5, shard_size=100,
                             native_dct_scale=False),
    "wds_int8": dict(input_format="webdataset", batch_size=4, shard_size=8,
                     quantize_int8=True, num_prepro_workers=3),
    "wds_all_features": dict(input_format="webdataset", batch_size=3, shard_size=5,
                             use_all_vit_features=True),
    "coco": dict(input_format="coco", batch_size=4, shard_size=100, max_token_length=6),
    "files": dict(input_format="files", batch_size=2, shard_size=3,
                  use_all_vit_features=True, quantize_int8=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches_jax(world, tmp_path, case):
    kw = dict(CASES[case])
    fmt = kw["input_format"]
    if kw.get("use_native_jpeg", True) and fmt == "webdataset":
        assert JN.available() and TN.available()
    common = dict(input_dataset=_inputs(world, fmt), clip_checkpoint=str(world / "clip.pt"),
                  tokenizer_vocab_dir=str(world / "vocab"), **kw)
    want = JP.preprocess_dataset(output_folder=str(tmp_path / "jax"), **common)
    got = TP.preprocess_dataset(output_folder=str(tmp_path / "port"), device="cpu", **common)
    assert (got["samples"], got["shards"]) == (want["samples"], want["shards"])
    n = {"webdataset": N_WDS, "coco": 9, "files": 7}[fmt]
    assert got["samples"] == n
    assert got["shards"] == -(-n // (-(-kw["shard_size"] // kw["batch_size"])
                                     * kw["batch_size"]))
    jp, jt = _shards(tmp_path / "jax")
    tp, tt = _shards(tmp_path / "port")
    assert len(tp) == got["shards"]
    for a, b in zip(tt, jt):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    width = kw.get("max_token_length", 128)
    assert all(t.shape[1] == width for t in tt)
    # -1 padding at 128, truncation at 6 (every caption has bos + 2 words + eos)
    assert (np.concatenate(tt) == -1).any() == (width == 128)
    tol = INT8_TOL if kw.get("quantize_int8") else F32_TOL
    for a, b in zip(tp, jp):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)
    rows = VIT["output_dim"] if not kw.get("use_all_vit_features") else None
    if rows is not None:
        assert tp[0].shape[1:] == (rows,)
    else:
        assert tp[0].shape[1:] == ((VIT["image_size"] // VIT["patch_size"]) ** 2 + 1,
                                   VIT["output_dim"])
    # the shards read back through both readers as equal batches
    py = iter(TokenPrefixDataset(str(tmp_path / "port"), batch_size=3))
    nat = NativeTokenPrefixDataset(str(tmp_path / "port"), batch_size=3)
    try:
        nat_it = iter(nat)
        for _ in range(4):
            (pt, pp), (nt, npf) = next(py), next(nat_it)
            np.testing.assert_array_equal(pt, nt)
            np.testing.assert_array_equal(pp.reshape(len(pp), -1), npf)
    finally:
        nat.close()


def test_int8_prefixes_near_f32(world, tmp_path):
    """The int8 encoder's prefixes stay within JAX's cosine bound (0.995)
    of the f32 encoder's on the same images."""
    common = dict(input_dataset=_inputs(world, "webdataset"),
                  clip_checkpoint=str(world / "clip.pt"),
                  tokenizer_vocab_dir=str(world / "vocab"), batch_size=8, device="cpu")
    TP.preprocess_dataset(output_folder=str(tmp_path / "f32"), **common)
    TP.preprocess_dataset(output_folder=str(tmp_path / "int8"), quantize_int8=True, **common)
    fp = np.concatenate(_shards(tmp_path / "f32")[0])
    q = np.concatenate(_shards(tmp_path / "int8")[0])
    cos = (fp * q).sum(-1) / (np.linalg.norm(fp, axis=-1) * np.linalg.norm(q, axis=-1))
    assert cos.min() > 0.995, cos


def test_random_weights_warn_and_main_takes_device(world, tmp_path, capsys):
    """No checkpoint: the JAX package's warning, seeded random weights (the
    same on every run; not jax.random's draws); main() takes --device."""
    args = ["--input_dataset", _inputs(world, "files"), "--input_format", "files",
            "--tokenizer_vocab_dir", str(world / "vocab"), "--batch_size", "4",
            "--device", "cpu"]
    stats = TP.main(args + ["--output_folder", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "WARNING: no --clip_checkpoint given; using random ViT weights" in out
    assert "preprocessed 7 samples into 1 shards" in out
    assert stats["samples"] == 7
    TP.main(args + ["--output_folder", str(tmp_path / "b")])
    a, b = _shards(tmp_path / "a"), _shards(tmp_path / "b")
    np.testing.assert_array_equal(a[0][0], b[0][0])
    np.testing.assert_array_equal(a[1][0], b[1][0])


def test_injected_encode_fn_gets_float_pixels(world, tmp_path):
    """An encode_fn without handles_uint8 receives pixels / 255 in 0..1, as
    in the JAX package; the pixels are the decoder's uint8 ones."""
    seen = []

    def encode_fn(pixels01):
        seen.append(pixels01.clone())
        return pixels01.reshape(len(pixels01), 3, -1).mean(-1)

    stats = TP.preprocess_dataset(_inputs(world, "files"), str(tmp_path / "o"),
                                  input_format="files", tokenizer_vocab_dir=str(world / "vocab"),
                                  encode_fn=encode_fn, image_size=16, batch_size=4,
                                  device="cpu")
    assert stats == dict(stats, samples=7, shards=1)
    px = torch.cat(seen)
    assert px.dtype == torch.float32 and px.shape == (7, 3, 16, 16)
    assert float(px.min()) >= 0.0 and float(px.max()) <= 1.0
    np.testing.assert_array_equal((px * 255).round().numpy(), (px * 255).numpy().round())
    with pytest.raises(ValueError, match="image_size"):
        TP.preprocess_dataset(_inputs(world, "files"), str(tmp_path / "x"),
                              input_format="files", tokenizer_vocab_dir=str(world / "vocab"),
                              encode_fn=encode_fn, device="cpu")
