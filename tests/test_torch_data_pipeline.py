"""The port's data pipeline against the JAX package's, on the CPU: the
native JPEG decoder (its own build of native/jpeg_decoder.cpp) gives the
JAX binding's arrays bit for bit and keeps the bounds of
tests/test_native_jpeg.py against PIL; the native shard loader gives
TokenPrefixDataset's batches (tests/test_native_loader.py's cases);
webdataset reading and brace expansion equal JAX's; device_prefetch keeps
order, the sentinel, the drain on close, and raises the iterator's error.
"""

import io
import sys
import tarfile
import threading

import numpy as np
import pytest
import torch

from clipcap_tpu.data import native_jpeg as JN
from clipcap_tpu.data import webdataset as JW
from clipcap_tpu_torch.data import _native
from clipcap_tpu_torch.data import native_jpeg as TN
from clipcap_tpu_torch.data import webdataset as TW
from clipcap_tpu_torch.data import TokenPrefixDataset, write_npy_shard
from clipcap_tpu_torch.data.native_loader import (NativeTokenPrefixDataset, build_native,
                                                  make_token_prefix_dataset)
from clipcap_tpu_torch.data.pipeline import device_prefetch, to_device
from clipcap_tpu_torch.data.preprocessing import (blip_preprocess, clip_preprocess,
                                                  clip_preprocess_u8)


def _jpeg_bytes(rng, w, h, quality=92, smooth=True):
    from PIL import Image

    if smooth:
        # low-frequency content: it JPEG-compresses faithfully, so the
        # native-vs-PIL comparison isolates the resampling error
        small = rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.Resampling.BILINEAR)
    else:
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _pil_reference(data, image_size):
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    return clip_preprocess(img, image_size=image_size, do_normalize=False)


# --- the native JPEG decoder ---------------------------------------------------------


def test_native_jpeg_builds_its_own_library():
    """The port's library lies under the git-ignored build/, never in native/."""
    assert TN.available()
    path = TN.build_native()
    assert path is not None and path.exists() and path.parent == _native.BUILD_DIR
    root = _native.NATIVE_SRC.parent
    assert path.relative_to(root).parts[:2] == ("build", "clipcap_tpu_torch")


@pytest.mark.parametrize("dct", [False, True])
@pytest.mark.parametrize("w,h", [(640, 480), (480, 640), (300, 300), (224, 224), (1280, 960)])
def test_native_decode_bit_equal_to_jax_binding(w, h, dct):
    rng = np.random.default_rng(w * 7 + h)
    data = _jpeg_bytes(rng, w, h, smooth=w != 300)
    np.testing.assert_array_equal(TN.decode_jpeg(data, 224, TN.MODE_CLIP, use_dct_scale=dct),
                                  JN.decode_jpeg(data, 224, JN.MODE_CLIP, use_dct_scale=dct))
    np.testing.assert_array_equal(TN.decode_jpeg_u8_or_none(data, 224, use_dct_scale=dct),
                                  JN.decode_jpeg_u8_or_none(data, 224, use_dct_scale=dct))
    np.testing.assert_array_equal(TN.decode_jpeg(data, 96, TN.MODE_BLIP, use_dct_scale=dct),
                                  JN.decode_jpeg(data, 96, JN.MODE_BLIP, use_dct_scale=dct))


@pytest.mark.parametrize("w,h", [(640, 480), (480, 640), (300, 300), (224, 224)])
def test_parity_no_dct_scale(w, h):
    """Exact geometry: only PIL's fixed-point resample coefficients differ."""
    rng = np.random.default_rng(w * 1000 + h)
    data = _jpeg_bytes(rng, w, h)
    ref = _pil_reference(data, 224)
    got = TN.decode_jpeg(data, 224, TN.MODE_CLIP, use_dct_scale=False)
    assert got.shape == (3, 224, 224) and got.dtype == np.float32
    diff = np.abs(got - ref)
    assert diff.max() <= 6 / 255, diff.max()
    assert diff.mean() <= 1 / 255, diff.mean()


def test_parity_dct_scale_bounded():
    rng = np.random.default_rng(7)
    data = _jpeg_bytes(rng, 1280, 960)
    diff = np.abs(TN.decode_jpeg(data, 224, use_dct_scale=True) - _pil_reference(data, 224))
    assert diff.mean() <= 4 / 255, diff.mean()
    assert diff.max() <= 40 / 255, diff.max()


def test_u8_matches_float_rounding_and_pil_helper():
    from PIL import Image

    rng = np.random.default_rng(3)
    data = _jpeg_bytes(rng, 500, 400)
    f = TN.decode_jpeg(data, 224, use_dct_scale=False)
    u = TN.decode_jpeg_u8_or_none(data, 224, use_dct_scale=False)
    assert u is not None and u.dtype == np.uint8
    assert np.abs(u.astype(np.float32) / 255.0 - f).max() <= 0.51 / 255
    img = Image.fromarray(rng.integers(0, 255, (480, 640, 3), dtype=np.uint8))
    np.testing.assert_array_equal(clip_preprocess_u8(img, 224), np.round(
        clip_preprocess(img, 224, do_normalize=False) * 255).astype(np.uint8))


def test_batch_threaded_matches_single_and_jax():
    rng = np.random.default_rng(5)
    datas = [_jpeg_bytes(rng, 256 + 32 * i, 256, smooth=False) for i in range(6)]
    out, status = TN.decode_batch(datas, 128, n_threads=3, use_dct_scale=True)
    assert status.tolist() == [0] * 6 and out.dtype == np.float32
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(out[i], TN.decode_jpeg(d, 128, use_dct_scale=True))
    out_u8, status_u8 = TN.decode_batch_u8(datas, 128, n_threads=3, use_dct_scale=True)
    assert status_u8.tolist() == [0] * 6
    assert np.abs(out_u8.astype(np.float32) / 255 - out).max() <= 0.5 / 255
    want, want_status = JN.decode_batch_u8(datas, 128, n_threads=2, use_dct_scale=True)
    np.testing.assert_array_equal(out_u8, want)
    np.testing.assert_array_equal(status_u8, want_status)


def test_corrupt_and_exotic_inputs_fail_cleanly():
    from PIL import Image

    assert TN.decode_jpeg_or_none(b"not a jpeg", 224) is None
    assert TN.decode_jpeg_u8_or_none(b"\xff\xd8\xff\xe0garbage", 224) is None
    rng = np.random.default_rng(9)
    data = _jpeg_bytes(rng, 320, 240)
    assert TN.decode_jpeg_or_none(data[: len(data) // 3], 224) is None
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).convert(
        "CMYK").save(buf, format="JPEG")
    assert TN.decode_jpeg_or_none(buf.getvalue(), 224) is None
    with pytest.raises(ValueError):
        TN.decode_jpeg(b"", 224)
    out, status = TN.decode_batch_u8([data, b"junk", buf.getvalue()], 64, n_threads=2)
    assert status[0] == TN.OK and status[1] == TN.ERR_DECODE
    assert status[2] == TN.ERR_COLOR_SPACE
    assert (TN.MODE_CLIP, TN.MODE_BLIP, TN.ERR_BAD_ARGS) == (JN.MODE_CLIP, JN.MODE_BLIP,
                                                             JN.ERR_BAD_ARGS)


def test_blip_mode_square_resize():
    from PIL import Image

    rng = np.random.default_rng(13)
    data = _jpeg_bytes(rng, 400, 300)
    ref = blip_preprocess(Image.open(io.BytesIO(data)).convert("RGB"), image_size=96,
                          do_normalize=False)
    got = TN.decode_jpeg(data, 96, TN.MODE_BLIP, use_dct_scale=False)
    assert np.abs(got - ref).max() <= 6 / 255


def test_concurrent_builds_load_one_whole_library(tmp_path, monkeypatch):
    """Builds racing in several threads (each holds the file lock, writes a
    temporary file and renames it into place) leave one library, whole."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    paths, errors = [], []

    def run():
        try:
            paths.append(_native.build("npy_loader"))
        except Exception as err:  # recorded, and the test fails below
            errors.append(err)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(set(paths)) == 1 and paths[0].exists()
    assert sorted(p.suffix for p in (tmp_path / "native").iterdir()) == [".lock", ".so"]


# --- the native shard loader ---------------------------------------------------------


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_shards")
    rng = np.random.default_rng(0)
    offset = 0
    for i, r in enumerate([7, 5, 3]):
        prefix = rng.normal(size=(r, 6)).astype(np.float32)
        prefix[:, 0] = np.arange(offset, offset + r)
        tokens = rng.integers(-1, 100, size=(r, 4)).astype(np.int64)
        tokens[:, 0] = np.arange(offset, offset + r)
        write_npy_shard(d / "prefixes" / f"{i:03d}.npy", prefix)
        write_npy_shard(d / "tokens" / f"{i:03d}.npy", tokens)
        offset += r
    return d


def test_loader_build():
    assert build_native() is not None


def test_native_loader_matches_python(shard_dir):
    py = TokenPrefixDataset(str(shard_dir), batch_size=4)
    nat = NativeTokenPrefixDataset(str(shard_dir), batch_size=4)
    assert len(py) == len(nat)
    py_it, nat_it = iter(py), iter(nat)
    for _ in range(10):  # several wraps over 15 samples
        pt, pp = next(py_it)
        nt, np_ = next(nat_it)
        np.testing.assert_array_equal(pt, nt)
        np.testing.assert_array_equal(pp, np_)
    nat.close()


def test_native_loader_normalize(shard_dir):
    nat = NativeTokenPrefixDataset(str(shard_dir), batch_size=3, normalize_prefix=True)
    _, prefixes = next(iter(nat))
    np.testing.assert_allclose(np.linalg.norm(prefixes, axis=-1), 1.0, atol=1e-5)
    nat.close()


def test_factory_native_and_fallback(shard_dir, monkeypatch):
    ds = make_token_prefix_dataset(str(shard_dir), batch_size=2)
    assert isinstance(ds, NativeTokenPrefixDataset)
    tokens, prefixes = next(iter(ds))
    assert tokens.shape == (2, 4) and prefixes.shape == (2, 6)
    ds.close()
    # the Python reader when the library cannot be built
    from clipcap_tpu_torch.data import native_loader

    monkeypatch.setattr(native_loader, "_load_lib", lambda: None)
    ds = make_token_prefix_dataset(str(shard_dir), batch_size=2)
    assert isinstance(ds, TokenPrefixDataset)
    np.testing.assert_array_equal(next(iter(ds))[0], tokens)


def _write_pair(d, name, rows, pw=6, tw=4):
    rng = np.random.default_rng(rows)
    write_npy_shard(d / "prefixes" / name, rng.normal(size=(rows, pw)).astype(np.float32))
    write_npy_shard(d / "tokens" / name, rng.integers(0, 9, size=(rows, tw)).astype(np.int64))


@pytest.mark.parametrize("bad", ["width", "dtype"])
def test_mismatched_shards_rejected(tmp_path, bad):
    d = tmp_path / bad
    _write_pair(d, "000.npy", 5)
    if bad == "width":
        _write_pair(d, "001.npy", 5, pw=8)
    else:
        rng = np.random.default_rng(1)
        write_npy_shard(d / "prefixes" / "001.npy", rng.normal(size=(5, 6)).astype(np.float64))
        write_npy_shard(d / "tokens" / "001.npy",
                        rng.integers(0, 9, size=(5, 4)).astype(np.int64))
    with pytest.raises(FileNotFoundError):
        NativeTokenPrefixDataset(str(d), batch_size=2)


def test_truncated_shard_ends_iteration(tmp_path):
    d = tmp_path / "truncated"
    _write_pair(d, "000.npy", 8)
    tok = d / "tokens" / "000.npy"
    data = tok.read_bytes()
    tok.write_bytes(data[: len(data) - 2 * 4 * 8])
    ds = NativeTokenPrefixDataset(str(d), batch_size=8)
    with pytest.raises(StopIteration):
        next(iter(ds))
    ds.close()


# --- webdataset ----------------------------------------------------------------------


def test_brace_expand():
    assert TW.brace_expand("x/{000..002}.tar") == ["x/000.tar", "x/001.tar", "x/002.tar"]
    assert TW.brace_expand("plain.tar") == ["plain.tar"]
    for pat in ("a/{7..11}.tar", "{0001..0003}-x.tar", "no{braces}.tar"):
        assert TW.brace_expand(pat) == JW.brace_expand(pat)


def test_iter_samples_equal_jax(tmp_path):
    """Members grouped by key, samples without a requested key skipped,
    directories and dotless names ignored, in shard order."""
    rng = np.random.default_rng(2)
    layout = [[("a", "jpg"), ("a", "txt"), ("b", "jpg"), ("c", "txt"), ("c", "jpg")],
              [("d", "jpg"), ("d", "txt"), ("d", "json"), ("noext", None), ("e", "txt")]]
    for i, members in enumerate(layout):
        with tarfile.open(tmp_path / f"{i:02d}.tar", "w") as tf:
            dirinfo = tarfile.TarInfo("sub")
            dirinfo.type = tarfile.DIRTYPE
            tf.addfile(dirinfo)
            for key, ext in members:
                data = rng.bytes(int(rng.integers(1, 20)))
                info = tarfile.TarInfo(f"sub/{key}.{ext}" if ext else f"sub/{key}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    pattern = str(tmp_path / "{00..01}.tar")
    for keys in (("jpg", "txt"), ("jpg",), ("json",)):
        got = list(TW.iter_samples(pattern, keys=keys))
        assert got == list(JW.iter_samples(pattern, keys=keys))
    assert [s["__key__"] for s in TW.iter_samples(pattern)] == ["a", "c", "d"]


# --- device_prefetch -----------------------------------------------------------------


def test_device_prefetch_pipeline():
    def batches():
        for i in range(5):
            yield {"x": np.full((2, 2), i, np.float32), "meta": ("id", np.arange(i + 1))}

    got = list(device_prefetch(batches(), size=2, device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), np.full((2, 2), i))
        assert b["meta"][0] == "id" and torch.equal(b["meta"][1], torch.arange(i + 1))


def test_device_prefetch_custom_transfer_close_and_error():
    seen = []
    it = device_prefetch(iter(range(100)), size=2, transfer=lambda x: seen.append(x) or -x,
                         device="cpu")
    assert [next(it) for _ in range(3)] == [0, -1, -2]
    it.close()  # stop + drain: the worker leaves at its next item
    assert len(seen) < 100

    def failing():
        yield np.zeros(1)
        raise KeyError("bad shard")

    it = device_prefetch(failing(), device="cpu")
    assert next(it).shape == (1,)
    with pytest.raises(KeyError, match="bad shard"):
        next(it)


def test_device_prefetch_stress_keeps_order():
    """More producers' items than queue slots, a short switch interval: the
    consumer sees every batch once, in order."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = [int(b[0]) for b in device_prefetch((np.full(3, i) for i in range(500)), size=1,
                                                  device="cpu")]
    finally:
        sys.setswitchinterval(before)
    assert got == list(range(500))
    assert to_device({"a": [np.ones(2)]}, "cpu")["a"][0].dtype == torch.float64
