"""The port's preprocessed-shard reader and dataset against the JAX
package's: the same shards give the same row ranges and the same batches,
exactly, with a batch overflowing across shard files, the wrap-around past
the last file, normalize_prefix, the round-robin MultiplePrefixDataset and
the errors for malformed shard sets."""

import itertools

import numpy as np
import pytest

from clipcap_tpu.data import npy_reader as JR
from clipcap_tpu.data import token_prefix as JT
from clipcap_tpu_torch.data import npy_reader as TR
from clipcap_tpu_torch.data import token_prefix as TT

ROWS = (7, 5, 9)  # three shard files; batches of 4 straddle every boundary


def _write(root, rows=ROWS, seed=0, width=6, tokens=5):
    rng = np.random.default_rng(seed)
    for i, n in enumerate(rows):
        TR.write_npy_shard(root / "prefixes" / f"{i:03d}.npy",
                           rng.normal(size=(n, width)).astype(np.float32))
        TR.write_npy_shard(root / "tokens" / f"{i:03d}.npy",
                           rng.integers(-1, 50, size=(n, tokens)).astype(np.int64))
    return root


@pytest.fixture
def shards(tmp_path):
    return _write(tmp_path / "shards")


@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
def test_reader_reads_both_npy_versions(tmp_path, version):
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    path = tmp_path / "v.npy"
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, version=version)
    assert TR.read_row_count(path) == 4
    with TR.NumpyShardReader(path) as r:
        np.testing.assert_array_equal(r.get_rows(1, 3), arr[1:3])


def test_reader_matches_jax(shards):
    path = shards / "prefixes" / "001.npy"
    assert TR.read_row_count(path) == JR.read_row_count(path) == ROWS[1]
    with TR.NumpyShardReader(path) as a, JR.NumpyShardReader(path) as b:
        assert (a.shape, a.dtype, a.num_rows) == (b.shape, b.dtype, b.num_rows)
        for lo, hi in ((0, 5), (2, 3), (4, 4)):
            np.testing.assert_array_equal(a.get_rows(lo, hi), b.get_rows(lo, hi))
        with pytest.raises(IndexError):
            a.get_rows(3, 6)


@pytest.mark.parametrize("batch_size,normalize", [(4, False), (4, True), (3, False), (21, False)])
def test_batches_match_jax(shards, batch_size, normalize):
    """Overflow across files (every batch size here straddles a boundary),
    wrap-around (30 batches run past the 21 rows several times), and the
    L2 normalization of the prefixes."""
    ours = TT.TokenPrefixDataset(str(shards), batch_size=batch_size, normalize_prefix=normalize)
    ref = JT.TokenPrefixDataset(str(shards), batch_size=batch_size, normalize_prefix=normalize)
    assert len(ours) == len(ref) == sum(ROWS) // batch_size
    for (ta, pa), (tb, pb) in itertools.islice(zip(ours, ref), 30):
        assert ta.dtype == tb.dtype == np.int64 and pa.dtype == pb.dtype == np.float32
        assert ta.shape[0] == pa.shape[0] == batch_size
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(pa, pb)
        if normalize:
            np.testing.assert_allclose(np.linalg.norm(pa, axis=-1), 1.0, rtol=1e-6)


def test_multiple_prefix_round_robin_matches_jax(shards, tmp_path):
    other = _write(tmp_path / "other", rows=(6,), seed=1)
    ours = TT.MultiplePrefixDataset(TT.TokenPrefixDataset(str(shards), 4),
                                    TT.TokenPrefixDataset(str(other), 4))
    ref = JT.MultiplePrefixDataset(JT.TokenPrefixDataset(str(shards), 4),
                                   JT.TokenPrefixDataset(str(other), 4))
    assert len(ours) == len(ref)
    for (ta, pa), (tb, pb) in itertools.islice(zip(ours, ref), 12):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(pa, pb)


def test_malformed_shard_sets_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        TT.TokenPrefixDataset(str(tmp_path))
    _write(tmp_path / "a")
    (tmp_path / "a" / "tokens" / "002.npy").unlink()
    with pytest.raises(ValueError, match="shard count mismatch"):
        TT.TokenPrefixDataset(str(tmp_path / "a"))
    _write(tmp_path / "b", rows=(4,))
    TR.write_npy_shard(tmp_path / "b" / "tokens" / "000.npy", np.zeros((3, 5), np.int64))
    with pytest.raises(ValueError, match="row mismatch"):
        next(iter(TT.TokenPrefixDataset(str(tmp_path / "b"), batch_size=2)))
