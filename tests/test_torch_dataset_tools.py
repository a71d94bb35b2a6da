"""The port's host-only dataset tools against the JAX package's
(tests/test_aux_tools.py's cases), on the CPU: file_hashes' indexes and
merged captions, len_distribution's word counts, merge_shards' layout and
resize_images' PNGs equal JAX's on the same inputs; tools/profile_decode
runs both of its paths on a tiny GPT-2 on the CPU."""

import csv
import json

import numpy as np
import pytest

from clipcap_tpu.tools import file_hashes as JFH
from clipcap_tpu.tools import len_distribution as JLD
from clipcap_tpu.tools import merge_shards as JMS
from clipcap_tpu.tools import resize_images as JRI
from clipcap_tpu_torch.data.npy_reader import write_npy_shard
from clipcap_tpu_torch.tools import file_hashes as TFH
from clipcap_tpu_torch.tools import len_distribution as TLD
from clipcap_tpu_torch.tools import merge_shards as TMS
from clipcap_tpu_torch.tools import resize_images as TRI


def _img(path, seed, size=(8, 8)):
    from PIL import Image

    r = np.random.default_rng(seed)
    Image.fromarray(r.integers(0, 255, (*size, 3), dtype=np.uint8)).save(path)


@pytest.fixture
def hash_world(tmp_path):
    coco_dir, src_dir, val_dir = (tmp_path / n for n in ("coco", "scrape", "val"))
    for d in (coco_dir, src_dir, val_dir):
        d.mkdir()
    _img(coco_dir / "a.png", 1)
    _img(src_dir / "a_copy.png", 1)  # same bytes as coco a
    (src_dir / "a_copy.txt").write_text("folder caption  for a")
    _img(src_dir / "b.png", 2)
    (src_dir / "b.txt").write_text("caption b")
    _img(src_dir / "leak.png", 3)
    (src_dir / "leak.txt").write_text("leaked val image")
    _img(src_dir / "nocap.png", 4)  # no caption anywhere: left out
    (src_dir / "sub").mkdir()
    _img(src_dir / "sub" / "c.jpg", 5)
    (src_dir / "sub" / "c.txt").write_text("c\na\nt")  # one character a line
    _img(val_dir / "val1.png", 3)  # same bytes as leak.png
    ann = {"images": [{"id": 0, "file_name": "a.png"}],
           "annotations": [{"image_id": 0, "id": 0, "caption": "coco caption a"},
                           {"image_id": 0, "id": 1, "caption": "folder caption for a"}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    return tmp_path


@pytest.mark.parametrize("with_val", [True, False])
def test_file_hashes_match_jax(hash_world, with_val):
    d = hash_world
    outs = {}
    for name, mod in (("jax", JFH), ("port", TFH)):
        for sub in ("coco", "scrape", "val"):
            mod.store_index(str(d / sub), str(d / f"{name}_{sub}.idx"))
        mod.add_dir_to_index(str(d / f"{name}_coco.idx"), str(d / "val"),
                             str(d / f"{name}_both.idx"))
        outs[name] = mod.merge_captions(
            str(d / "ann.json"), str(d / "coco"), str(d / f"{name}_coco.idx"),
            str(d / f"{name}_scrape.idx"), str(d / f"{name}_out.json"),
            val_index_file=str(d / f"{name}_val.idx") if with_val else None,
            base_path=str(d))
    for idx in ("coco", "scrape", "val", "both"):
        assert (json.loads((d / f"port_{idx}.idx").read_text())
                == json.loads((d / f"jax_{idx}.idx").read_text()))
    assert outs["port"] == outs["jax"]
    assert (d / "port_out.json").read_text() == (d / "jax_out.json").read_text()
    captions = [a["caption"] for a in outs["port"]["annotations"]]
    assert "folder caption for a" in captions and "coco caption a" in captions
    assert "cat" in captions
    assert ("leaked val image" in captions) is not with_val
    assert TFH.normalize_caption("x  y\n z") == JFH.normalize_caption("x  y\n z") == "x y z"


def test_len_distribution_matches_jax(tmp_path):
    folder = tmp_path / "eval_A"
    folder.mkdir()
    with open(folder / "gt.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "file_name", "human", "human_caption", "synth_caption"])
        w.writerow(["A0", "x.jpg", "True", "two words", "three whole words"])
        w.writerow(["A1", "y.jpg", "False", "human text", "a longer synthetic one"])
        w.writerow(["A2", "z.jpg", "True", "one two three four five", "x"])
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = JLD.process_folder(str(folder), out_dir=str(tmp_path / "jax"))
    got = TLD.process_folder(str(folder), out_dir=str(tmp_path / "port"))
    assert got == want == {"human": [2, 5], "synthetic": [4]}
    for ext in ("png", "svg"):
        assert (tmp_path / "port" / f"word_count_hist_eval_A.{ext}").exists()


@pytest.mark.parametrize("layout", ["prefix_tokens", "legacy"])
@pytest.mark.parametrize("move", [False, True])
def test_merge_shards_matches_jax(tmp_path, layout, move):
    subdirs = TMS.LAYOUTS[layout]
    assert TMS.LAYOUTS == JMS.LAYOUTS
    for side in ("jax", "port"):
        for run in ("runA", "runB", "runC"):
            for i in range(2):
                for sub in subdirs:
                    if run == "runC" and i == 1 and sub == subdirs[-1]:
                        continue  # incomplete pair: skipped
                    write_npy_shard(tmp_path / side / "in" / run / sub / f"{i}.npy",
                                    np.full((2, 3), i, np.float32))
        (tmp_path / side / "in" / "not_a_run.txt").write_text("x")
    n_j = JMS.merge_datasets(str(tmp_path / "jax" / "in"), str(tmp_path / "jax" / "out"),
                             move_files=move, layout=layout)
    n_t = TMS.merge_datasets(str(tmp_path / "port" / "in"), str(tmp_path / "port" / "out"),
                             move_files=move, layout=layout)
    assert n_t == n_j == 5
    for sub in subdirs:
        names = sorted(p.name for p in (tmp_path / "port" / "out" / sub).glob("*.npy"))
        assert names == sorted(p.name for p in (tmp_path / "jax" / "out" / sub).glob("*.npy"))
        assert names[:2] == ["runA-0.npy", "runA-1.npy"]
        left = sorted(p.name for p in (tmp_path / "port" / "in" / "runA" / sub).glob("*.npy"))
        assert left == ([] if move else ["0.npy", "1.npy"])


def test_resize_images_matches_jax(tmp_path):
    src = tmp_path / "src"
    (src / "deep").mkdir(parents=True)
    _img(src / "a.jpg", 1, (30, 40))
    _img(src / "deep" / "b.png", 2, (17, 9))
    (src / "broken.jpg").write_bytes(b"not an image")
    n_j = JRI.resize_images(str(src), str(tmp_path / "jax"), image_size=24)
    n_t = TRI.resize_images(str(src), str(tmp_path / "port"), image_size=24)
    assert n_t == n_j == 2
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["a.png", "b.png"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # existing outputs are skipped unless asked
    assert TRI.resize_images(str(src), str(tmp_path / "port"), image_size=24) == 0
    assert TRI.resize_images(str(src), str(tmp_path / "port"), image_size=24,
                             skip_existing=False) == 2


def test_profile_decode_runs_both_paths_on_the_cpu(monkeypatch, capsys):
    """tools/profile_decode: a tiny GPT-2 in bf16 and int8, on the CPU."""
    from clipcap_tpu_torch.core import config as TC
    from clipcap_tpu_torch.tools import profile_decode

    tiny = TC.GPT2Config(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    monkeypatch.setattr(TC.GPT2Config, "variant", classmethod(lambda cls, name: tiny))
    out = profile_decode.main(["--batches", "2,17", "--steps", "3", "--device", "cpu"])
    assert sorted(out) == [2, 17]
    for by_path in out.values():
        assert sorted(by_path) == ["bf16", "int8"]
        for nums in by_path.values():
            assert nums["total_ms"] > 0 and nums["captions_per_sec"] > 0
    assert "B=17 int8: prefill" in capsys.readouterr().out
