"""Checkpoint evaluation on the CPU against the JAX package: the caption
loss (-1 padding as the mask, ignore_index 0 dropping genuine id-0 tokens
too) at rtol 1e-5; the COCO reader's index, datasets, padding, collate and
loader equal JAX's on the tiny COCO of tests/test_validator_integration.py;
CocoCaptionValidator with the beam and CLIP-guided samplers gives JAX's
captions exactly and its loss and CLIP score at rtol 1e-5, and the same
captions image by image as in one batch; and cli.evaluate.main runs end to
end on a checkpoint that the JAX package wrote, printing the JSON that
JAX's main prints (its no-beam sweep included: the peaked captioner pins
top-p 0.1 and 0.2 to the top token, where the two packages' random draws
would otherwise differ)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.cli import evaluate as JEV
from clipcap_tpu.cli import loading as JL
from clipcap_tpu.core import config as JC
from clipcap_tpu.data import coco as JD
from clipcap_tpu.data.preprocessing import clip_preprocess as jax_clip_preprocess
from clipcap_tpu.eval import samplers as JS
from clipcap_tpu.eval.clip_scoring import ClipScoring as JaxScoring
from clipcap_tpu.eval.validator import CocoCaptionValidator as JaxValidator
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.tokenizers import GPT2TokenizerWrapper as JaxTok
from clipcap_tpu.tokenizers.bpe import ByteLevelBPE as JaxBPE
from clipcap_tpu.tokenizers.clip_bpe import CLIPTokenizer as JaxClipTok
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu.train import checkpoints as JCK
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import evaluate, loading
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.data import coco as TD
from clipcap_tpu_torch.data.preprocessing import clip_preprocess
from clipcap_tpu_torch.eval import samplers as TS
from clipcap_tpu_torch.eval.clip_scoring import ClipScoring
from clipcap_tpu_torch.eval.validator import CocoCaptionValidator
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.tokenizers import GPT2TokenizerWrapper
from clipcap_tpu_torch.tokenizers.bpe import ByteLevelBPE, bytes_to_unicode

from test_torch_import_weights import openai_clip_state_dict

VIT = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
MAPPER = dict(dim_clip=16, dim_embedding=32, prefix_length=3, clip_length=3, num_layers=1,
              num_heads=2)
MERGES = [("Ġ", "a"), ("c", "a"), ("ca", "t"), ("m", "a"), ("ma", "t"), ("t", "h"), ("th", "e"),
          ("s", "a"), ("sa", "t"), ("o", "n")]
CLIP_MERGES = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>")]
# the loaders give CLIP's text tower width // 64 heads
TEXT = dict(vocab_size=2 * 256 + len(CLIP_MERGES) + 2, context_length=77, width=64, layers=1,
            heads=1, output_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_tiny_vit():
    """One intra-op thread (the suite runs files in parallel workers), and a
    tiny CLIP ViT in place of the ViT-B/32 the checkpoints name."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for cfg in (JC.ViTConfig, TC.ViTConfig):
        mp.setattr(cfg, "clip_variant", classmethod(lambda cls, name: cls(style="clip", **VIT)))
    yield
    mp.undo()
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tiny COCO of tests/test_validator_integration.py (3 JPEGs, 2
    captions each), a GPT-2 vocabulary, a captioner seeded in the port and
    saved by the JAX package (Orbax + consolidate), and an OpenAI-layout
    CLIP state dict with its merges file."""
    from PIL import Image

    d = tmp_path_factory.mktemp("coco")
    (d / "images").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in range(3):
        name = f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            d / "images" / name)
        images.append({"id": i, "file_name": name, "coco_url": f"http://x/{name}"})
        for j in range(2):
            annotations.append({"image_id": i, "caption": f"a cat sat on the mat {i} {j}.",
                                "id": 10 * i + j})
    (d / "captions.json").write_text(json.dumps({"images": images, "annotations": annotations}))

    base = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        base + ["".join(m) for m in MERGES] + ["<|endoftext|>"]))}
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (d / "vocab" / "merges.txt").write_text("\n".join(f"{a} {b}" for a, b in MERGES) + "\n")

    lm = JC.GPT2Config(vocab_size=len(vocab), n_positions=128, n_embd=32, n_layer=2, n_head=2)
    cap = JC.CaptionerConfig(lm_type="gpt2", visual_encoder_type="CLIP",
                             visual_encoder_variant="ViT-B/32", mapper=JC.MapperConfig(**MAPPER))
    model = Captioner(TC.CaptionerConfig.from_dict(dataclasses.asdict(cap)),
                      TC.GPT2Config(**dataclasses.asdict(lm)),
                      vit_cfg=TC.ViTConfig(style="clip", **VIT), device="cpu", seed=1)
    with torch.no_grad():
        model.lm.wte.mul_(50.0)  # peaked next-token distributions, captions before eos
    JCK.save_checkpoint(str(d / "ckpt"), {"params": convert.captioner_params(model)},
                        cap_cfg=cap, lm_cfg=lm)
    JCK.consolidate(str(d / "ckpt"), str(d / "ckpt" / "consolidated.npz"))

    clip_sd = openai_clip_state_dict(VIT, TEXT)
    torch.save({k: torch.from_numpy(v) for k, v in clip_sd.items()}, d / "clip.pt")
    (d / "clip_merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES) + "\n")
    return d, clip_sd, vocab


@pytest.fixture(scope="module")
def pair(world):
    """(JAX bundle, JAX CLIP scorer, port bundle, port CLIP scorer)."""
    d, clip_sd, _ = world
    jb = JL.load_captioner_bundle(str(d / "ckpt"), str(d / "vocab"))
    tb = loading.load_captioner_bundle(str(d / "ckpt"), str(d / "vocab"), device="cpu")
    vit_j, text_j = JC.ViTConfig(style="clip", **VIT), JC.CLIPTextConfig(**TEXT)
    js = JaxScoring(JW.clip_vit_from_openai_state_dict(clip_sd, vit_j), vit_j,
                    JW.clip_text_from_openai_state_dict(clip_sd, text_j), text_j,
                    JaxClipTok(CLIP_MERGES))
    ranker = loading.load_clip_ranker("ViT-B/32", str(d / "clip.pt"), str(d / "clip_merges.txt"),
                                      device="cpu")
    return jb, js, tb, ClipScoring(ranker.visual, ranker.text, ranker.tokenizer)


# --- caption_loss -----------------------------------------------------------------------

LOSS_TOKENS = {
    # -1 padding of uneven lengths
    "padded": [[266, 5, 17, 40, 266, -1, -1], [266, 9, 9, 266, -1, -1, -1]],
    # genuine id-0 tokens drop out like the padding (ignore_index 0)
    "id_zero": [[266, 0, 17, 0, 266, 12, -1], [0, 9, 9, 266, 7, 7, 266]],
    # nothing valid: the denominator stays 1 (the others' width: one JAX compile)
    "all_padding": [[-1] * 7, [-1] * 7],
}


@pytest.mark.parametrize("case", sorted(LOSS_TOKENS))
def test_caption_loss_matches_jax(pair, case):
    jb, _, tb, _ = pair
    tokens = np.asarray(LOSS_TOKENS[case], np.int64)
    feats = np.random.default_rng(1).normal(size=(2, MAPPER["dim_clip"])).astype(np.float32)
    want, wm = JCAP.caption_loss(jb.params, jb.cap_cfg, jb.lm_cfg, jnp.asarray(tokens),
                                 jnp.asarray(feats))
    with torch.no_grad():
        got, gm = tb.model.caption_loss(torch.from_numpy(tokens), torch.from_numpy(feats))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert int(gm["valid_tokens"]) == int(wm["valid_tokens"])
    assert float(gm["loss"]) == float(got)


def test_bundle_forward_matches_jax(pair):
    jb, _, tb, _ = pair
    tokens = np.asarray([[266, 5, 17], [266, 9, 0]], np.int64)
    feats = np.random.default_rng(2).normal(size=(2, MAPPER["dim_clip"])).astype(np.float32)
    mask = np.asarray([[1, 1, 1], [1, 1, 0]], bool)
    want = jb.forward(jnp.asarray(tokens), jnp.asarray(feats), jnp.asarray(mask))
    got = tb.forward(torch.from_numpy(tokens), torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)


# --- data/coco --------------------------------------------------------------------------


def test_coco_index_and_image_dataset_match_jax(world):
    d, _, _ = world
    want = JD.CocoImageDataset(str(d / "captions.json"), str(d / "images"))
    got = TD.CocoImageDataset(str(d / "captions.json"), str(d / "images"))
    assert len(got) == len(want) == 3
    assert (got.get_index().get_captions_by_image_id()
            == want.get_index().get_captions_by_image_id())
    idx_t, idx_j = got.get_index(), want.get_index()
    assert len(idx_t) == len(idx_j) == 6
    for i in range(6):
        assert dataclasses.asdict(idx_t[i]) == dataclasses.asdict(idx_j[i])
    for i in range(3):
        a, b = got[i], want[i]
        assert dataclasses.asdict(a["image_entry"]) == dataclasses.asdict(b["image_entry"])
        np.testing.assert_array_equal(np.asarray(a["image"]), np.asarray(b["image"]))
    # a file that fails to load gives None, which the collate drops
    assert TD.CocoImageDataset(str(d / "captions.json"), str(d / "nowhere"))[0] is None
    assert JD.CocoImageDataset(str(d / "captions.json"), str(d / "nowhere"))[0] is None
    assert TD.collate_filter_none([None, None]) is None


def test_caption_dataset_padding_and_loader_match_jax(world):
    d, _, vocab = world
    tok_t = GPT2TokenizerWrapper(ByteLevelBPE(vocab, MERGES))
    tok_j = JaxTok(JaxBPE(vocab, MERGES))
    args = (str(d / "captions.json"), str(d / "images"))
    got = TD.CocoCaptionDataset(*args, tokenizer=tok_t, max_token_length=24,
                                image_transform=lambda im: clip_preprocess(im, 32))
    want = JD.CocoCaptionDataset(*args, tokenizer=tok_j, max_token_length=24,
                                 image_transform=lambda im: jax_clip_preprocess(im, 32))
    for i in range(len(want)):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["image_tensor"], b["image_tensor"])
        assert a["image_id"] == b["image_id"]
        assert a["tokens"][0] == tok_t.bos_token_id and (a["tokens"] == -1).sum() > 0
    np.testing.assert_array_equal(TD.pad_tokens([1, 2, 3], 5), JD.pad_tokens([1, 2, 3], 5))
    np.testing.assert_array_equal(TD.pad_tokens(list(range(9)), 5),
                                  JD.pad_tokens(list(range(9)), 5))
    bt = next(iter(TD.BatchLoader(got, batch_size=4, shuffle=True, seed=3)))
    bj = next(iter(JD.BatchLoader(want, batch_size=4, shuffle=True, seed=3)))
    assert sorted(bt) == sorted(bj) and bt["image_id"] == bj["image_id"]
    np.testing.assert_array_equal(bt["tokens"], bj["tokens"])
    assert bt["image_tensor"].shape == (4, 3, 32, 32)
    assert len(TD.BatchLoader(got, 4)) == len(JD.BatchLoader(want, 4)) == 1
    assert len(TD.BatchLoader(got, 4, drop_last=False)) == 2


def test_folder_index_matches_jax(tmp_path):
    from PIL import Image

    for name, ext in (("a", "jpg"), ("b", "png"), ("c", "jpg")):
        Image.fromarray(np.full((8, 8, 3), 7, np.uint8)).save(tmp_path / f"{name}.{ext}")
    (tmp_path / "a.txt").write_text("a  cat\n on\tthe mat")
    (tmp_path / "b.txt").write_text("two dogs")
    (tmp_path / "z.txt").write_text("no image")
    got, want = TD.FileFolderIndex(str(tmp_path)), JD.FileFolderIndex(str(tmp_path))
    assert got.keys == want.keys == ["a", "b"]
    assert [got[i].caption for i in range(2)] == [want[i].caption for i in range(2)]
    assert got[0].caption == "a cat on the mat"
    assert len(TD.FolderImageDataset(str(tmp_path))) == 2


# --- the validator ----------------------------------------------------------------------


def _samplers(pkg, scoring):
    kw = dict(device="cpu") if pkg is TS else {}
    return {"beam": pkg.BeamCaptionSampler(beam_size=2, max_decode_length=6, **kw),
            "clip_guided": pkg.ClipGuidedCaptionSampler(scoring, branching_factor=2,
                                                        look_ahead=2, **kw)}


def _pre_t(im):
    return clip_preprocess(im, 32)


def test_validator_matches_jax(world, pair):
    """The three images as one batched chunk in both packages."""
    d, _, _ = world
    jb, js, tb, ts = pair
    ds_j = JD.CocoImageDataset(str(d / "captions.json"), str(d / "images"))
    ds_t = TD.CocoImageDataset(str(d / "captions.json"), str(d / "images"))
    vj = JaxValidator(ds_j, lambda im: jax_clip_preprocess(im, 32), _samplers(JS, js), js)
    vt = CocoCaptionValidator(ds_t, _pre_t, _samplers(TS, ts), ts)
    vj.process(jb, [ds_j[i] for i in range(3)])
    vt.process(tb, [ds_t[i] for i in range(3)])
    want, got = vj.get_results(), vt.get_results()
    assert vt.caption_hypo == vj.caption_hypo
    assert len(got["captions"]) == 3
    for a, b in zip(got["captions"], want["captions"]):
        assert (a["image_id"], a["image_url"]) == (b["image_id"], b["image_url"])
        for sa, sb in zip(a["sampling_results"], b["sampling_results"]):
            assert sa["sampler_id"] == sb["sampler_id"]
            assert [c["caption"] for c in sa["captions"]] == [c["caption"] for c in sb["captions"]]
            np.testing.assert_allclose([c["clip_score"] for c in sa["captions"]],
                                       [c["clip_score"] for c in sb["captions"]], rtol=1e-5)
    np.testing.assert_allclose(vt.losses, vj.losses, rtol=1e-5)
    np.testing.assert_allclose(got["validation_loss"], want["validation_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["clip_score"], want["clip_score"], rtol=1e-5)
    assert got["sampler_scores"] == want["sampler_scores"]
    assert any(len(h[0]["caption"]) for h in vt.caption_hypo["clip_guided"].values())
    vt.reset()
    assert vt.results["captions"] == [] and vt.losses == []


def test_validator_per_image_path_matches_batched(world, pair):
    """Images 0-1 batched and image 2 alone, against the same images image
    by image (batched_sampling=False): the same captions, scores and loss."""
    d, _, _ = world
    _, _, tb, ts = pair
    ds = TD.CocoImageDataset(str(d / "captions.json"), str(d / "images"))
    batched = CocoCaptionValidator(ds, _pre_t, _samplers(TS, ts), ts)
    single = CocoCaptionValidator(ds, _pre_t, _samplers(TS, ts), ts, batched_sampling=False)
    for chunk in ([0, 1], [2]):
        batched.process(tb, [ds[i] for i in chunk])
        single.process(tb, [ds[i] for i in chunk])
    assert batched.caption_hypo == single.caption_hypo
    np.testing.assert_allclose(batched.clip_scores, single.clip_scores, rtol=1e-5)
    np.testing.assert_allclose(batched.losses, single.losses, rtol=1e-5)


# --- cli.evaluate -----------------------------------------------------------------------


def _cli_args(d):
    return ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--clip_checkpoint", str(d / "clip.pt"), "--clip_merges", str(d / "clip_merges.txt"),
            "--valid_json_path", str(d / "captions.json"),
            "--image_folder_path", str(d / "images"), "--max_samples", "3",
            "--eval_batch_size", "3"]


def _printed_json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_evaluate_main_matches_jax(world, capsys):
    """Both CLIs on the checkpoint JAX wrote: the printed JSON of scores is
    the same (the peaked captioner pins top-p 0.1 and 0.2 to the top token,
    so the no-beam captions agree too)."""
    d, _, _ = world
    JEV.main(_cli_args(d))
    want = _printed_json(capsys.readouterr().out)
    results = evaluate.main(_cli_args(d) + ["--device", "cpu", "--prefix_only"])
    got = _printed_json(capsys.readouterr().out)
    assert sorted(got) == ["clip_score", "sampler_scores", "validation_loss"]
    assert got["sampler_scores"] == want["sampler_scores"]
    assert sorted(got["sampler_scores"]) == ["clip_guided", "nobeam"]
    for key in ("validation_loss", "clip_score"):
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert len(results["captions"]) == 3  # --int8_decode: tests/test_torch_int8_paths.py
