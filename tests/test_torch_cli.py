"""Weights in, captions out, on the CPU: a tiny captioner saved by the JAX
package (save_checkpoint, then consolidate) loads in the port with JAX's
greedy tokens; the port's checkpoint writer round-trips in the same
layout; an Orbax directory without the .npz is refused with a pointer to
consolidate; folder_demo on three seeded JPEGs gives JAX's captions and
scores by beam and by no-beam (top_p 0.01, which pins the top token: the
port's and JAX's random draws differ); infer.main and serve.main run end
to end, serve.main's greedy JSONL equal to JAX's."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.cli import infer as JI
from clipcap_tpu.cli import loading as JL
from clipcap_tpu.cli import serve as JSV
from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import engine as JE
from clipcap_tpu.eval.clip_scoring import ClipScoring as JaxScoring
from clipcap_tpu.tokenizers.clip_bpe import CLIPTokenizer as JaxClipTok
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu.train import checkpoints as JCK
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import infer, loading, serve
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.eval.clip_scoring import ClipScoring
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.ops.kernels import fused_attention as FA
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode
from clipcap_tpu_torch.train import checkpoints as TCK

from test_torch_import_weights import openai_clip_state_dict

VIT = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
MAPPER = dict(dim_clip=16, dim_embedding=32, prefix_length=3, clip_length=3, num_layers=1,
              num_heads=2)
CLIP_MERGES = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>")]
# CLIP's vocabulary: 256 bytes, 256 with </w>, the merges, sot and eot
TEXT = dict(vocab_size=2 * 256 + len(CLIP_MERGES) + 2, context_length=77, width=32, layers=1,
            heads=2, output_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _tiny_clip_variant(monkeypatch):
    """The loaders build the ViT a checkpoint names (ViT-B/32 here); the
    CPU tests swap in a tiny one of the same style."""
    for cfg in (JC.ViTConfig, TC.ViTConfig):
        monkeypatch.setattr(cfg, "clip_variant",
                            classmethod(lambda cls, name: cls(style="clip", **VIT)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A JAX-saved, consolidated checkpoint (CLIP ViT + mapper + GPT-2), a
    GPT-2 vocabulary, three JPEGs (one with metadata), an OpenAI-layout CLIP
    state dict with its merges file, and a shard of CLIP features."""
    d = tmp_path_factory.mktemp("cli")
    base = list(bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("h", "e"), ("Ġ", "a"), ("Ġt", "he"), ("c", "a")]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        base + ["".join(m) for m in merges] + ["<|endoftext|>"]))}
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (d / "vocab" / "merges.txt").write_text("\n".join(f"{a} {b}" for a, b in merges) + "\n")

    lm = JC.GPT2Config(vocab_size=len(vocab), n_positions=96, n_embd=32, n_layer=2, n_head=2)
    cap = JC.CaptionerConfig(lm_type="gpt2", visual_encoder_type="CLIP",
                             visual_encoder_variant="ViT-B/32", mapper=JC.MapperConfig(**MAPPER))
    # seeded in the port, saved by the JAX package in its own layout
    model = Captioner(TC.CaptionerConfig.from_dict(dataclasses.asdict(cap)),
                      TC.GPT2Config(**dataclasses.asdict(lm)),
                      vit_cfg=TC.ViTConfig(style="clip", **VIT), device="cpu")
    with torch.no_grad():
        model.lm.wte.mul_(50.0)  # peaked next-token distributions
    ckpt = d / "ckpt"
    JCK.save_checkpoint(str(ckpt), {"params": convert.captioner_params(model)}, cap_cfg=cap,
                        lm_cfg=lm)
    JCK.consolidate(str(ckpt), str(ckpt / "consolidated.npz"))

    from PIL import Image

    (d / "images").mkdir()
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate([(40, 40), (48, 36), (30, 50)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            d / "images" / f"img{i}.jpg")
    (d / "images" / "img1.json").write_text(json.dumps({"src": "http://x/1", "alt": "the cat"}))

    clip_sd = openai_clip_state_dict(VIT, TEXT)
    torch.save({k: torch.from_numpy(v) for k, v in clip_sd.items()}, d / "clip.pt")
    (d / "clip_merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES) + "\n")
    np.save(d / "feats.npy", rng.normal(size=(5, MAPPER["dim_clip"])).astype(np.float32))
    return d, clip_sd


def test_jax_checkpoint_loads_with_jax_greedy_tokens(world):
    d, _ = world
    ckpt, vocab = str(d / "ckpt"), str(d / "vocab")
    jb = JL.load_captioner_bundle(ckpt, vocab)
    tb = loading.load_captioner_bundle(ckpt, vocab, device="cpu")
    assert tb.cap_cfg == TC.CaptionerConfig.from_dict(dataclasses.asdict(jb.cap_cfg))
    assert dataclasses.asdict(tb.lm_cfg) == dataclasses.asdict(jb.lm_cfg)
    feats = np.random.default_rng(3).normal(size=(3, MAPPER["dim_clip"])).astype(np.float32)
    want = JE.generate(jb.lm, jb.params["lm"], jb.lm_cfg, jb.project_prefix(jnp.asarray(feats)),
                       JE.GenerationSettings(max_new_tokens=8, greedy=True))
    got = TE.generate(tb.lm, tb.project_prefix(torch.from_numpy(feats)),
                      TE.GenerationSettings(max_new_tokens=8, greedy=True), device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_writer_round_trips_in_the_consolidated_layout(world, tmp_path):
    d, _ = world
    tb = loading.load_captioner_bundle(str(d / "ckpt"), str(d / "vocab"), device="cpu")
    out = tmp_path / "port_ckpt"
    TCK.save_checkpoint(str(out), tb.model, tb.cap_cfg, tb.lm_cfg)
    # the keys, shapes and values of JAX's consolidate
    with np.load(out / "consolidated.npz") as a, np.load(d / "ckpt" / "consolidated.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    again = loading.load_captioner_bundle(str(out), str(d / "vocab"), device="cpu")
    for (ka, va), (kb, vb) in zip(tb.model.state_dict().items(),
                                  again.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert TCK.load_config(str(out))["captioner"] == TCK.load_config(str(d / "ckpt"))["captioner"]


def test_orbax_directory_without_npz_names_consolidate(world, tmp_path):
    d, _ = world
    orbax_only = tmp_path / "orbax"
    JCK.save_checkpoint(str(orbax_only), {"params": {"w": np.ones(3, np.float32)}},
                        cap_cfg=JC.CaptionerConfig(), lm_cfg=JC.GPT2Config())
    with pytest.raises(FileNotFoundError, match="consolidate"):
        loading.load_captioner_bundle(str(orbax_only), str(d / "vocab"), device="cpu")
    with pytest.raises(FileNotFoundError):
        TCK.read_params(str(tmp_path / "nowhere"))


def _jax_scoring(clip_sd):
    """The CLIP scorer of the OpenAI-layout state dict, through JAX's converters."""
    vit_j = JC.ViTConfig(style="clip", **VIT)
    text_j = JC.CLIPTextConfig(**TEXT)
    return JaxScoring(JW.clip_vit_from_openai_state_dict(clip_sd, vit_j), vit_j,
                      JW.clip_text_from_openai_state_dict(clip_sd, text_j), text_j,
                      JaxClipTok(CLIP_MERGES))


@pytest.mark.parametrize("beam", [True, False])
def test_folder_demo_matches_jax(world, tmp_path, beam):
    d, clip_sd = world
    jb = JL.load_captioner_bundle(str(d / "ckpt"), str(d / "vocab"))
    tb = loading.load_captioner_bundle(str(d / "ckpt"), str(d / "vocab"), device="cpu")
    ranker = loading.load_clip_ranker("ViT-B/32", str(d / "clip.pt"), str(d / "clip_merges.txt"),
                                      device="cpu")
    scoring = ClipScoring(ranker.visual, ranker.text, ranker.tokenizer)
    kw = dict(use_beam_search=beam, text_prefix=None if beam else " a")
    kw.update(dict(entry_length=12, beam_size=3) if beam else dict(top_p_values=[0.01]))
    want = JI.folder_demo(jb, _jax_scoring(clip_sd), str(d / "images"),
                          out_filename_prefix=str(tmp_path / "jax"), **kw)
    got = infer.folder_demo(tb, scoring, str(d / "images"),
                            out_filename_prefix=str(tmp_path / "port"), **kw)
    assert got == want and len(got) == 3
    assert json.loads((tmp_path / "port_shutterstock.json").read_text()) == got
    assert "http://x/1" in got and got["http://x/1"]["original_caption"] == "the cat"
    assert FA.LAUNCHES == {"fused_attention": 0}
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def test_infer_main_runs_end_to_end(world, tmp_path):
    d, _ = world
    args = ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--folder_path", str(d / "images"), "--clip_checkpoint", str(d / "clip.pt"),
            "--clip_merges", str(d / "clip_merges.txt"),
            "--out_filename_prefix", str(tmp_path / "run"), "--device", "cpu"]
    data = infer.main(args)
    assert len(data) == 3 and all("scores" in v for v in data.values())
    assert json.loads((tmp_path / "run_shutterstock.json").read_text()) == data
    # --speculative_draft_checkpoint runs (the captioner as its own draft):
    # JAX's captions by speculative greedy decode; a GPT-J target with a
    # GPT-2 draft is in tests/test_torch_gptj_paths.py
    spec = ["--speculative_draft_checkpoint", str(d / "ckpt"), "--speculative_gamma", "3"]
    JI.main(args[:-2] + spec + ["--out_filename_prefix", str(tmp_path / "jax_spec")])
    got = infer.main(args + spec + ["--out_filename_prefix", str(tmp_path / "spec")])
    assert got == json.loads((tmp_path / "jax_spec_shutterstock.json").read_text())
    # --tensor_parallel is JAX's: GPT-2's 25 heads do not split, so a GPT-2
    # checkpoint is refused as JAX refuses it (GPT-J's tensor-parallel
    # decode: tests/test_torch_parallel_tp.py)
    with pytest.raises(ValueError, match="GPT-J"):
        infer.main(args + ["--tensor_parallel", "2"])


def test_serve_main_matches_jax(world, tmp_path, capsys):
    d, _ = world
    args = ["--checkpoint_path", str(d / "ckpt"), "--tokenizer_vocab_dir", str(d / "vocab"),
            "--prefixes_npy", str(d / "feats.npy"), "--slots", "4", "--steps_per_sync", "4",
            "--max_new_tokens", "6"]
    JSV.main(args + ["--out_jsonl", str(tmp_path / "jax.jsonl")])
    assert serve.main(args + ["--out_jsonl", str(tmp_path / "port.jsonl"), "--device", "cpu"]) == 5
    want = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert (tmp_path / "port.jsonl").read_text().splitlines() == want and len(want) == 5
    # --target_p50_s picks by JAX's rule from the card's curve (--int8_decode
    # runs: test_torch_int8_paths.py); greedy captions do not depend on it
    assert serve.pick_slots_for_p50(1.0) == JSV.pick_slots_for_p50(1.0, serve.LATENCY_CURVE_P50_S)
    for target in (0.5, serve.LATENCY_CURVE_P50_S[256]):
        capsys.readouterr()
        out = tmp_path / f"p50_{target}.jsonl"
        assert serve.main(args + ["--out_jsonl", str(out), "--device", "cpu",
                                  "--target_p50_s", str(target)]) == 5
        slots = JSV.pick_slots_for_p50(target, curve=serve.LATENCY_CURVE_P50_S)
        assert f"target_p50_s={target}: serving with {slots} slots" in capsys.readouterr().out
        assert out.read_text().splitlines() == want


def test_loaders_refuse_what_is_not_ported(world):
    d, _ = world
    # an "RN..." model reads a ResNet checkpoint (the Gen-B slice ported the
    # tower; tests/test_torch_genb_apps.py loads one): a ViT one is refused
    with pytest.raises(KeyError, match="visual.conv3.weight"):
        loading.load_clip_ranker("RN50x64", str(d / "clip.pt"), str(d / "clip_merges.txt"),
                                 device="cpu")
    sd = loading.load_state_dict(str(d / "clip.pt"))
    assert sorted(sd) == sorted(openai_clip_state_dict(VIT, TEXT))
    np.savez(d / "clip.npz", **{k: v.numpy() for k, v in sd.items()})
    npz = loading.load_state_dict(str(d / "clip.npz"))
    assert all(np.array_equal(npz[k], sd[k].numpy()) for k in sd)
