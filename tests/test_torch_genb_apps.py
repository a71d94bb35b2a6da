"""The Gen-B apps of the port against the JAX package's, on the CPU, from
files on disk: a BLIP captioner in HF's BlipForConditionalGeneration
layout with its vocab.txt, OpenAI-layout CLIP ViT-L/14 and RN50x64 state
dicts with CLIP's merges (tiny geometries swapped in for the named
variants, as tests/test_torch_cli.py swaps ViT-B/32), and a BLIP retrieval
model.

- the loaders: load_blip_captioner and load_clip_ranker("RN50x64") give
  the modules of JAX's loaders, parameter for parameter;
- SynthesisEngine.rank in all five modes: the order and the captions equal
  JAX's, the scores within 1e-5;
- caption_me.main --device cpu against JAX's main (top_p 0.01 pins the top
  token: the two packages' random draws differ): the same candidates and
  top-n, the scores within 1e-5; JAX's behaviours pinned in both: the
  default mode raises KeyError (no RN50x64 ranker is loaded) and so do ITM
  and ITC (the ranker gets the captioner's modules);
- cli.train with --visual_encoder_type BLIP --visual_checkpoint: the HF
  BLIP-ViT state dict loads into the encoder bit for bit, and one train
  step from it gives JAX's loss (rtol 1e-5) with JAX's encoder loaded by
  JAX's importer from the same file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.cli import caption_me as JCM
from clipcap_tpu.cli import loading as JL
from clipcap_tpu.cli.synthesis import SynthesisEngine as JaxEngine
from clipcap_tpu.core import config as JC
from clipcap_tpu.models import blip_retrieval as JBR
from clipcap_tpu.rank.rankers import BLIPRanker as JaxBLIPRanker
from clipcap_tpu.tools import import_weights as JW
from clipcap_tpu.train import train_step as JTS
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import caption_me, loading
from clipcap_tpu_torch.cli import train as train_cli
from clipcap_tpu_torch.cli.synthesis import SynthesisEngine
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models import blip_retrieval as TBR
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.rank.rankers import BLIPRanker
from clipcap_tpu_torch.tools import import_weights as TW
from clipcap_tpu_torch.train import train_step as TTS

from test_torch_genb import openai_resnet_state_dict
from test_torch_import_weights import openai_clip_state_dict

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a picture of the cat dog man on top "
         "wave surf ##board . , green park bench two people beach [DEC] [ENC]").split()
BLIP_VIT = dict(image_size=32, patch_size=16, width=24, layers=1, heads=4, mlp_ratio=4.0,
                output_dim=None, style="blip", layer_norm_epsilon=1e-6)
BLIP_TEXT = dict(vocab_size=len(VOCAB), hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, max_position_embeddings=64, embed_dim=16)
CLIP_VIT = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
CLIP_MERGES = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>")]
CLIP_TEXT = dict(vocab_size=2 * 256 + len(CLIP_MERGES) + 2, context_length=77, width=64,
                 layers=1, heads=1, output_dim=16)  # the loaders take width // 64 heads
RN = dict(layers=(1, 1, 1, 1), width=8, output_dim=16, heads=4, image_size=64)
CAPTIONS = ["a cat on the bench", "two people on the beach", "a dog", "the green park",
            "a man on top of a wave", "a surfboard", "a picture of a cat", "people"]
MODES = ["CLIP-ViT-L+RN50x64", "CLIP-ViT-L", "CLIP-RN50x64", "ITM", "ITC"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_tiny_variants():
    """The loaders build the models a checkpoint names (BLIP ViT-L at 384
    px with bert-base's decoder, CLIP ViT-L/14); the CPU tests swap in tiny
    ones of the same styles, in both packages."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for cfg in (JC.ViTConfig, TC.ViTConfig):
        mp.setattr(cfg, "clip_variant", classmethod(lambda cls, name: cls(**CLIP_VIT)))
        mp.setattr(cfg, "blip_variant",
                   classmethod(lambda cls, name, image_size=384: cls(**BLIP_VIT)))
    for mod, cfg in ((JL, JC.BlipTextConfig), (loading, TC.BlipTextConfig)):
        mp.setattr(mod, "BlipTextConfig",
                   lambda encoder_width, cfg=cfg: cfg(encoder_width=encoder_width, **BLIP_TEXT))
    yield
    mp.undo()
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from PIL import Image
    from transformers import (BlipConfig, BlipForConditionalGeneration, BlipTextConfig,
                              BlipVisionConfig)

    d = tmp_path_factory.mktemp("genb_apps")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    torch.manual_seed(0)
    text = BlipTextConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=64, encoder_hidden_size=24, is_decoder=True)
    vision = BlipVisionConfig(image_size=32, patch_size=16, hidden_size=24, num_hidden_layers=1,
                              num_attention_heads=4, intermediate_size=96, layer_norm_eps=1e-6)
    blip = BlipForConditionalGeneration(BlipConfig(text_config=text.to_dict(),
                                                   vision_config=vision.to_dict()))
    torch.save(blip.state_dict(), d / "blip.pth")
    torch.save({k[len("vision_model."):]: v for k, v in blip.state_dict().items()
                if k.startswith("vision_model.")}, d / "blip_vision.pth")
    vit_l = openai_clip_state_dict(CLIP_VIT, CLIP_TEXT, seed=1)
    torch.save({k: torch.from_numpy(v) for k, v in vit_l.items()}, d / "vit_l.pt")
    rn = openai_resnet_state_dict(RN, CLIP_TEXT, seed=2)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in rn.items()}, d / "rn50x64.pt")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES) + "\n")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(d / "img.jpg")
    return d


@pytest.fixture(scope="module")
def engines(world):
    """JAX's engine from JAX's loaders and the port's from the port's, on
    the same files; the BLIP retrieval model from JAX's init, converted."""
    from PIL import Image

    d = world
    args = (str(d / "blip.pth"), str(d / "vocab.txt"))
    jparams, jvit, jtext, jtok = JL.load_blip_captioner(*args)
    tparams, tvit, ttext, ttok = loading.load_blip_captioner(*args, device="cpu")
    jrank = {"ViT-L/14": JL.load_clip_ranker("ViT-L/14", str(d / "vit_l.pt"), str(d / "merges.txt")),
             "RN50x64": JL.load_clip_ranker("RN50x64", str(d / "rn50x64.pt"),
                                            str(d / "merges.txt"))}
    trank = {name: loading.load_clip_ranker(name, str(d / f), str(d / "merges.txt"),
                                            device="cpu")
             for name, f in (("ViT-L/14", "vit_l.pt"), ("RN50x64", "rn50x64.pt"))}
    rv, rt = dict(BLIP_VIT), dict(BLIP_TEXT, encoder_width=24)
    rparams = JBR.init(jax.random.PRNGKey(3), JC.ViTConfig(**rv), JC.BlipTextConfig(**rt))
    retrieval = convert.load(TBR.BlipRetrieval(TC.ViTConfig(**rv), TC.BlipTextConfig(**rt),
                                               device="cpu"),
                             convert.blip_retrieval_state_dict(_np(rparams)))
    jeng = JaxEngine(jparams, jvit, jtext, jtok, clip_rankers=jrank,
                     blip_ranker=JaxBLIPRanker(rparams, JC.ViTConfig(**rv),
                                               JC.BlipTextConfig(**rt), jtok))
    teng = SynthesisEngine(tparams, tvit, ttext, ttok, clip_rankers=trank,
                           blip_ranker=BLIPRanker(retrieval, retrieval.vit_cfg,
                                                  retrieval.text_cfg, ttok))
    return jeng, teng, Image.open(d / "img.jpg").convert("RGB")


def test_loaders_give_jax_modules(engines):
    jeng, teng, _ = engines
    assert teng.blip_vit_cfg == TC.ViTConfig(**BLIP_VIT)
    assert dataclasses.asdict(teng.blip_text_cfg) == dataclasses.asdict(jeng.blip_text_cfg)
    for name, conv in (("visual", convert.vit_state_dict), ("text", convert.blip_text_state_dict)):
        want = conv(_np(jeng.blip_params[name]))
        got = teng.blip_params[name].state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for name in ("ViT-L/14", "RN50x64"):
        j, t = jeng.clip_rankers[name], teng.clip_rankers[name]
        assert dataclasses.asdict(t.vit_cfg) == dataclasses.asdict(j.vit_cfg)
        conv = convert.clip_resnet_state_dict if name == "RN50x64" else convert.vit_state_dict
        want = conv(_np(j.vit_params))
        got = t.visual.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_rank_modes_match_jax(engines, mode):
    jeng, teng, image = engines
    want = jeng.rank(image, CAPTIONS, mode=mode, top_n=4)
    got = teng.rank(image, CAPTIONS, mode=mode, top_n=4)
    assert [c for c, _ in got] == [c for c, _ in want] and len(got) == 4
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5, atol=1e-6)


def _main_args(d, *extra):
    return [str(d / "img.jpg"), "--blip_checkpoint", str(d / "blip.pth"), "--blip_vocab",
            str(d / "vocab.txt"), "--clip_vit_l_checkpoint", str(d / "vit_l.pt"),
            "--clip_merges", str(d / "merges.txt"), *extra]


def _printed(out: str):
    lines = out.strip().splitlines()
    rows = [line.split(": ", 1) for line in lines[1:]]
    return lines[0], [r[1] for r in rows], [float(r[0].split("[")[1].rstrip("]")) for r in rows]


def test_caption_me_main_matches_jax(world, capsys):
    args = _main_args(world, "--mode", "CLIP-ViT-L", "--sample_count", "40", "--set_top_p",
                      "0.01", "--top_n", "3")
    JCM.main(args)
    want = _printed(capsys.readouterr().out)
    ranked, candidates = caption_me.main(args + ["--device", "cpu"])
    got = _printed(capsys.readouterr().out)
    assert got[:2] == want[:2] and len(got[1]) == 3 and len(candidates) >= 2
    np.testing.assert_allclose(got[2], want[2], atol=1e-3)  # printed to 3 decimals
    np.testing.assert_allclose([s for _, s in ranked], want[2], atol=5e-4)


@pytest.mark.parametrize("mode", [None, "ITM", "ITC"])
def test_caption_me_main_keeps_jax_key_errors(world, mode):
    """JAX's main loads no RN50x64 ranker (the default mode's second
    stage) and builds its BLIP ranker on the captioner's params, which
    have no itm_head, vision_proj or text_proj: KeyError in both."""
    args = _main_args(world, "--sample_count", "2", "--set_max_len", "3",
                      *(() if mode is None else ("--mode", mode)))
    key = {None: "RN50x64", "ITM": "itm_head", "ITC": "vision_proj"}[mode]
    with pytest.raises(KeyError, match=key):
        JCM.main(args)
    with pytest.raises(KeyError, match=key):
        caption_me.main(args + ["--device", "cpu"])


def test_train_cli_loads_a_blip_visual_checkpoint(world, tmp_path):
    """cli.train --visual_encoder_type BLIP --visual_checkpoint, end to end
    on a folder of one image, then one step from the same file in both
    packages (JAX's encoder from JAX's importer, the rest from the port's
    initial model), losses at rtol 1e-5."""
    import json
    import shutil

    from test_torch_train_cli import MAPPER_ARGS
    from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode

    d = tmp_path
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        list(bytes_to_unicode().values()) + ["<|endoftext|>"]))}
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (d / "vocab" / "merges.txt").write_text("\n")
    lm = TC.GPT2Config(vocab_size=len(vocab), n_positions=32, n_embd=32, n_layer=1, n_head=2)
    (d / "lm.json").write_text(lm.to_json())
    (d / "images").mkdir()
    for i in range(4):
        shutil.copy(world / "img.jpg", d / "images" / f"{i}.jpg")
        (d / "images" / f"{i}.txt").write_text(f"a cat {i}")
    ckpt = str(world / "blip_vision.pth")
    args = ["--tokenizer_vocab_dir", str(d / "vocab"), "--lm_config_json", str(d / "lm.json"),
            "--output_dir", str(d / "out"), "--device", "cpu", "--batch_size", "4",
            "--epochs", "1", "--max_steps", "1", "--seed", "3", "--image_folder_path",
            str(d / "images"), "--max_token_length", "16", "--log_every_n_steps", "1",
            "--visual_encoder_type", "BLIP", "--visual_checkpoint", ckpt,
            *MAPPER_ARGS[:-2], "--prefix_size", "24"]
    res = train_cli.main(args)
    sd = loading.load_state_dict(ckpt)
    vit_cfg = TC.ViTConfig(**BLIP_VIT)
    loaded = TW.blip_vit_from_hf_state_dict(sd, vit_cfg)
    visual = res["state"].model.visual
    assert res["total_steps"] == 1
    for name, p in visual.named_parameters():  # frozen (stored in bf16): the checkpoint's
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            torch.from_numpy(loaded[name]).to(p.dtype).float().numpy(), err_msg=name)
    lines = [json.loads(x) for x in (d / "out" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in lines if "loss" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])

    # one f32 step in both packages from the same file, on the CLI's
    # configs and its initial model (the all-features mapper over the tokens)
    cap_t, _, _ = train_cli.build_configs(train_cli.build_argparser().parse_args(args))
    cap_j = JC.CaptionerConfig.from_dict(dataclasses.asdict(cap_t))
    model = Captioner(cap_t, lm, vit_cfg=vit_cfg, device="cpu", seed=3)
    train_cli._load_visual(model, vit_cfg, ckpt, "BLIP")
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)),
                                     convert.captioner_params(model))
    jparams["visual"] = JW.blip_vit_from_hf_state_dict(sd, JC.ViTConfig(**BLIP_VIT))
    base = dict(optimizer_lr=1e-3, scheduler_warmup_steps=0, total_steps=4, remat=False,
                bf16_compute=False)
    tc_t, tc_j = TC.TrainConfig(**base), JC.TrainConfig(**base)
    state, tx = TTS.create_train_state(3, cap_t, lm, tc_t, model=model, device="cpu")
    _, m = TTS.make_train_step(cap_t, lm, tc_t, tx, visual_cfg=vit_cfg)(state, batch := {
        "tokens": torch.from_numpy(np.random.default_rng(1).integers(1, 200, (2, 6))),
        "pixels": torch.from_numpy(np.random.default_rng(2).standard_normal(
            (2, 3, 32, 32)).astype(np.float32))})
    lm_j = JC.GPT2Config(**dataclasses.asdict(lm))
    jstate, jtx = JTS.create_train_state(jax.random.PRNGKey(0), cap_j, lm_j, tc_j,
                                         params=jparams)
    _, jm = JTS.make_train_step(cap_j, lm_j, tc_j, jtx, donate=False,
                                visual_cfg=JC.ViTConfig(**BLIP_VIT))(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)


def test_entry_points_default_to_the_card():
    """Every Gen-B entry point builds on the card unless asked for the CPU."""
    import inspect

    from clipcap_tpu_torch.models.blip_text import BlipText
    from clipcap_tpu_torch.models.clip_resnet import ModifiedResNet

    for fn in (loading.load_blip_captioner, loading.load_clip_ranker, loading.load_clip_towers,
               BlipText, TBR.BlipRetrieval, ModifiedResNet):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    args = caption_me.build_argparser().parse_args(["x.jpg", "--blip_checkpoint", "b.pth",
                                                    "--blip_vocab", "vocab.txt"])
    assert args.device == "cuda" and args.mode == "CLIP-ViT-L+RN50x64"
    # the rest of Gen B: the sweep, human-eval, Gumbel optimization, BLIP serving
    from clipcap_tpu_torch.cli import human_eval, sweep
    from clipcap_tpu_torch.models.blip_text import serving_decoder_lm
    from clipcap_tpu_torch.tools.gumbel_caption_opt import optimize_caption

    for fn in (optimize_caption, serving_decoder_lm):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    need = ["--valid_json_path", "c.json", "--image_folder_path", "img", "--blip_checkpoint",
            "b.pth", "--blip_vocab", "vocab.txt"]
    for cli in (sweep, human_eval):
        assert cli.build_argparser().parse_args(need).device == "cuda", cli
    assert human_eval.build_argparser().parse_args(need).mode == "CLIP-ViT-L+RN50x64"
