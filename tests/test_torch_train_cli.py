"""`python -m clipcap_tpu_torch.cli.train --device cpu` end to end, on tiny
configs: the prefix-shard path and the COCO pixel path (a tiny CLIP ViT
swapped in for ViT-B/32), with validation. Checks: finite logged losses
and the metrics.jsonl lines; the final checkpoint read back by
cli.loading equal bit for bit to the trained parameters; a resume from
`_latest` continues with the losses and parameters of the uninterrupted
run, exactly; prefix_only leaves the LM bit for bit as it was; the visual
encoder moves only under --train_visual_encoder; and the options one card
cannot take and an Orbax directory raise. A BLIP --visual_checkpoint loads
(tests/test_torch_genb_apps.py)."""

import json
import math

import numpy as np
import pytest
import torch

from clipcap_tpu_torch.cli import loading
from clipcap_tpu_torch.cli import train as train_cli
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.data.npy_reader import write_npy_shard
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode

from test_torch_import_weights import openai_clip_state_dict

VIT = dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, output_dim=16)
TEXT = dict(vocab_size=2 * 256 + 2 + 2, context_length=77, width=64, layers=1, heads=1,
            output_dim=16)
MERGES = [("Ġ", "a"), ("c", "a"), ("ca", "t"), ("o", "n")]
MAPPER_ARGS = ["--prefix_length", "4", "--clip_prefix_length", "2", "--num_layers", "1",
               "--num_attention_heads", "2", "--prefix_size", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_tiny_vit():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(TC.ViTConfig, "clip_variant", classmethod(lambda cls, name: cls(style="clip",
                                                                                **VIT)))
    yield
    mp.undo()
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A GPT-2 vocabulary and a tiny LM config, two files of prefix shards
    (a batch of 4 straddles them), a COCO folder of 6 JPEGs with 2
    captions each, and an OpenAI-layout CLIP state dict with its merges."""
    from PIL import Image

    d = tmp_path_factory.mktemp("train")
    base = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(dict.fromkeys(
        base + ["".join(m) for m in MERGES] + ["<|endoftext|>"]))}
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.json").write_text(json.dumps(vocab))
    (d / "vocab" / "merges.txt").write_text("\n".join(f"{a} {b}" for a, b in MERGES) + "\n")
    lm = TC.GPT2Config(vocab_size=len(vocab), n_positions=128, n_embd=32, n_layer=2, n_head=2)
    (d / "lm.json").write_text(lm.to_json())

    rng = np.random.default_rng(0)
    for i, n in enumerate((10, 7)):
        write_npy_shard(d / "shards" / "prefixes" / f"{i}.npy",
                        rng.normal(size=(n, 16)).astype(np.float32))
        tokens = rng.integers(1, len(vocab), size=(n, 9)).astype(np.int64)
        tokens[:, 6:] = -1
        write_npy_shard(d / "shards" / "tokens" / f"{i}.npy", tokens)

    (d / "images").mkdir()
    images, annotations = [], []
    for i in range(6):
        name = f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(
            d / "images" / name)
        images.append({"id": i, "file_name": name, "coco_url": f"http://x/{name}"})
        for j in range(2):
            annotations.append({"image_id": i, "id": 10 * i + j,
                                "caption": f"a cat on a mat {i} {j}."})
    (d / "captions.json").write_text(json.dumps({"images": images, "annotations": annotations}))
    clip_sd = openai_clip_state_dict(VIT, TEXT)
    torch.save({k: torch.from_numpy(v) for k, v in clip_sd.items()}, d / "clip.pt")
    (d / "clip_merges.txt").write_text("#version: 0.2\nc a\nca t</w>\n")
    return d


def _common(world, out, *extra):
    return ["--tokenizer_vocab_dir", str(world / "vocab"), "--lm_config_json",
            str(world / "lm.json"), "--output_dir", str(out), "--device", "cpu",
            "--batch_size", "4", "--epochs", "1", "--log_every_n_steps", "1",
            "--scheduler_warmup_steps", "2", "--optimizer_lr", "1e-3", "--seed", "3",
            *MAPPER_ARGS, *extra]


def _shards(world, out, *extra):
    return _common(world, out, "--prefix_data_path", str(world / "shards"), "--max_steps", "4",
                   *extra)


def _losses(out):
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r["loss"] for r in lines if "loss" in r}, lines


def test_prefix_shards_train_checkpoint_and_resume(world, tmp_path):
    full = tmp_path / "full"
    res = train_cli.main(_shards(world, full, "--save_every_steps", "3",
                                 "--save_every_epochs", "0"))
    model = res["state"].model
    assert res["total_steps"] == 4 and int(res["state"].step) == 4
    losses, lines = _losses(full)
    assert sorted(losses) == [1, 2, 3, 4] and all(math.isfinite(v) for v in losses.values())
    assert all({"grad_norm_pre_clip", "autoclip_value", "steps_per_sec", "epoch"} <= set(r)
               for r in lines)
    assert sorted(p.name for p in full.iterdir()) == ["demo_model_final", "demo_model_latest",
                                                      "metrics.jsonl"]
    # the final checkpoint serves the loaders as it is, bit for bit
    bundle = loading.load_captioner_bundle(str(full / "demo_model_final"),
                                           str(world / "vocab"), device="cpu")
    assert bundle.model.visual is None
    want = model.state_dict()
    for name, p in bundle.model.state_dict().items():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), name
    # a resume from step 3 takes step 4 as the uninterrupted run did
    resumed_dir = tmp_path / "resumed"
    resumed = train_cli.main(_shards(world, resumed_dir, "--resume_from",
                                     str(full / "demo_model_latest")))
    r_losses, _ = _losses(resumed_dir)
    assert sorted(r_losses) == [4] and r_losses[4] == losses[4]
    got = resumed["state"].model.state_dict()
    for name, p in model.state_dict().items():
        assert torch.equal(got[name], p), name
    for a, b in zip(resumed["state"].opt_state.mu + resumed["state"].opt_state.nu,
                    res["state"].opt_state.mu + res["state"].opt_state.nu):
        assert torch.equal(a, b)
    assert torch.equal(resumed["state"].autoclip.history, res["state"].autoclip.history)


def test_accumulation_stacks_loader_batches(world, tmp_path):
    """--acc_grad_batches 2 at batch 2 takes the rows batch 4 takes, as
    two micro-batches: the same losses (the padding is the same in every
    row, so the micro-batch means average to the batch mean) within one
    bf16 step, 2^-8 relative (the CLI always computes in bf16, as JAX's
    --use_16bit_precision cannot be turned off)."""
    acc = train_cli.main(_shards(world, tmp_path / "acc", "--batch_size", "2",
                                 "--acc_grad_batches", "2"))
    full = train_cli.main(_shards(world, tmp_path / "full"))
    assert int(acc["state"].step) == int(full["state"].step) == 4
    a, _ = _losses(tmp_path / "acc")
    f, _ = _losses(tmp_path / "full")
    np.testing.assert_allclose([a[i] for i in sorted(a)], [f[i] for i in sorted(f)],
                               rtol=2.0 ** -8)


def test_prefix_only_leaves_lm_bit_for_bit(world, tmp_path):
    from clipcap_tpu_torch.models.captioner import Captioner

    res = train_cli.main(_shards(world, tmp_path, "--prefix_only"))
    model = res["state"].model
    cap_cfg, lm_cfg, _ = train_cli.build_configs(train_cli.build_argparser().parse_args(
        _shards(world, tmp_path, "--prefix_only")))
    fresh = Captioner(cap_cfg, lm_cfg, device="cpu", seed=3)
    for (name, p), (_, q) in zip(model.lm.named_parameters(), fresh.lm.named_parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q.to(torch.bfloat16)), name
    assert any(not torch.equal(p, q) for p, q in zip(model.mapper.parameters(),
                                                     fresh.mapper.parameters()))
    assert len(res["state"].opt_state.mu) == len(list(model.mapper.parameters()))


@pytest.mark.parametrize("train_visual", [False, True])
def test_coco_pixels_with_validation(world, tmp_path, train_visual):
    from clipcap_tpu_torch.tools import import_weights as W

    sd = loading.load_state_dict(str(world / "clip.pt"))
    args = _common(world, tmp_path, "--input_dataset", str(world / "captions.json"),
                   "--image_folder_path", str(world / "images"),
                   "--visual_encoder_type", "CLIP", "--visual_encoder_model_variant", "ViT-B/32",
                   "--visual_checkpoint", str(world / "clip.pt"), "--max_steps", "2",
                   "--max_token_length", "16",
                   "--valid_json_path", str(world / "captions.json"),
                   "--valid_image_folder_path", str(world / "images"),
                   "--val_clip_checkpoint", str(world / "clip.pt"),
                   "--clip_merges", str(world / "clip_merges.txt"),
                   "--validation_interval", "2", "--limit_val_batches", "2",
                   *(["--train_visual_encoder"] if train_visual else []))
    res = train_cli.main(args)
    losses, lines = _losses(tmp_path)
    assert sorted(losses) == [1, 2] and all(math.isfinite(v) for v in losses.values())
    val = [r for r in lines if "val/validation_loss" in r]
    assert len(val) == 1 and math.isfinite(val[0]["val/validation_loss"])
    assert any(r.get("table") == "caption_samples" for r in lines)
    vit_cfg = TC.ViTConfig.clip_variant("ViT-B/32")
    loaded = W.clip_vit_from_openai_state_dict(sd, vit_cfg)
    visual = res["state"].model.visual
    moved = [not torch.equal(p.float(), torch.from_numpy(np.asarray(loaded[n])).to(p.dtype).float())
             for n, p in visual.named_parameters()]
    assert any(moved) if train_visual else not any(moved)
    assert all(p.dtype == (torch.float32 if train_visual else torch.bfloat16)
               for p in visual.parameters())


@pytest.mark.parametrize("extra,match", [
    (["--mesh_data", "2"], "needs 2 devices, have 1"),
    (["--mesh_model", "2"], "needs 2 devices, have 1"),
    (["--zero_shard_params", "--mesh_data", "4"], "needs 4 devices, have 1")],
    ids=["extra0-item 12", "extra1-item 12", "extra2-item 12"])
def test_refused_options(world, tmp_path, extra, match):
    """A mesh of more ranks than the run has raises JAX's ValueError (the
    layouts themselves: tests/test_torch_parallel_train.py)."""
    with pytest.raises(ValueError, match=match):
        train_cli.main(_common(world, tmp_path, *extra))


def test_resume_needs_a_train_state(world, tmp_path):
    """An Orbax directory raises with read_params' message; a checkpoint
    of parameters alone (cli.infer's input) has no state to resume."""
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint

    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="consolidate"):
        train_cli.main(_shards(world, tmp_path / "out", "--resume_from", str(orbax)))
    args = _shards(world, tmp_path / "out")
    cap_cfg, lm_cfg, _ = train_cli.build_configs(train_cli.build_argparser().parse_args(args))
    save_checkpoint(str(tmp_path / "params_only"), Captioner(cap_cfg, lm_cfg, device="cpu"),
                    cap_cfg, lm_cfg)
    with pytest.raises(KeyError, match="no train state"):
        train_cli.main(args + ["--resume_from", str(tmp_path / "params_only")])
