"""Training CLI (port of clipcap_tpu/cli/train.py).

Rebuild of the reference's ~45-flag train CLI (train.py:49-299) with the
JAX package's flags: dataclass configs, the train step of
train/train_step.py (bf16 compute, remat, accumulation, AutoClip via
gradient_clip_val=-1, train.py:283), the CheckpointSaver policy, and an
optional COCO validator with the no-beam pair and the CLIP-guided sampler
(train.py:203-234).

    python -m clipcap_tpu_torch.cli.train --tokenizer_vocab_dir GPT2_VOCAB \\
        --prefix_data_path SHARDS --prefix_size 512 --output_dir OUT

Data paths:
- --input_dataset + --image_folder_path: COCO-json images, visual encoder
  in the loop (train.py:146-152);
- --image_folder_path only: folder dataset (train.py:153-159);
- --prefix_data_path: preprocessed {prefixes,tokens}/*.npy shards (the
  README flow, read by TokenPrefixDataset): no visual encoder.

With --acc_grad_batches A, each step takes A loader batches, stacked on
a leading axis, and an epoch has 1/A as many steps (the JAX CLI hands the
step one unstacked batch). Everything runs on the card unless
`--device cpu`. --resume_from takes a checkpoint directory this CLI wrote
(`{prefix}_latest` and the others), or a train state the JAX package
saved, once JAX's `consolidate(ckpt, ckpt + "/consolidated.npz")` has
written it out (train/checkpoints.py): a run moves from the TPU to the
card mid-training, with the options it was trained with. The run
continues at the step after it.

Several cards: one process per card, `torchrun --nproc_per_node N -m
clipcap_tpu_torch.cli.train ...`, on JAX's (data, model) mesh: `data` is
world // --mesh_model with --mesh_data -1, and the model ranks are
replicas. Every rank reads the same global batches and trains on its rows;
--zero_shard_params keeps ZeRO shards of the masters and moments
(train/train_step.py). Global rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train the ClipCap captioner on the card")
    # data
    p.add_argument("--input_dataset", default=None, help="COCO train annotation json")
    p.add_argument("--image_folder_path", default=None)
    p.add_argument("--prefix_data_path", default=None, help="preprocessed npy shards")
    p.add_argument("--normalize_prefix", action="store_true")
    p.add_argument("--valid_json_path", default=None)
    p.add_argument("--valid_image_folder_path", default=None)
    p.add_argument("--replace_extension", default=None)
    p.add_argument("--max_token_length", type=int, default=96)
    # model
    p.add_argument("--language_model_type", default="gpt2")
    p.add_argument("--language_model_variant", default="gpt2")
    p.add_argument("--lm_config_json", default=None,
                   help="JSON file overriding the LM config (arbitrary sizes)")
    p.add_argument("--lm_checkpoint", default=None, help="HF state dict (.bin/.npz)")
    p.add_argument("--tokenizer_vocab_dir", required=True)
    p.add_argument("--visual_encoder_type", default="BLIP", choices=["BLIP", "CLIP", "none"])
    p.add_argument("--visual_encoder_model_variant", default="ViT-B")
    p.add_argument("--visual_checkpoint", default=None)
    p.add_argument("--train_visual_encoder", action="store_true")
    p.add_argument("--prefix_length", type=int, default=10)
    p.add_argument("--prefix_size", type=int, default=768)
    p.add_argument("--clip_prefix_length", type=int, default=50)
    p.add_argument("--pos_embeddings", action="store_true")
    p.add_argument("--use_all_vit_features", dest="use_all_vit_features",
                   action="store_true", default=True)
    p.add_argument("--no_all_vit_features", dest="use_all_vit_features", action="store_false")
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--num_attention_heads", type=int, default=8)
    p.add_argument("--mlp_ratio", type=float, default=4.0)
    p.add_argument("--prefix_init_std", type=float, default=1.0)
    p.add_argument("--act_fn_name", default="relu")
    p.add_argument("--prefix_only", action="store_true")
    # optimization
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--optimizer_lr", type=float, default=2e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--scheduler_warmup_steps", type=int, default=2000)
    p.add_argument("--gradient_clip_val", type=float, default=-1.0)
    p.add_argument("--autoclip_p", type=float, default=10.0)
    p.add_argument("--acc_grad_batches", type=int, default=1)
    p.add_argument("--gradient_checkpointing_enable", dest="remat",
                   action="store_true", default=True)
    p.add_argument("--no_gradient_checkpointing", dest="remat", action="store_false")
    p.add_argument("--use_16bit_precision", action="store_true", default=True)
    # distribution: JAX's (data, model) mesh over the torchrun world
    p.add_argument("--mesh_data", type=int, default=-1, help="-1 = world // mesh_model")
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--zero_shard_params", action="store_true",
                   help="ZeRO-style param/opt-state sharding over the data axis")
    # logging / checkpoints / validation
    p.add_argument("--output_dir", default="./models/")
    p.add_argument("--output_name_prefix", default="demo_model")
    p.add_argument("--save_every_epochs", type=int, default=1)
    p.add_argument("--save_every_steps", type=int, default=10000)
    p.add_argument("--validation_interval", type=float, default=1000)
    p.add_argument("--limit_val_batches", type=int, default=100)
    p.add_argument("--val_clip_model", default="ViT-B/32")
    p.add_argument("--val_clip_checkpoint", default=None)
    p.add_argument("--clip_merges", default=None)
    p.add_argument("--log_every_n_steps", type=int, default=5)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", default="CLIP-Image-Captioning")
    p.add_argument("--wandb_name", default=None)
    p.add_argument("--max_log_samples", type=int, default=64)
    p.add_argument("--max_steps", type=int, default=None, help="cap steps (debug)")
    p.add_argument("--resume_from", default=None,
                   help="checkpoint directory to resume params/opt-state/step from: one this "
                        "CLI wrote, or a JAX package checkpoint with the consolidated.npz "
                        "that its consolidate() writes")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def build_configs(args):
    from ..core.config import CaptionerConfig, MapperConfig
    from ..lm.registry import get_lm_config

    lm_cfg = get_lm_config(args.language_model_type, args.language_model_variant)
    if getattr(args, "lm_config_json", None):
        lm_cfg = type(lm_cfg).from_json(Path(args.lm_config_json).read_text())
    mapper_cfg = MapperConfig(
        dim_clip=args.prefix_size,
        dim_embedding=next((getattr(lm_cfg, n) for n in ("n_embd", "d_model", "hidden_size")
                            if hasattr(lm_cfg, n)), None),
        prefix_length=args.prefix_length,
        clip_length=args.clip_prefix_length,
        num_layers=args.num_layers,
        num_heads=args.num_attention_heads,
        mlp_ratio=args.mlp_ratio,
        prefix_init_std=args.prefix_init_std,
        act_fn=args.act_fn_name,
        use_all_features=args.use_all_vit_features and args.prefix_data_path is None,
        use_pos_embeddings=args.pos_embeddings,
    )
    cap_cfg = CaptionerConfig(
        lm_type=args.language_model_type,
        lm_variant=args.language_model_variant,
        visual_encoder_type=args.visual_encoder_type if args.prefix_data_path is None else "none",
        visual_encoder_variant=args.visual_encoder_model_variant,
        train_visual_encoder=args.train_visual_encoder,
        prefix_only=args.prefix_only,
        mapper=mapper_cfg,
        normalize_prefix=args.normalize_prefix,
    )
    train_cfg_kwargs = dict(
        batch_size=args.batch_size,
        epochs=args.epochs,
        optimizer_lr=args.optimizer_lr,
        weight_decay=args.weight_decay,
        scheduler_warmup_steps=args.scheduler_warmup_steps,
        autoclip_percentile=args.autoclip_p,
        gradient_clip_val=args.gradient_clip_val,
        accumulate_grad_batches=args.acc_grad_batches,
        remat=args.remat,
        bf16_compute=args.use_16bit_precision,
        max_token_length=args.max_token_length,
        validation_interval=int(args.validation_interval),
        limit_val_batches=args.limit_val_batches,
        save_every_epochs=args.save_every_epochs,
        save_every_steps=args.save_every_steps,
        seed=args.seed,
        mesh_data=args.mesh_data,
        mesh_model=args.mesh_model,
        zero_shard_params=args.zero_shard_params,
        log_every_n_steps=args.log_every_n_steps,
    )
    return cap_cfg, lm_cfg, train_cfg_kwargs


def _make_mesh(args):
    """JAX's layout (clipcap_tpu/cli/train.py:253-277) over the torchrun
    world, or None for one process asked for no mesh. `data` is
    world // mesh_model with --mesh_data -1; a batch that `data` does not
    divide shrinks it to the largest divisor of both, with JAX's warning.
    A mesh that does not take the whole world raises JAX's ValueError,
    before any process group is joined."""
    from ..core.mesh import MeshSpec, check_mesh, launched_world_size, make_mesh

    world = launched_world_size()
    if (world == 1 and args.mesh_data in (-1, 1) and args.mesh_model == 1
            and not args.zero_shard_params):
        return None
    data_axis = (max(1, world // args.mesh_model) if args.mesh_data == -1
                 else args.mesh_data)
    if args.batch_size % data_axis != 0:
        fallback = max(d for d in range(1, data_axis + 1)
                       if args.batch_size % d == 0 and data_axis % d == 0)
        print(f"WARNING: batch_size {args.batch_size} not divisible by data axis "
              f"{data_axis}; using data={fallback}")
        data_axis = fallback
    spec = MeshSpec(data=data_axis, model=args.mesh_model)
    check_mesh(spec, world)
    import torch

    return make_mesh(spec, device_type=torch.device(args.device).type)


def train(args) -> dict:
    from ..core.config import TrainConfig, ViTConfig
    from ..data.coco import BatchLoader, CocoCaptionDataset, FolderCaptionDataset
    from ..data.preprocessing import blip_preprocess, clip_preprocess
    from ..data.token_prefix import TokenPrefixDataset
    from ..models.captioner import Captioner
    from ..tokenizers import create_tokenizer
    from ..train.checkpoints import CheckpointSaver, restore_checkpoint
    from ..train.train_step import create_train_state
    from ..train.trainer import fit
    from ..utils.logging import MetricLogger

    from ..core.mesh import is_writer

    mesh = _make_mesh(args)
    if is_writer():
        print("Args:", vars(args))
    cap_cfg, lm_cfg, train_cfg_kwargs = build_configs(args)
    tokenizer = create_tokenizer(args.language_model_type, args.tokenizer_vocab_dir)

    # ---- dataset -------------------------------------------------------------
    use_prefix_shards = args.prefix_data_path is not None
    vit_cfg = preprocess = None
    if use_prefix_shards:
        dataset = TokenPrefixDataset(args.prefix_data_path, batch_size=args.batch_size,
                                     normalize_prefix=args.normalize_prefix)
        steps_per_epoch = len(dataset)
        data_iter = iter(dataset)
    else:
        if args.visual_encoder_type == "BLIP":
            vit_cfg = ViTConfig.blip_variant(args.visual_encoder_model_variant)
            preprocess = lambda img: blip_preprocess(img, vit_cfg.image_size)  # noqa: E731
        elif args.visual_encoder_type == "CLIP":
            vit_cfg = ViTConfig.clip_variant(args.visual_encoder_model_variant)
            preprocess = lambda img: clip_preprocess(img, vit_cfg.image_size)  # noqa: E731
        else:
            raise RuntimeError(
                f"Unsupported visual encoder '{args.visual_encoder_type}' specified.")
        if args.input_dataset is not None:
            dataset = CocoCaptionDataset(
                args.input_dataset, args.image_folder_path, tokenizer, preprocess,
                max_token_length=args.max_token_length,
                replace_extension=args.replace_extension)
        elif args.image_folder_path is not None:
            dataset = FolderCaptionDataset(args.image_folder_path, tokenizer, preprocess,
                                           max_token_length=args.max_token_length)
        else:
            raise RuntimeError("Neither input_dataset nor image_folder_path was specified.")
        steps_per_epoch = len(dataset) // args.batch_size
        data_iter = iter(BatchLoader(dataset, batch_size=args.batch_size, shuffle=True,
                                     seed=args.seed))

    # each step takes acc_grad_batches loader batches (train/trainer.fit)
    steps_per_epoch //= max(args.acc_grad_batches, 1)
    total_steps = steps_per_epoch * args.epochs
    if args.max_steps is not None:
        steps_per_epoch = min(steps_per_epoch, args.max_steps)
        total_steps = min(total_steps, args.max_steps * args.epochs)
    train_cfg = TrainConfig(total_steps=total_steps, **train_cfg_kwargs)

    # ---- model ---------------------------------------------------------------
    model = Captioner(cap_cfg, lm_cfg, vit_cfg=vit_cfg, device=args.device, seed=args.seed)
    if args.lm_checkpoint:
        _load_lm(model, args)
    if vit_cfg is not None:
        if args.visual_checkpoint:
            _load_visual(model, vit_cfg, args.visual_checkpoint, args.visual_encoder_type)
        else:
            print("WARNING: no --visual_checkpoint; random visual encoder weights")

    state, tx = create_train_state(args.seed, cap_cfg, lm_cfg, train_cfg, model=model,
                                   device=args.device, mesh=mesh,
                                   zero=args.zero_shard_params)
    if args.resume_from:
        # the reference has no explicit resume wiring; its "latest"
        # checkpoints exist for exactly this (train.py:37-42)
        state = restore_checkpoint(args.resume_from, template=state)
        if is_writer():
            print(f"resumed from {args.resume_from} at step {int(state.step)}")

    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    writer = is_writer()
    logger = MetricLogger(jsonl_path=str(Path(args.output_dir) / "metrics.jsonl") if writer
                          else None, use_wandb=args.use_wandb and writer,
                          wandb_project=args.wandb_project, wandb_name=args.wandb_name)
    saver = CheckpointSaver(args.output_dir, args.output_name_prefix,
                            save_every_n_epochs=args.save_every_epochs,
                            save_every_n_steps=args.save_every_steps)

    # ---- optional validator -----------------------------------------------------
    validate_fn = None
    if args.valid_json_path and not use_prefix_shards:
        validate_fn = _build_validator(args, cap_cfg, lm_cfg, tokenizer, vit_cfg, preprocess)

    if writer:
        print("Train only Prefix." if cap_cfg.prefix_only
              else "Train both Prefix and Language Model.")

    try:
        state = fit(state, tx, cap_cfg, lm_cfg, train_cfg, data_iter,
                    steps_per_epoch=steps_per_epoch, checkpoint_saver=saver, logger=logger,
                    validate_fn=validate_fn, visual_cfg=vit_cfg, mesh=mesh)
    finally:
        logger.close()
    return {"state": state, "total_steps": total_steps}


def _load_lm(model, args) -> None:
    from .. import convert
    from ..lm.registry import family
    from .loading import load_state_dict

    from_hf = family(args.language_model_type).from_hf
    convert.load(model.lm, from_hf(load_state_dict(args.lm_checkpoint), model.lm.cfg))
    print(f"loaded LM weights from {args.lm_checkpoint}")


def _load_visual(model, vit_cfg, checkpoint: str, encoder_type: str) -> None:
    """The image tower: BLIP's from an HF BlipVisionModel state dict (bare,
    or a whole BLIP checkpoint's `vision_model.*`), CLIP's from an OpenAI
    (keys `visual.*`) or HF state dict (JAX cli/train.py:238-250)."""
    from .. import convert
    from ..tools import import_weights as W
    from .loading import load_state_dict

    sd = load_state_dict(checkpoint)
    if encoder_type == "BLIP":
        convert.load(model.visual, W.blip_vit_from_hf_state_dict(sd, vit_cfg))
    elif any(k.startswith("visual.") for k in sd):
        convert.load(model.visual, W.clip_vit_from_openai_state_dict(sd, vit_cfg))
    else:
        convert.load(model.visual, W.clip_vit_from_hf_state_dict(sd, vit_cfg))


def _build_validator(args, cap_cfg, lm_cfg, tokenizer, vit_cfg, preprocess):
    """Wire the COCO validator (reference train.py:203-234): CLIP scoring
    and the no-beam pair (top-p 0.1/0.2) and CLIP-guided (branching 2,
    look-ahead 4) samplers over --limit_val_batches validation images, in
    chunks of 8. Needs --val_clip_checkpoint/--clip_merges; otherwise
    validation is skipped with a notice (CLIP assets are pretrained files)."""
    if not args.val_clip_checkpoint or not args.clip_merges:
        print("no --val_clip_checkpoint/--clip_merges: skipping CLIP-scored "
              "validation (use cli/evaluate.py post-hoc)")
        return None

    from ..data.coco import CocoImageDataset, FolderImageDataset
    from ..eval.clip_scoring import ClipScoring
    from .evaluate import build_validator
    from .loading import load_clip_ranker

    if args.valid_json_path:
        dataset = CocoImageDataset(args.valid_json_path, args.valid_image_folder_path,
                                   replace_extension=args.replace_extension)
    elif args.valid_image_folder_path:
        dataset = FolderImageDataset(args.valid_image_folder_path)
    else:
        return None

    ranker = load_clip_ranker(args.val_clip_model, args.val_clip_checkpoint, args.clip_merges,
                              device=args.device)
    scoring = ClipScoring(ranker.visual, ranker.text, ranker.tokenizer)
    limit = args.limit_val_batches

    def validate_fn(state):
        from ..models.bundle import CaptionerBundle

        bundle = CaptionerBundle(state.model, cap_cfg, lm_cfg, tokenizer, vit_cfg=vit_cfg,
                                 device=args.device)
        validator = build_validator(bundle, scoring, dataset, preprocess=preprocess)
        # chunks of 8: batched samplers run once per chunk (beam and
        # CLIP-guided per-image exact; no-beam equal in distribution)
        n = min(limit, len(dataset))
        for i in range(0, n, 8):
            items = [x for x in (dataset[j] for j in range(i, min(i + 8, n))) if x is not None]
            if items:
                validator.process(bundle, items)
        return validator.get_results()  # "captions" feeds the sample table

    return validate_fn


def main(argv=None):
    from ..core.mesh import process_group_scope

    args = build_argparser().parse_args(argv)
    with process_group_scope():
        return train(args)


if __name__ == "__main__":
    main()
