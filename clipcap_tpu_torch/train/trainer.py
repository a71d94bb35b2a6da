"""The training loop: host-side orchestration around the train step (port
of clipcap_tpu/train/trainer.py).

What pl.Trainer did for the reference (train.py:275-292): epochs, periodic
validation via a CaptionValidator, checkpoint callbacks, metric logging.
Host work is batch staging (one copy to the card per array) and logging,
whose metrics come back in one device-to-host copy per logged step.

With accumulate_grad_batches A, a step takes the next A batches of the
iterator, stacked on a leading [A] axis.

A state restored from a checkpoint (state.step > 0) continues where its
run stopped: the data iterator is advanced past the batches that run
consumed, and the epoch and step counters resume there, so the next step
is the step an uninterrupted run would take. (The JAX loop restarts the
data and runs the full count again after a resume.)

With a `mesh` every rank reads the same global batches, in the one-process
order, and hands the step its rows of each (JAX's shard_batch).

With a tracer active (utils/profiling.py), each step is the call-stack
span `train.step`, and inside it `train.data` covers the batch's fetch and
this rank's row split, not its copy to the card: a copy from pageable host
memory waits for the card's work queued before it, which is not the data's
(train/train_step.py adds `train.grad_sync`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from ..core.config import CaptionerConfig, TrainConfig
from ..utils import profiling as P
from ..utils.logging import MetricLogger
from .checkpoints import CheckpointSaver
from .train_step import TrainState, make_train_step


def fit(
    state: TrainState,
    tx,
    cap_cfg: CaptionerConfig,
    lm_cfg: Any,
    train_cfg: TrainConfig,
    data_iter: Iterable,  # yields {"tokens": [B,T] int64, "prefix": f32} or (tokens, prefixes)
    steps_per_epoch: int,
    checkpoint_saver: Optional[CheckpointSaver] = None,
    logger: Optional[MetricLogger] = None,
    validate_fn: Optional[Callable] = None,
    visual_cfg=None,
    mesh=None,
    lm_apply=None,
) -> TrainState:
    logger = logger or MetricLogger()
    step_fn = make_train_step(cap_cfg, lm_cfg, train_cfg, tx, visual_cfg=visual_cfg,
                              lm_apply=lm_apply, mesh=mesh)
    device = state.step.device

    it = iter(data_iter)
    a = max(train_cfg.accumulate_grad_batches, 1)
    global_step = int(state.step)
    for _ in range(global_step * a):  # the batches the restored run consumed
        next(it)
    t_last = time.time()

    for epoch in range(global_step // max(steps_per_epoch, 1), train_cfg.epochs):
        first = global_step - epoch * steps_per_epoch
        for _ in range(first, steps_per_epoch):
            tr = P.active()
            if tr is not None:
                tr.begin("train.step")
                tr.begin("train.data")
            batch = _next_batch(it, a)
            if mesh is not None:  # this rank's rows (the batch axis follows [A])
                batch = _data_rows(mesh, batch, axis=0 if a == 1 else 1)
            if tr is not None:
                tr.end()
            batch = {k: torch.tensor(v, device=device) for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            if tr is not None:
                tr.end()
            global_step += 1

            if global_step % train_cfg.log_every_n_steps == 0:
                # the whole metrics dict in one copy to the host
                values = torch.stack([v.float() for v in metrics.values()]).cpu().tolist()
                m = dict(zip(metrics, values))
                now = time.time()
                m["steps_per_sec"] = train_cfg.log_every_n_steps / max(now - t_last, 1e-9)
                m["epoch"] = epoch
                t_last = now
                logger.log(m, step=global_step)

            if checkpoint_saver is not None:
                checkpoint_saver.on_step(global_step, state, cap_cfg=cap_cfg, lm_cfg=lm_cfg,
                                         train_cfg=train_cfg)

            if (validate_fn is not None and train_cfg.validation_interval > 0
                    and global_step % int(train_cfg.validation_interval) == 0):
                results = validate_fn(state)
                logger.log({f"val/{k}": v for k, v in _flatten(results).items()},
                           step=global_step)
                _log_caption_table(logger, results)

        if checkpoint_saver is not None:
            checkpoint_saver.on_epoch_end(epoch, state, cap_cfg=cap_cfg, lm_cfg=lm_cfg,
                                          train_cfg=train_cfg)

    if checkpoint_saver is not None:
        checkpoint_saver.save_final(state, cap_cfg=cap_cfg, lm_cfg=lm_cfg, train_cfg=train_cfg)
    return state


def _next_batch(it, a: int) -> dict:
    """The next step's batch: one loader batch, or with gradient
    accumulation the next `a` stacked on a leading [A] axis."""
    if a == 1:
        return _as_batch(next(it))
    items = [_as_batch(next(it)) for _ in range(a)]
    return {k: np.stack([x[k] for x in items]) for k in items[0]}


def _data_rows(mesh, batch: dict, axis: int) -> dict:
    from ..core.mesh import data_rows

    out = {}
    for k, v in batch.items():
        lo, hi = data_rows(mesh, v.shape[axis])
        out[k] = np.take(v, np.arange(lo, hi), axis=axis)
    return out


def _as_batch(item) -> dict:
    """Normalize to {"tokens", "prefix"|"pixels"} numpy arrays.

    Accepts (tokens, prefixes) tuples (TokenPrefixDataset), dicts with
    "prefix", or dicts with "image_tensor"/"pixels" (raw-image path)."""
    if isinstance(item, dict):
        out = {"tokens": np.asarray(item["tokens"])}
        if "prefix" in item:
            out["prefix"] = np.asarray(item["prefix"])
        elif "pixels" in item:
            out["pixels"] = np.asarray(item["pixels"])
        elif "image_tensor" in item:
            out["pixels"] = np.asarray(item["image_tensor"])
        else:
            raise KeyError("batch needs 'prefix', 'pixels' or 'image_tensor'")
        return out
    tokens, prefix = item
    return {"tokens": np.asarray(tokens), "prefix": np.asarray(prefix)}


def _log_caption_table(logger, results, max_rows: int = 64):
    """The validation caption table (reference model.py:102-130): one row
    per (image, sampler, caption) with CLIP score and the first GT."""
    captions = results.get("captions") if isinstance(results, dict) else None
    if not captions:
        return
    columns = ["image_id", "image_url", "caption", "clip_score", "gt", "sampler_id"]
    rows = []
    for image in captions:
        for sr in image.get("sampling_results", []):
            for c in sr.get("captions", []):
                rows.append([
                    image.get("image_id"), image.get("image_url"),
                    c.get("caption"), c.get("clip_score"), c.get("gt"),
                    sr.get("sampler_id"),
                ])
                if len(rows) >= max_rows:
                    break
    logger.log_table("caption_samples", columns, rows)


def _flatten(d, prefix=""):
    out = {}
    if not isinstance(d, dict):
        return {prefix or "value": d}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, (int, float, np.floating, np.integer)):
            out[key] = float(v)
    return out
