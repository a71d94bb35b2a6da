"""The checkpoint the port reads and writes (port of
clipcap_tpu/train/checkpoints.py: `_config_payload`, `load_config`,
`save_checkpoint`, `restore_checkpoint` and `CheckpointSaver`, in the
layout of `consolidate`).

A checkpoint is a directory holding
- `clipcap_config.json`: {"captioner", "lm", "train"} config dicts, so
  inference rebuilds the model without outside arguments;
- `consolidated.npz`: one array per leaf of the saved state, under its
  "."-joined pytree path (`params.mapper.linear.w`, list indices as
  numbers), in the JAX package's parameter layout (layers stacked on a
  leading [L] axis, linear weights [in, out]). A train state adds, beside
  `params.`, what a resume needs: `step`, `opt_state.count`, the Adam
  moments `opt_state.mu.NAME` and `opt_state.nu.NAME` of the trainable
  parameters under the port's parameter names, and the AutoClip ring
  `autoclip.history`, `autoclip.count`, `autoclip.pos`. The loaders read
  `params.` alone, so a trained checkpoint serves cli.infer and
  cli.evaluate as it is.

`restore_checkpoint` also resumes a train state that the JAX package
saved: its Orbax directory consolidated by JAX's `consolidate(path, path +
"/consolidated.npz")`. There the optimizer state is optax's: under
`opt_state.inner_states.train.inner_state.` the Adam count and moments
(`0.count`, `0.mu.PATH`, `0.nu.PATH`, where PATH is a trainable leaf's
path in JAX's parameter tree: the frozen branch of `multi_transform`
holds no state) and the schedule's count (`2.count`). The moments go
through the parameters' own conversion (convert.captioner_state_dict):
Adam is elementwise, so the transposes, the fused qkv and the [L]
unstacking are the same. So a run moves from the TPU to the card mid-
training; the JAX package resumes only from Orbax, so a port checkpoint
does not go back.

The JAX package saves Orbax directories, which need JAX to read; the
port reads the `.npz` that `consolidate` writes beside them.
`save_checkpoint` writes the same layout from a port Captioner, so the
JAX package's `consolidate` format round-trips. The names JAX's
CheckpointSaver gives (`{prefix}_epoch_{e}`, `{prefix}_latest`,
`{prefix}_final`) are directories here too.

Each leaf keeps its dtype. `consolidate` writes a bf16 leaf as 2-byte
records (`np.asarray` of a JAX bf16 array is an ml_dtypes bfloat16
array), which `np.load` gives back as `|V2`; `read_params` passes them on
as such and `convert.load` turns them into torch.bfloat16 bit for bit.
`save_checkpoint` writes a bf16 parameter as the same records (numpy
writes their header as `|V2` where ml_dtypes writes `<V2`; both load as
`|V2`), so a bf16 checkpoint round-trips bit for bit both ways.

In a multi-process run every rank calls the writer (a ZeRO state's moments
are all-gathered first, a collective), and global rank 0 alone writes: a
ZeRO run's file is a plain run's, and resumes with or without ZeRO; so
does a JAX state.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np

from .. import convert

CONFIG_FILE = "clipcap_config.json"
PARAMS_FILE = "consolidated.npz"
# optax's state in a consolidated JAX TrainState: multi_transform's "train"
# branch, the adamw chain (0: scale_by_adam, 2: the schedule's count)
JAX_ADAM = "opt_state.inner_states.train.inner_state.0."
JAX_SCHEDULE_COUNT = "opt_state.inner_states.train.inner_state.2.count"


def _config_payload(cap_cfg, lm_cfg, train_cfg) -> dict:
    return {
        "captioner": dataclasses.asdict(cap_cfg),
        "lm": dataclasses.asdict(lm_cfg),
        "train": dataclasses.asdict(train_cfg) if train_cfg else None,
    }


def load_config(path: str) -> dict:
    return json.loads((Path(path) / CONFIG_FILE).read_text())


def _flatten(prefix: str, node, out: dict) -> None:
    """consolidate's walk: dicts by key, lists and tuples by index."""
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(f"{prefix}.{i}", v, out)
    elif node is not None:
        out[prefix] = np.asarray(node)


def _unflatten(flat: dict) -> Any:
    """The inverse of _flatten: nested dicts, and lists where every key of
    a level is an index."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _npz(path) -> Path:
    """The .npz of the checkpoint directory `path`; an Orbax directory
    without one, or no checkpoint at all, raises FileNotFoundError."""
    path = Path(path)
    npz = path / PARAMS_FILE
    if not npz.exists():
        if path.is_dir() and any(p.name != CONFIG_FILE for p in path.iterdir()):
            raise FileNotFoundError(
                f"{path} holds no {PARAMS_FILE}: it looks like an Orbax checkpoint, which "
                f"needs JAX to read. Write the .npz beside it with the JAX package's "
                f"clipcap_tpu.train.checkpoints.consolidate({str(path)!r}, "
                f"{str(npz)!r}), then load it here.")
        raise FileNotFoundError(f"no checkpoint at {path}: {npz} does not exist")
    return npz


def read_params(path: str) -> dict:
    """The parameter pytree of the checkpoint directory `path` (the
    `params` subtree of the saved state when there is one), numpy arrays
    in their stored dtypes: a bf16 leaf is a `|V2` record array
    (convert.is_bf16_record), since numpy has no bf16."""
    with np.load(_npz(path), allow_pickle=False) as data:
        # a train state's moments and AutoClip ring are not read
        keys = [k for k in data.files if k.startswith("params.")] or data.files
        state = _unflatten({k: data[k] for k in keys})
    return state["params"] if isinstance(state, dict) and "params" in state else state


def save_checkpoint(path: str, state, cap_cfg, lm_cfg, train_cfg: Optional[Any] = None) -> None:
    """Write a port Captioner, or a train state (train/train_step.TrainState:
    its `model` and what a resume needs), as a checkpoint directory: the
    parameters in the JAX layout under `params.` and the config JSON.
    Every parameter is written in its own dtype, bf16 as the 2-byte
    records `consolidate` writes; a model whose submodules differ in dtype
    (an f32 mapper beside a bf16 LM) is written so, leaf by leaf, as JAX
    writes a mixed pytree."""
    from ..core.mesh import is_writer

    model = getattr(state, "model", state)
    shards = getattr(state, "shards", None)
    moments = None
    if model is not state:
        moments = {"mu": state.opt_state.mu, "nu": state.opt_state.nu}
        if shards is not None:  # every rank joins the gathers
            moments = {k: shards.gather(v) for k, v in moments.items()}
    if not is_writer():
        return
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat: dict = {}
    _flatten("", {"params": convert.captioner_params(model)}, flat)
    if model is not state:
        names = [n for n, keep in model.trainable_filter().items() if keep]
        flat["step"] = convert.to_numpy(state.step)
        flat["opt_state.count"] = convert.to_numpy(state.opt_state.count)
        for key, ms in moments.items():
            for name, m in zip(names, ms):
                flat[f"opt_state.{key}.{name}"] = convert.to_numpy(m)
        for key in ("history", "count", "pos"):
            flat[f"autoclip.{key}"] = convert.to_numpy(getattr(state.autoclip, key))
    np.savez(path / PARAMS_FILE, **flat)
    (path / CONFIG_FILE).write_text(
        json.dumps(_config_payload(cap_cfg, lm_cfg, train_cfg), indent=2))


def _port_moments(flat: dict, names, path):
    """count, mu, nu of the port's own layout (save_checkpoint's)."""
    missing = [n for n in names if f"opt_state.mu.{n}" not in flat]
    if missing:
        raise KeyError(f"{path} has no Adam moments for {missing[:3]}...: it was saved by a run "
                       f"that trained other parameters")
    return (flat["opt_state.count"], [flat[f"opt_state.mu.{n}"] for n in names],
            [flat[f"opt_state.nu.{n}"] for n in names])


def _jax_moments(flat: dict, names, lm_type: str, path):
    """count, mu, nu of a consolidated JAX TrainState, in the port's names
    and layout. The moments of the trainable leaves are put in a tree of
    the parameters' shapes and converted as the parameters are; a tree of
    ones over the leaves they cover, converted alike, says which port
    parameters they cover, and those must be the ones this run trains."""
    counts = {"Adam": flat[JAX_ADAM + "count"], "schedule": flat[JAX_SCHEDULE_COUNT],
              "step": flat["step"]}
    if len({int(c) for c in counts.values()}) != 1:
        raise ValueError(f"{path}: the JAX train state's counts disagree ({counts}); "
                         f"a resume needs one step count")
    leaves = {k[len("params."):]: v for k, v in flat.items() if k.startswith("params.")}
    moments = {}
    for key in ("mu", "nu"):
        prefix = f"{JAX_ADAM}{key}."
        moments[key] = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    strays = sorted(set(moments["mu"]) - set(leaves))
    if strays or set(moments["mu"]) != set(moments["nu"]):
        raise KeyError(f"{path}: the JAX train state's Adam moments name leaves its parameters "
                       f"do not have ({strays[:3]})")

    def convert_tree(values: dict):
        tree = _unflatten({k: values.get(k, np.zeros(np.shape(v), np.float32))
                           for k, v in leaves.items()})
        return convert.captioner_state_dict(tree, lm_type)

    covered = convert_tree({k: np.ones(np.shape(leaves[k]), np.float32) for k in moments["mu"]})
    trained = set(names)
    missing = [n for n in names if not covered[n].all()]
    extra = [n for n, c in covered.items() if n not in trained and c.any()]
    if missing or extra:
        raise KeyError(f"{path}: the JAX train state's Adam moments cover other parameters than "
                       f"this run trains (none for {missing[:3]}; moments for {extra[:3]}, "
                       f"which it does not train): resume with the options it was trained with "
                       f"(prefix_only, train_visual_encoder)")
    mu, nu = (convert_tree(moments[key]) for key in ("mu", "nu"))
    return counts["Adam"], [mu[n] for n in names], [nu[n] for n in names]


def restore_checkpoint(path: str, template):
    """The train state saved at `path`, restored onto `template` (a
    TrainState of the same configuration, train_step.create_train_state):
    its model's parameters are overwritten in place, each in its stored
    dtype, and the moments, AutoClip ring and step are read onto the
    model's device. `path` is a checkpoint the port wrote, or a JAX train
    state that the JAX package's `consolidate` wrote out (its optax state
    mapped to the port's parameters; its Adam count, schedule count and
    step must agree). Raises for a checkpoint without a train state (one
    written from a bare Captioner), for moments of other parameters than
    the template trains, for an AutoClip ring of another length than the
    template's, and, with read_params' message, for an Orbax directory."""
    model = template.model
    device = next(model.parameters()).device
    with np.load(_npz(path), allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    if "step" not in flat:
        raise KeyError(f"{path} holds parameters only, no train state to resume from")
    ring, want = np.shape(flat["autoclip.history"]), tuple(template.autoclip.history.shape)
    if ring != want:
        raise ValueError(f"{path}: its AutoClip ring holds {ring[0]} gradient norms where this "
                         f"run keeps {want[0]} (autoclip_history): resume with the history it "
                         f"was trained with")
    params = _unflatten({k: v for k, v in flat.items() if k.startswith("params.")})["params"]
    convert.load(model, convert.captioner_state_dict(params, model.cfg.lm_type))

    def tensor(value):
        return convert.to_torch(value).to(device)

    names = [n for n, keep in model.trainable_filter().items() if keep]
    if JAX_ADAM + "count" in flat:
        count, mu, nu = _jax_moments(flat, names, model.cfg.lm_type, path)
    else:
        count, mu, nu = _port_moments(flat, names, path)
    mu, nu = [tensor(m) for m in mu], [tensor(m) for m in nu]
    shards = getattr(template, "shards", None)
    if shards is not None:  # a ZeRO state keeps this rank's shards
        params = dict(model.named_parameters())
        mu, nu = shards.shard(mu), shards.shard(nu)
        shards.masters = shards.shard([params[n].detach() for n in names])
    opt_state = template.opt_state._replace(count=tensor(count), mu=mu, nu=nu)
    autoclip = type(template.autoclip)(*(tensor(flat[f"autoclip.{k}"])
                                         for k in ("history", "count", "pos")))
    return template._replace(opt_state=opt_state, autoclip=autoclip, step=tensor(flat["step"]))


class CheckpointSaver:
    """Epoch / step-interval / final checkpoint policy (reference
    train.py:20-47): `{prefix}_epoch_{e}` every save_every_n_epochs epochs,
    an overwritten `{prefix}_latest` every save_every_n_steps steps, and
    `{prefix}_final`."""

    def __init__(self, output_path: str, filename_prefix: str, save_every_n_epochs: int = 1,
                 save_every_n_steps: Optional[int] = 1000):
        self.output_path = Path(output_path)
        self.output_path.mkdir(exist_ok=True, parents=True)
        self.filename_prefix = filename_prefix
        self.save_every_n_epochs = save_every_n_epochs
        self.save_every_n_steps = save_every_n_steps

    def _save(self, name: str, state, **cfgs):
        save_checkpoint(str(self.output_path / name), state, **cfgs)

    def on_epoch_end(self, epoch: int, state, **cfgs):
        if self.save_every_n_epochs > 0 and epoch % self.save_every_n_epochs == 0:
            self._save(f"{self.filename_prefix}_epoch_{epoch}", state, **cfgs)

    def on_step(self, step: int, state, **cfgs):
        if (self.save_every_n_steps and self.save_every_n_steps > 0
                and step % self.save_every_n_steps == 0):
            self._save(f"{self.filename_prefix}_latest", state, **cfgs)

    def save_final(self, state, **cfgs):
        self._save(f"{self.filename_prefix}_final", state, **cfgs)
