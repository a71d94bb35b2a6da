"""The checkpoint the port reads and writes (port of the JAX-free half of
clipcap_tpu/train/checkpoints.py: `_config_payload`, `load_config` and the
layout of `consolidate`).

A checkpoint is a directory holding
- `clipcap_config.json`: {"captioner", "lm", "train"} config dicts, so
  inference rebuilds the model without outside arguments;
- `consolidated.npz`: one array per leaf of the saved state, under its
  "."-joined pytree path (`params.mapper.linear.w`, list indices as
  numbers), in the JAX package's parameter layout (layers stacked on a
  leading [L] axis, linear weights [in, out]).

The JAX package saves Orbax directories, which need JAX to read. Its
`consolidate(path, path + "/consolidated.npz")` writes the `.npz` beside
them; the port reads that. `save_checkpoint` writes the same layout from
a port Captioner, so the JAX package's `consolidate` format round-trips.

Each leaf keeps its dtype. `consolidate` writes a bf16 leaf as 2-byte
records (`np.asarray` of a JAX bf16 array is an ml_dtypes bfloat16
array), which `np.load` gives back as `|V2`; `read_params` passes them on
as such and `convert.load` turns them into torch.bfloat16 bit for bit.
`save_checkpoint` writes a bf16 parameter as the same records (numpy
writes their header as `|V2` where ml_dtypes writes `<V2`; both load as
`|V2`), so a bf16 checkpoint round-trips bit for bit both ways.
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


def read_params(path: str) -> dict:
    """The parameter pytree of the checkpoint directory `path` (the
    `params` subtree of the saved state when there is one), numpy arrays
    in their stored dtypes: a bf16 leaf is a `|V2` record array
    (convert.is_bf16_record), since numpy has no bf16."""
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
    with np.load(npz, allow_pickle=False) as data:
        state = _unflatten({k: data[k] for k in data.files})
    return state["params"] if isinstance(state, dict) and "params" in state else state


def save_checkpoint(path: str, model, cap_cfg, lm_cfg, train_cfg: Optional[Any] = None) -> None:
    """Write the port Captioner `model` as a checkpoint directory: its
    parameters in the JAX layout under `params.` and the config JSON.
    Every parameter is written in its own dtype, bf16 as the 2-byte
    records `consolidate` writes; a model whose submodules differ in dtype
    (an f32 mapper beside a bf16 LM) is written so, leaf by leaf, as JAX
    writes a mixed pytree."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat: dict = {}
    _flatten("", {"params": convert.captioner_params(model)}, flat)
    np.savez(path / PARAMS_FILE, **flat)
    (path / CONFIG_FILE).write_text(
        json.dumps(_config_payload(cap_cfg, lm_cfg, train_cfg), indent=2))
