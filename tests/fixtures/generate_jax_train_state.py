"""Regenerate tests/fixtures/jax_train_state/: a tiny train state saved by
the JAX package, for the port's resume from it (cli.train --resume_from).

JAX's create_train_state on a tiny GPT-2 captioner, two steps of its
make_train_step on seeded batches, save_checkpoint (an Orbax directory),
then `consolidate` into `consolidated.npz`, beside the checkpoint's
`clipcap_config.json`. The configuration is the one the port's cli.train
builds from CLI_ARGS (bf16 compute, as the CLI always runs, and its
AutoClip ring of 50,000 norms, two of them filled). The batches are the
first two of `batches()`; a run that resumes through the CLI reads shards
whose rows are those batches' in order, and skips the two it consumed.

tests/test_torch_resume_jax.py regenerates the state and holds the
committed files against it; chip_smoke.py resumes from the committed ones
on the card, where JAX is not installed.

Run from the repo root:  python tests/fixtures/generate_jax_train_state.py
"""

import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the repo root

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # deterministic, env-independent

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from clipcap_tpu.core.config import (CaptionerConfig, GPT2Config, MapperConfig,  # noqa: E402
                                     TrainConfig)
from clipcap_tpu.train import checkpoints as JCK  # noqa: E402
from clipcap_tpu.train import train_step as JTS  # noqa: E402

OUT = Path(__file__).parent / "jax_train_state"

LM_CFG = dict(vocab_size=64, n_positions=32, n_embd=8, n_layer=1, n_head=2)
MAP_CFG = dict(dim_clip=8, dim_embedding=8, prefix_length=4, clip_length=2, num_layers=1,
               num_heads=2)
# the port's cli.train defaults where CLI_ARGS sets nothing: weight decay
# 0.01 (its --weight_decay), AutoClip's ring of 50,000 (TrainConfig's)
TRAIN = dict(batch_size=4, epochs=1, optimizer_lr=1e-2, weight_decay=0.01,
             scheduler_warmup_steps=1, total_steps=4, bf16_compute=True, remat=True)
STEPS = 2  # taken before the save
BATCHES = 4  # in the shards a resumed run reads: two consumed, two to go
TOKENS = 9  # per row, the last two -1 (padding)

# the port's cli.train flags that build this configuration, beside
# `--prefix_data_path` (shards of batches()' rows) and `--lm_config_json
# jax_train_state/lm_config.json`
CLI_ARGS = ["--prefix_size", "8", "--prefix_length", "4", "--clip_prefix_length", "2",
            "--num_layers", "1", "--num_attention_heads", "2", "--batch_size", "4",
            "--epochs", "1", "--max_steps", "4", "--optimizer_lr", "1e-2",
            "--scheduler_warmup_steps", "1"]


def configs():
    cap = CaptionerConfig(lm_type="gpt2", visual_encoder_type="none",
                          mapper=MapperConfig(**MAP_CFG))
    return cap, GPT2Config(**LM_CFG), TrainConfig(**TRAIN)


def batches():
    """BATCHES seeded batches {"tokens": int64 [4, 9], "prefix": f32 [4, 8]}."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(BATCHES):
        tokens = rng.integers(1, LM_CFG["vocab_size"], size=(TRAIN["batch_size"], TOKENS))
        tokens[:, -2:] = -1
        out.append({"tokens": tokens.astype(np.int64),
                    "prefix": rng.normal(size=(TRAIN["batch_size"], MAP_CFG["dim_clip"]))
                    .astype(np.float32)})
    return out


def build(out_dir: Path = OUT):
    """Train STEPS steps and write the consolidated state to out_dir;
    returns (the JAX state, its jitted step) so a caller can go on."""
    cap, lm, train = configs()
    state, tx = JTS.create_train_state(jax.random.PRNGKey(0), cap, lm, train)
    step = JTS.make_train_step(cap, lm, train, tx, donate=False)
    for batch in batches()[:STEPS]:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "state"
        JCK.save_checkpoint(str(ckpt), state, cap, lm, train)
        JCK.consolidate(str(ckpt), str(out_dir / "consolidated.npz"))
        shutil.copy(ckpt / "clipcap_config.json", out_dir / "clipcap_config.json")
    (out_dir / "lm_config.json").write_text(lm.to_json())
    return state, step


if __name__ == "__main__":
    build()
    print(f"wrote {OUT}")
