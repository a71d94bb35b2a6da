"""The port resumes a train state that the JAX package saved: JAX trains a
tiny captioner two steps, saves it with Orbax and `consolidate`s it; the
port restores the `.npz` (train/checkpoints.restore_checkpoint) and both
go on for two more steps on the same batches. The restored state equals
JAX's at the save: parameters (in their stored dtypes) and Adam moments bit
for bit, the Adam count, AutoClip ring and step exactly. The two steps
after it, at the training tests' bounds: in f32, losses at rtol 1e-5 and
parameters at atol 1e-5. Under `bf16_compute` the forward itself sits a
few bf16 steps from XLA's (tests/test_torch_train_step.py), so there the
first step's loss is held at rtol 1e-5, both losses at rtol 5e-5, and
parameters within a quarter of the learning rate, under one Adam step
(measured: 1.21e-5 and 0.107 lr). The keys' bias in GPT-2's c_attn is
held within one step a step: no output depends on it, and Adam turns its
rounding-noise gradient into a step of either sign (measured 0.82 lr).

Cases: GPT-2 trained whole in f32; GPT-2 `prefix_only` under
`bf16_compute` (the frozen LM stored in bf16, no moments for it); GPT-J
trained whole; and cli.train.main --resume_from --device cpu on the
committed fixture tests/fixtures/jax_train_state/ (which this test
regenerates with JAX and holds against the committed files). Refusals: an
Orbax directory (read_params' message: consolidate it first), moments of
other parameters than the run trains, counts that disagree, and an
AutoClip ring of another length than the run keeps. chip_smoke
(h3) resumes the committed fixture on the card with the script's flags.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.train import checkpoints as JCK
from clipcap_tpu.train import train_step as JTS
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.cli import train as train_cli
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.data.npy_reader import write_npy_shard
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode
from clipcap_tpu_torch.train import checkpoints as TCK
from clipcap_tpu_torch.train import train_step as TTS

FIXTURE = Path(__file__).parent / "fixtures" / "jax_train_state"
_spec = importlib.util.spec_from_file_location(
    "generate_jax_train_state", Path(__file__).parent / "fixtures" / "generate_jax_train_state.py")
FX = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FX)

GPT2 = dict(vocab_size=64, n_positions=32, n_embd=16, n_layer=2, n_head=2)
GPTJ = dict(vocab_size=64, n_positions=32, n_embd=16, n_layer=2, n_head=2, rotary_dim=4)
MAPPER = dict(dim_clip=8, dim_embedding=16, prefix_length=4, clip_length=2, num_layers=1,
              num_heads=2)
# under bf16_compute, the losses after the resume and the parameters (in
# units of the learning rate) after two steps; measured 1.21e-5 and 0.107
BF16_LOSS_RTOL = 5e-5
BF16_PARAM_ATOL = 0.25
TRAIN = dict(optimizer_lr=1e-2, scheduler_warmup_steps=1, total_steps=10,
             gradient_clip_val=-1.0, autoclip_history=16, remat=False, weight_decay=0.01)
CASES = {"gpt2_f32": ("gpt2", dict(), dict(bf16_compute=False)),
         "gpt2_prefix_only_bf16": ("gpt2", dict(prefix_only=True), dict(bf16_compute=True)),
         "gptj_f32": ("gptj", dict(), dict(bf16_compute=False))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(n=4, b=4, t=8):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        tokens = rng.integers(1, 64, size=(b, t)).astype(np.int64)
        tokens[:, -2:] = -1
        out.append({"tokens": tokens,
                     "prefix": rng.normal(size=(b, MAPPER["dim_clip"])).astype(np.float32)})
    return out


def _jax_array(a):
    a = np.array(a)
    return jnp.asarray(a.view(jnp.bfloat16) if a.dtype.kind == "V" else a)


def _f32(leaf):
    leaf = np.asarray(leaf)
    if leaf.dtype.kind == "V" or leaf.dtype == jnp.bfloat16:
        return convert.to_torch(leaf.view(np.uint16).view(convert.BF16_RECORD)).float().numpy()
    return leaf.astype(np.float32)


def _assert_params(model, jparams, atol, key_bias_atol=None):
    """The port's parameters against JAX's. With `key_bias_atol`, the
    slice of GPT-2's c_attn bias that holds the keys' bias is held at that
    bound instead: no output depends on it (softmax is invariant to it), so
    its gradient is zero but for rounding, which Adam scales to a step."""
    ours = jax.tree_util.tree_leaves_with_path(convert.captioner_params(model))
    ref = jax.tree_util.tree_leaves(jax.device_get(jparams))
    assert len(ours) == len(ref)
    for (path, a), b in zip(ours, ref):
        if atol == 0:
            assert np.asarray(a).dtype.itemsize == np.asarray(b).dtype.itemsize
        a, b = _f32(a), _f32(b)
        if key_bias_atol is not None and jax.tree_util.keystr(path).endswith("['c_attn']['b']"):
            keys = slice(a.shape[-1] // 3, 2 * a.shape[-1] // 3)
            np.testing.assert_allclose(a[..., keys], b[..., keys], rtol=0, atol=key_bias_atol)
            a[..., keys] = b[..., keys]
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _hold_continuation(losses, jlosses, model, jparams, train_cfg):
    """The port's steps after the resume against JAX's, at the bounds of
    the module docstring."""
    if not train_cfg.bf16_compute:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        _assert_params(model, jparams, atol=1e-5)
        return
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=BF16_LOSS_RTOL)
    lr = train_cfg.optimizer_lr
    _assert_params(model, jparams, atol=BF16_PARAM_ATOL * lr, key_bias_atol=lr * len(losses))


def _assert_restored(state, jstate, cap_t, lm_t):
    """The state at the save: parameters (stored dtypes too) and Adam
    moments bit for bit, the Adam count, step and AutoClip ring exactly."""
    _assert_params(state.model, jstate.params, atol=0)
    adam = jstate.opt_state.inner_states["train"].inner_state[0]
    names = [n for n, keep in state.model.trainable_filter().items() if keep]
    for key in ("mu", "nu"):
        holder = Captioner(cap_t, lm_t, device="cpu", seed=2)
        with torch.no_grad():
            params = dict(holder.named_parameters())
            for name, m in zip(names, getattr(state.opt_state, key)):
                params[name].copy_(m)
        want = jax.device_get(getattr(adam, key))
        got = convert.captioner_params(holder)
        for part in want:
            for a, b in zip(jax.tree_util.tree_leaves(got[part]),
                            jax.tree_util.tree_leaves(want[part])):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        held = {part for part in want if jax.tree_util.tree_leaves(want[part])}
        assert held == ({"mapper"} if cap_t.prefix_only else {"mapper", "lm"})
    assert int(state.opt_state.count) == int(adam.count) == int(state.step) == int(jstate.step)
    for key in ("history", "count", "pos"):
        np.testing.assert_array_equal(getattr(state.autoclip, key).numpy(),
                                      np.asarray(getattr(jstate.autoclip, key)))


def _run_jax(jstep, jstate, batches):
    losses = []
    for batch in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return jstate, losses


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_from_jax_train_state_matches_jax(case, tmp_path):
    lm_type, cap_kw, train_kw = CASES[case]
    lm_t, lm_j = ((TC.GPT2Config(**GPT2), JC.GPT2Config(**GPT2)) if lm_type == "gpt2"
                  else (TC.GPTJConfig(**GPTJ), JC.GPTJConfig(**GPTJ)))
    cap_t = TC.CaptionerConfig(lm_type=lm_type, mapper=TC.MapperConfig(**MAPPER), **cap_kw)
    cap_j = JC.CaptionerConfig(lm_type=lm_type, mapper=JC.MapperConfig(**MAPPER), **cap_kw)
    tc_t, tc_j = TC.TrainConfig(**TRAIN, **train_kw), JC.TrainConfig(**TRAIN, **train_kw)
    batches = _batches()

    seeded = Captioner(cap_t, lm_t, device="cpu", seed=0)
    jparams = jax.tree_util.tree_map(_jax_array, convert.captioner_params(seeded))
    jstate, jtx = JTS.create_train_state(jax.random.PRNGKey(0), cap_j, lm_j, tc_j,
                                         params=jparams)
    jstep = JTS.make_train_step(cap_j, lm_j, tc_j, jtx, donate=False)
    jstate, _ = _run_jax(jstep, jstate, batches[:2])
    ckpt = tmp_path / "jax_state"
    JCK.save_checkpoint(str(ckpt), jstate, cap_j, lm_j, tc_j)

    template, tx = TTS.create_train_state(1, cap_t, lm_t, tc_t,
                                          model=Captioner(cap_t, lm_t, device="cpu", seed=1),
                                          device="cpu")
    if case == "gpt2_f32":  # an Orbax directory, not consolidated yet
        with pytest.raises(FileNotFoundError, match="consolidate"):
            TCK.restore_checkpoint(str(ckpt), template)
    JCK.consolidate(str(ckpt), str(ckpt / TCK.PARAMS_FILE))
    state = TCK.restore_checkpoint(str(ckpt), template)

    _assert_restored(state, jstate, cap_t, lm_t)

    # two more steps each
    jstate, jlosses = _run_jax(jstep, jstate, batches[2:])
    step = TTS.make_train_step(cap_t, lm_t, tc_t, tx)
    losses = []
    for batch in batches[2:]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    assert int(state.step) == int(jstate.step) == 4
    _hold_continuation(losses, jlosses, state.model, jstate.params, tc_t)


def _vocab(d: Path) -> Path:
    vocab = {t: i for i, t in enumerate(dict.fromkeys(list(bytes_to_unicode().values())
                                                     + ["<|endoftext|>"]))}
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return d


def test_committed_fixture_is_current_and_cli_resumes_it(tmp_path, monkeypatch):
    """The committed fixture equals a fresh JAX run of its script; the
    port's cli.train builds the fixture's configuration from CLI_ARGS,
    restores JAX's state as it was at the save, and takes the two steps
    JAX takes next."""
    jstate, jstep = FX.build(tmp_path / "fresh")
    with np.load(FIXTURE / TCK.PARAMS_FILE) as old, \
            np.load(tmp_path / "fresh" / TCK.PARAMS_FILE) as new:
        assert sorted(old.files) == sorted(new.files)
        for key in old.files:
            np.testing.assert_allclose(old[key], new[key], rtol=1e-6, atol=0, err_msg=key)
    for name in ("clipcap_config.json", "lm_config.json"):
        assert (FIXTURE / name).read_text() == (tmp_path / "fresh" / name).read_text()

    batches = FX.batches()
    shards = tmp_path / "shards"
    write_npy_shard(shards / "prefixes" / "0.npy", np.concatenate([b["prefix"] for b in batches]))
    write_npy_shard(shards / "tokens" / "0.npy", np.concatenate([b["tokens"] for b in batches]))
    out = tmp_path / "out"
    restored, restore_checkpoint = [], TCK.restore_checkpoint

    def restore(path, template):  # the CLI's resume, held before it trains
        state = restore_checkpoint(path, template)
        _assert_restored(state, jstate, *_fixture_configs())
        restored.append(path)
        return state

    monkeypatch.setattr(TCK, "restore_checkpoint", restore)
    res = train_cli.main(FX.CLI_ARGS + [
        "--resume_from", str(FIXTURE), "--prefix_data_path", str(shards),
        "--lm_config_json", str(FIXTURE / "lm_config.json"),
        "--tokenizer_vocab_dir", str(_vocab(tmp_path / "vocab")), "--output_dir", str(out),
        "--log_every_n_steps", "1", "--device", "cpu"])
    assert restored == [str(FIXTURE)]
    # the configuration the CLI ran and saved is the fixture's, but for the logging cadence
    saved, fixture = TCK.load_config(out / "demo_model_final"), TCK.load_config(FIXTURE)
    assert {**saved["train"], "log_every_n_steps": None} == \
        {**fixture["train"], "log_every_n_steps": None}
    assert saved["lm"] == fixture["lm"]
    jstate, jlosses = _run_jax(jstep, jstate, batches[FX.STEPS:])
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    losses = {r["step"]: r["loss"] for r in lines if "loss" in r}
    assert sorted(losses) == [3, 4] and int(res["state"].step) == int(jstate.step) == 4
    _hold_continuation([losses[3], losses[4]], jlosses, res["state"].model, jstate.params,
                       TC.TrainConfig(**FX.TRAIN))


def _fixture_configs(**cap_kw):
    """The port's captioner and LM configurations of the fixture."""
    cap = TC.CaptionerConfig(lm_type="gpt2", visual_encoder_type="none",
                             mapper=TC.MapperConfig(**FX.MAP_CFG), **cap_kw)
    return cap, TC.GPT2Config(**FX.LM_CFG)


def _fixture_template(train=FX.TRAIN, **cap_kw):
    """A port train state of the fixture's configuration."""
    cap, lm = _fixture_configs(**cap_kw)
    return TTS.create_train_state(0, cap, lm, TC.TrainConfig(**train),
                                  model=Captioner(cap, lm, device="cpu"), device="cpu")[0]


def test_chip_smoke_resumes_the_fixture_with_its_flags():
    """chip_smoke.py (h3) resumes the committed fixture on the card, where
    the script cannot be imported (JAX): its copy of the flags is the
    script's."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.JAX_STATE_ARGS == FX.CLI_ARGS and smoke.JAX_STATE == FIXTURE.resolve()


def test_jax_state_refusals(tmp_path):
    # moments of the LM, which a prefix_only run does not train
    with pytest.raises(KeyError, match="cover other parameters than this run trains"):
        TCK.restore_checkpoint(str(FIXTURE), _fixture_template(prefix_only=True))
    # an Adam count that is not the step
    bad = tmp_path / "bad"
    bad.mkdir()
    shutil.copy(FIXTURE / "clipcap_config.json", bad)
    with np.load(FIXTURE / TCK.PARAMS_FILE) as data:
        flat = {k: data[k] for k in data.files}
    flat["step"] = np.asarray(3, np.int32)
    np.savez(bad / TCK.PARAMS_FILE, **flat)
    with pytest.raises(ValueError, match="counts disagree"):
        TCK.restore_checkpoint(str(bad), _fixture_template())
    # a run that keeps a shorter AutoClip ring than the state's
    with pytest.raises(ValueError, match="AutoClip ring holds 50000 gradient norms where this "
                                         "run keeps 16"):
        TCK.restore_checkpoint(str(FIXTURE), _fixture_template({**FX.TRAIN,
                                                                "autoclip_history": 16}))
    # the fixture itself resumes at its step
    assert int(TCK.restore_checkpoint(str(FIXTURE), _fixture_template()).step) == FX.STEPS
