"""Training on a mesh (train/train_step.py, parallel/sharding.py,
parallel/pp.py) in 1, 2 and 4 gloo processes, against the one-process
port and JAX's make_train_step on the same weights. Tolerances, over 3
steps through a warmup of 2: losses at 1e-5 relative, parameters at 1e-5
absolute, for data parallelism, ZeRO (also with gradient accumulation and
prefix-only training over a frozen int8 GPT-J), the GPipe pipeline over
`pipe` and, at 4 ranks, data x pipe = 2 x 2. The pipelined forward's
logits and gradients equal GPT2.forward's at 1e-5. The ZeRO layout: rank
r's shard of each master (and of its Adam moments) equals, in JAX's
layout, the shard `jax.device_put(params, param_shardings(params, mesh,
zero=True))` places on device r. A ZeRO checkpoint equals the plain run's
and loads into the plain trainer; a JAX TrainState consolidated by JAX
restores into ZeRO shards as the chunks of a plain restore. The refusals: layers not divisible by
`pipe`, a batch not divisible by n_micro, and cli.train asked for more
ranks than exist (JAX's ValueError).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from clipcap_tpu.core import config as JC
from clipcap_tpu.core.mesh import MeshSpec as JMeshSpec
from clipcap_tpu.core.mesh import make_mesh as jmake_mesh
from clipcap_tpu.parallel.sharding import param_shardings as jparam_shardings
from clipcap_tpu.train import checkpoints as JCK
from clipcap_tpu.train import train_step as JTS
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.tools.dryrun_multichip import run_spawned
from clipcap_tpu_torch.train import checkpoints
from clipcap_tpu_torch.train.train_step import create_train_state

WORLDS = [1, 2, 4]
CASES = {"dp": {}, "zero": {}, "zero_acc": dict(accumulate=2),
         "int8_prefix": dict(int8_prefix=True), "pp": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The parent's one-process runs on one thread, beside the suite's
    other workers and the spawned ranks (each on one thread too)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_state(path) -> str:
    """A JAX TrainState of the GPT2_TRAIN captioner (the port's seed-0
    weights) with seeded Adam moments at step 3, saved by JAX and written
    out by its consolidate: the directory the ranks resume from."""
    cap = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**W.MAPPER_TRAIN))
    lm = JC.GPT2Config(**W.GPT2_TRAIN)
    model = Captioner(TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**W.MAPPER_TRAIN)),
                      TC.GPT2Config(**W.GPT2_TRAIN), device="cpu", seed=0)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)),
                                    convert.captioner_params(model))
    state, _ = JTS.create_train_state(jax.random.PRNGKey(0), cap, lm, JC.TrainConfig(**W.TRAIN),
                                      params=params)
    rng = np.random.default_rng(9)
    train = state.opt_state.inner_states["train"]
    adam, rest, sched = train.inner_state
    draw = lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32))  # noqa: E731
    adam = adam._replace(count=jnp.int32(3), mu=jax.tree_util.tree_map(draw, adam.mu),
                         nu=jax.tree_util.tree_map(lambda a: jnp.abs(draw(a)), adam.nu))
    inner = dict(state.opt_state.inner_states,
                 train=train._replace(inner_state=(adam, rest, sched._replace(count=jnp.int32(3)))))
    state = state._replace(opt_state=state.opt_state._replace(inner_states=inner),
                           step=jnp.int32(3))
    JCK.save_checkpoint(str(path), state, cap, lm, JC.TrainConfig(**W.TRAIN))
    JCK.consolidate(str(path), str(path / checkpoints.PARAMS_FILE))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    jax_state = _jax_state(out / "jax_state")
    got = {None: {name: W.train_run(**kw) for name, kw in CASES.items()}, "out": out,
           "jax_state": jax_state}
    for world in WORLDS:
        run_spawned(W.train_worker, world, (str(out), jax_state), timeout=120, workdir=out)
        got[world] = [W.load(out, "train", world, r) for r in range(world)]
    return got


def _close(got: dict, want: dict):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["params"].keys() == want["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.float().numpy(), want["params"][name].float().numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_training_equals_one_process(runs, world, case):
    for rank_res in runs[world]:
        _close(rank_res[case], runs[None][case])


@pytest.mark.parametrize("world", WORLDS)
def test_traced_fit_spans_each_step_and_equals_the_step_loop(runs, world):
    """trainer.fit under a tracer: each step a `train.step` holding its
    `train.data` and the step's `train.grad_sync`, and the same parameters
    as the untraced step loop."""
    want = [("train.step", None), ("train.data", "train.step"),
            ("train.grad_sync", "train.step")] * W.TRAIN_STEPS
    for rank_res in runs[world]:
        assert rank_res["fit"]["spans"] == want
        _close(dict(rank_res["fit"], losses=[]), dict(runs[None]["dp"], losses=[]))


def test_data_and_pipe_2x2_equals_one_process(runs):
    for rank_res in runs[4]:
        _close(rank_res["dp_pp"], runs[None]["pp"])


def test_dp_losses_equal_jax(runs):
    lm_t, cap_t = TC.GPT2Config(**W.GPT2_TRAIN), TC.CaptionerConfig(
        lm_type="gpt2", mapper=TC.MapperConfig(**W.MAPPER_TRAIN))
    lm_j, cap_j = JC.GPT2Config(**W.GPT2_TRAIN), JC.CaptionerConfig(
        lm_type="gpt2", mapper=JC.MapperConfig(**W.MAPPER_TRAIN))
    model = Captioner(cap_t, lm_t, device="cpu", seed=0)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)),
                                    convert.captioner_params(model))
    train_cfg = JC.TrainConfig(**W.TRAIN)
    state, tx = JTS.create_train_state(jax.random.PRNGKey(0), cap_j, lm_j, train_cfg,
                                       params=params)
    step = JTS.make_train_step(cap_j, lm_j, train_cfg, tx, donate=False)
    losses = []
    for batch in W.train_batches():
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    for world in WORLDS:
        np.testing.assert_allclose(runs[world][0]["dp"]["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(runs[world][0]["zero"]["losses"], losses, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["pp_forward", "dp_pp_forward"])
def test_pipelined_forward_equals_gpt2(runs, world, case):
    """Logits and gradients of the pipelined forward on each rank's rows.
    A rank's loss is the mean over its own rows, so its gradients are the
    one-process gradients of those rows times the data axis; a stage holds
    the gradients of its own blocks (zero for the others), and the
    replicated parameters' whole, on every stage."""
    if case == "dp_pp_forward" and world != 4:
        assert case not in runs[world][0]
        return
    data = 2 if case == "dp_pp_forward" else 1
    pipe, per_data, per_stage = world // data, 8 // data, W.GPT2_TRAIN["n_layer"] * data // world
    lm = GPT2(TC.GPT2Config(**W.GPT2_TRAIN), device="cpu", seed=2)
    embeds, mask = (torch.from_numpy(x) for x in W.pp_inputs())
    embeds.requires_grad_(True)
    logits = lm(embeds, mask)
    names = ["embeds"] + [n for n, _ in lm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(logits.square().mean(),
                                                [embeds] + list(lm.parameters()))))
    sliced = lm(embeds.detach(), logits_slice=(3, 9)).detach()
    for r, rank_res in enumerate(runs[world]):
        got = rank_res[case]
        rows = slice((r // pipe) * per_data, (r // pipe + 1) * per_data)
        np.testing.assert_allclose(got["logits"].numpy(), logits[rows].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["sliced"].numpy(), sliced[rows].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["grads"]["embeds"].numpy(),
                                   grads["embeds"][rows].numpy() * data, rtol=1e-4, atol=1e-8)
        if data > 1:
            continue  # the parameters' gradients are this rank's rows' part
        stage = r % pipe
        for name in names[1:]:
            parts = name.split(".")
            mine = parts[0] != "blocks" or int(parts[1]) // per_stage == stage
            want = grads[name].numpy() if mine else np.zeros_like(grads[name].numpy())
            np.testing.assert_allclose(got["grads"][name].numpy(), want, rtol=1e-4, atol=1e-8,
                                       err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_zero_shards_are_jax_device_shards(runs, world):
    lm = TC.GPT2Config(**W.GPT2_TRAIN)
    cap = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**W.MAPPER_TRAIN))
    tree = convert.captioner_params(Captioner(cap, lm, device="cpu", seed=0))
    mesh = jmake_mesh(JMeshSpec(data=world), devices=jax.devices()[:world])
    placed = jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree),
                            jparam_shardings(tree, mesh, zero=True))
    start = dict(Captioner(cap, lm, device="cpu", seed=0).named_parameters())
    sharded = 0
    for r, rank_res in enumerate(runs[world]):
        zero = rank_res["zero"]
        device = mesh.devices.reshape(-1)[r]
        for name, axis in zero["zero_axes"].items():
            path, layer, transposed = _captioner_path(name)
            leaf = placed
            for key in path:
                leaf = leaf[key]
            shard = next(np.asarray(s.data) for s in leaf.addressable_shards
                         if s.device == device)
            if layer is not None:
                shard = shard[layer]
            shard = shard.T if transposed else shard
            if axis is None:  # replicated in JAX too: device r holds all of it
                assert shard.shape == tuple(zero["params"][name].shape), name
                continue
            sharded += 1
            # JAX's shard of the starting weights, beside the port's masters
            # after 3 steps: the same slice of the same tensor
            want = start[name].detach().chunk(world, dim=axis)[r].numpy()
            np.testing.assert_array_equal(shard, want, err_msg=name)
            assert zero["zero_masters"][name].shape == shard.shape
            assert zero["zero_mu"][name].shape == shard.shape
            full = zero["params"][name].chunk(world, dim=axis)[r]
            assert torch.equal(zero["zero_masters"][name], full), name
            assert torch.equal(rank_res["shard_params"][name], start[name].detach().chunk(
                world, dim=axis)[r]), name  # shard_params: the same slice of every tensor
    # wte, every block's c_attn, c_proj, c_fc and mlp_proj, the mapper's fc1 and fc2
    assert sharded == 19 * world


def _captioner_path(name: str):
    """The JAX leaf, layer and transpose of a GPT-2 captioner parameter."""
    parts = name.split(".")
    lin = {"wq": ("attn", "wq"), "wkv": ("attn", "wkv"), "wo": ("attn", "wo"),
           "fc1": ("mlp", "w1"), "fc2": ("mlp", "w2"), "c_attn": ("attn", "c_attn"),
           "c_proj": ("attn", "c_proj"), "c_fc": ("mlp", "c_fc"), "mlp_proj": ("mlp", "c_proj")}
    ln = {"weight": "g", "bias": "b"}
    if parts[0] == "mapper":
        if parts[1] == "linear":
            return ("mapper", "linear", "w" if parts[2] == "weight" else "b"), None, \
                parts[2] == "weight"
        if parts[1] == "prefix_const":
            return ("mapper", "prefix_const"), None, False
        layer, mod, leaf = int(parts[2]), parts[3], parts[4]
        if mod in ("ln1", "ln2"):
            return ("mapper", "layers", mod, ln[leaf]), layer, False
        group, key = lin[mod]
        if leaf == "bias":
            key = {"wo": "bo", "w1": "b1", "w2": "b2"}[key]
        return ("mapper", "layers", group, key), layer, leaf == "weight"
    if parts[1] in ("wte", "wpe"):
        return ("lm", parts[1]), None, False
    if parts[1] == "ln_f":
        return ("lm", "ln_f", ln[parts[2]]), None, False
    layer, mod, leaf = int(parts[2]), parts[3], parts[4]
    if mod in ("ln1", "ln2"):
        return ("lm", "blocks", mod, ln[leaf]), layer, False
    group, key = lin[mod]
    return ("lm", "blocks", group, key, "w" if leaf == "weight" else "b"), layer, \
        leaf == "weight"


@pytest.mark.parametrize("world", WORLDS)
def test_zero_checkpoint_is_the_plain_one_and_resumes_plain(runs, world, tmp_path):
    plain = tmp_path / "plain"
    out = runs["out"]
    zero_dir = out / f"zero_ckpt_w{world}"
    W.train_run(ckpt=str(plain))
    with np.load(zero_dir / checkpoints.PARAMS_FILE) as z, \
            np.load(plain / checkpoints.PARAMS_FILE) as p:
        assert sorted(z.files) == sorted(p.files)
        for key in p.files:
            np.testing.assert_allclose(z[key].astype(np.float64), p[key].astype(np.float64),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    lm = TC.GPT2Config(**W.GPT2_TRAIN)
    cap = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**W.MAPPER_TRAIN))
    template, _ = create_train_state(1, cap, lm, TC.TrainConfig(**W.TRAIN),
                                     model=Captioner(cap, lm, device="cpu", seed=1),
                                     device="cpu")
    state = checkpoints.restore_checkpoint(str(zero_dir), template)
    assert int(state.step) == W.TRAIN_STEPS
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), runs[world][0]["zero"]["params"][name]
                                   .numpy(), rtol=0, atol=0, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_zero_state_resumes_a_jax_train_state(runs, world):
    """A JAX TrainState's .npz restored into ZeRO shards: each rank holds
    its chunk of what a plain restore holds, masters and moments."""
    lm = TC.GPT2Config(**W.GPT2_TRAIN)
    cap = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**W.MAPPER_TRAIN))
    template, _ = create_train_state(1, cap, lm, TC.TrainConfig(**W.TRAIN),
                                     model=Captioner(cap, lm, device="cpu", seed=1),
                                     device="cpu")
    plain = checkpoints.restore_checkpoint(runs["jax_state"], template)
    params = dict(plain.model.named_parameters())
    names = [n for n, keep in plain.model.trainable_filter().items() if keep]
    want = {"masters": [params[n].detach() for n in names], "mu": plain.opt_state.mu,
            "nu": plain.opt_state.nu}
    for r, rank_res in enumerate(runs[world]):
        got = rank_res["jax_resume"]
        assert got["step"] == 3 and sorted(got["axes"]) == sorted(names)
        assert any(a is not None for a in got["axes"].values()) or world == 1
        for key, tensors in want.items():
            for name, t in zip(names, tensors):
                axis = got["axes"][name]
                part = t if axis is None else t.chunk(world, dim=axis)[r]
                assert torch.equal(got[key][name], part), (key, name, r)


@pytest.mark.parametrize("world", WORLDS)
def test_pp_param_shardings_chunk_the_blocks(runs, world):
    """Stage s holds blocks [s L/S, (s+1) L/S), as P("pipe") chunks JAX's
    stacked [L] axis; the embeddings and ln_f are replicated."""
    got = runs[world][0]["pp_shardings"]
    per = W.GPT2_TRAIN["n_layer"] // world
    for name, stage in got.items():
        parts = name.split(".")
        assert stage == (int(parts[1]) // per if parts[0] == "blocks" else None), name
    assert {got[f"blocks.{i}.c_fc.weight"] for i in range(4)} == set(range(world))


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_refusals(runs, world):
    assert "not divisible by pipe" in runs[world][0]["bad_layers"]
    assert "not divisible by n_micro=3" in runs[world][0]["bad_micro"]


@pytest.mark.parametrize("extra", [["--mesh_data", "2"], ["--mesh_model", "2"],
                                   ["--zero_shard_params", "--mesh_data", "4"]])
def test_train_cli_refuses_more_ranks_than_exist(extra):
    from clipcap_tpu_torch.cli import train as train_cli

    args = train_cli.build_argparser().parse_args(
        ["--prefix_data_path", "x", "--tokenizer_vocab_dir", "x", "--batch_size", "8",
         "--device", "cpu"] + extra)
    with pytest.raises(ValueError, match="needs . devices, have 1"):
        train_cli._make_mesh(args)
