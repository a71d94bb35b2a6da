"""Tensor-parallel GPT-J decode (parallel/tp.py, GPTJ.shard_heads) over a
model axis of 1, 2 and 4 gloo processes, and data x model = 2 x 2, against
the unsharded port and JAX on the same weights. Tolerances: f32 logits
1e-5 relative; greedy and sampled tokens (generate, and the serving
engine's ring decode) exact. In bf16 at model 2, with seeded nonzero
biases, against JAX's `enable_tensor_parallel(2)` layout over two virtual
CPU devices: logits within BF16_STEPS bf16 steps (2^-8) of their scale,
greedy tokens equal but where JAX's own top-2 gap is within that bound. The layout: rank r's shard of every weight
equals, transposed to [in, out], the shard that
`jax.device_put(params, gptj_decode_shardings(mesh, params).params)`
places on device r. The refusals: an unknown parameter, a rank mismatch,
tensor parallelism on GPT-2 and with int8 raise ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_parallel_workers as W
from clipcap_tpu.core import config as JC
from clipcap_tpu.core.mesh import MeshSpec as JMeshSpec
from clipcap_tpu.core.mesh import make_mesh as jmake_mesh
from clipcap_tpu.decode import GenerationSettings as JSettings
from clipcap_tpu.decode import generate as jgenerate
from clipcap_tpu.models import gptj as JGJ
from clipcap_tpu.parallel.tp import gptj_decode_shardings as jshardings
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.bundle import CaptionerBundle
from clipcap_tpu_torch.models.gptj import GPTJ
from clipcap_tpu_torch.parallel.tp import tp_axes
from clipcap_tpu_torch.tools.dryrun_multichip import run_spawned

LAYOUTS = [(1, 1), (1, 2), (1, 4), (2, 2)]  # (data, model)
BF16_STEP = 2.0 ** -8
BF16_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The parent's one-process runs on one thread, beside the suite's
    other workers and the spawned ranks (each on one thread too)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(data, model): [each rank's results]}, the unsharded port's results
    under None, and the bf16 model-2 run's under "bf16"."""
    out = tmp_path_factory.mktemp("tp")
    got = {None: W.tp_cases(GPTJ(TC.GPTJConfig(**W.GPTJ_TP), device="cpu", seed=0))}
    for world in (1, 2, 4):
        run_spawned(W.tp_worker, world, (str(out),), timeout=60, workdir=out)
    for data, model in LAYOUTS:
        got[(data, model)] = [W.load(out, f"tp_{data}x{model}", data * model, r)
                              for r in range(data * model)]
    got["bf16"] = [W.load(out, "tp_bf16_1x2", 2, r) for r in range(2)]
    return got


def _jax_params():
    lm = GPTJ(TC.GPTJConfig(**W.GPTJ_TP), device="cpu", seed=0)
    sd = {k: convert.to_numpy(v) for k, v in lm.state_dict().items()}
    return jax.tree_util.tree_map(jnp.asarray, convert.gptj_params(sd, W.GPTJ_TP["n_layer"]))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["logits", "prefill", "apply_prefill"])
def test_tp_logits_equal_unsharded(runs, layout, case):
    want = runs[None]["prefill" if case == "apply_prefill" else case].numpy()
    for rank_res in runs[layout]:
        np.testing.assert_allclose(rank_res[case].numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["greedy", "sampled", "serve"])
def test_tp_tokens_equal_unsharded(runs, layout, case):
    want = runs[None][case]
    for rank_res in runs[layout]:
        got = rank_res[case]
        if isinstance(want, dict):
            assert got == want
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_greedy_equals_jax(runs, layout):
    want = jgenerate(JGJ, _jax_params(), JC.GPTJConfig(**W.GPTJ_TP),
                     jnp.asarray(W.tp_inputs().numpy()), JSettings(max_new_tokens=10, greedy=True))
    np.testing.assert_array_equal(runs[layout][0]["greedy"].numpy(), np.asarray(want["tokens"]))


@pytest.fixture(scope="module")
def jax_bf16():
    """JAX's bf16 GPT-J laid out as `bundle.enable_tensor_parallel(2)` lays
    it: params device_put by gptj_decode_shardings over a (1, 2) mesh of
    virtual CPU devices, the cache constrained to it."""
    sd = {k: convert.to_numpy(v) for k, v in W.tp_bf16_model().state_dict().items()}
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.view(jnp.bfloat16)),
                                    convert.gptj_params(sd, W.GPTJ_TP["n_layer"]))
    mesh = jmake_mesh(JMeshSpec(data=1, model=2), devices=jax.devices()[:2])
    sh = jshardings(mesh, params)
    cfg = JC.GPTJConfig(**W.GPTJ_TP)
    prefix = jnp.asarray(W.tp_inputs().numpy()).astype(jnp.bfloat16)
    params = jax.device_put(params, sh.params)
    logits = jax.jit(JGJ.apply, static_argnums=1)(params, cfg, prefix)
    prefill = jax.jit(JGJ.prefill, static_argnums=1)(
        params, cfg, prefix, sh.constrain_cache(JGJ.init_cache(cfg, 4, 8, jnp.bfloat16)))[0]
    prefill = prefill[:, -1:]  # the port's prefill gives the last position's logits
    greedy = jgenerate(JGJ, params, cfg, prefix, JSettings(max_new_tokens=10, greedy=True),
                       cache_constraint=sh.constrain_cache)["tokens"]
    return dict(params=params, cfg=cfg, prefix=prefix, logits=logits, prefill=prefill,
                greedy=np.asarray(greedy))


@pytest.mark.parametrize("case", ["logits", "prefill"])
def test_tp_bf16_logits_match_jax_tensor_parallel(runs, jax_bf16, case):
    want = np.asarray(jax_bf16[case].astype(jnp.float32))
    tol = BF16_STEPS * BF16_STEP * float(np.abs(want).max())
    for rank_res in runs["bf16"]:
        got = rank_res[case].float().numpy()
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err <= tol, f"{case}: max abs err {err:.4g} > {BF16_STEPS} bf16 steps {tol:.4g}"


def _jax_gap(jax_bf16, row: int, tokens) -> tuple:
    """JAX's top-2 gap and logit scale at the step after `tokens` on row
    `row`, from its full bf16 forward over the prefix and those tokens."""
    params, cfg = jax_bf16["params"], jax_bf16["cfg"]
    embeds = jnp.take(params["wte"], jnp.asarray(tokens, jnp.int32), axis=0)
    x = jnp.concatenate([jax_bf16["prefix"][row], embeds])[None]
    lg = np.asarray(JGJ.apply(params, cfg, x)[0, -1].astype(jnp.float32))
    top2 = np.sort(lg)[-2:]
    return float(top2[1] - top2[0]), float(np.abs(lg).max())


def test_tp_bf16_greedy_matches_jax_tensor_parallel(runs, jax_bf16):
    want = jax_bf16["greedy"]
    for rank_res in runs["bf16"]:
        got = rank_res["greedy"].numpy()
        for row in range(len(want)):
            diff = np.flatnonzero(got[row] != want[row])
            if diff.size:
                s = int(diff[0])
                gap, scale = _jax_gap(jax_bf16, row, want[row, :s])
                assert gap <= BF16_STEPS * BF16_STEP * scale, (row, s, gap)


def _jax_path(name: str):
    """The JAX leaf, layer and transpose of a GPTJ parameter name."""
    parts = name.split(".")
    if parts[0] == "blocks":
        layer, mod, leaf = int(parts[1]), parts[2], parts[3]
        if mod == "ln1":
            return ("blocks", "ln1", "g" if leaf == "weight" else "b"), layer, False
        if mod in ("wq", "wk", "wv", "wo"):
            return ("blocks", "attn", mod), layer, True
        key = {"weight": "w_" + mod[2:], "bias": "b_" + mod[2:]}[leaf]
        return ("blocks", "mlp", key), layer, leaf == "weight"
    if parts[0] == "ln_f":
        return ("ln_f", "g" if parts[1] == "weight" else "b"), None, False
    if parts[0] == "lm_head":
        return ("lm_head", "w" if parts[1] == "weight" else "b"), None, parts[1] == "weight"
    return (parts[0],), None, False


@pytest.mark.parametrize("model", [1, 2, 4])
def test_tp_shards_are_jax_device_shards(runs, model):
    params = _jax_params()
    mesh = jmake_mesh(JMeshSpec(data=1, model=model), devices=jax.devices()[:model])
    placed = jax.device_put(params, jshardings(mesh, params).params)
    for r, rank_res in enumerate(runs[(1, model)]):
        device = mesh.devices.reshape(-1)[r]
        for name, shard in rank_res["shards"].items():
            path, layer, transposed = _jax_path(name)
            leaf = placed
            for key in path:
                leaf = leaf[key]
            want = next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == device)
            want = want[layer] if layer is not None else want
            np.testing.assert_array_equal(shard.numpy(), want.T if transposed else want,
                                          err_msg=name)


def test_tp_rules_refuse_unknown_and_misranked_parameters():
    lm = GPTJ(TC.GPTJConfig(**W.GPTJ_TP), device="cpu", seed=0)
    lm.blocks[0].extra = nn.Linear(4, 4)
    with pytest.raises(ValueError, match="blocks.0.extra.weight"):
        tp_axes(lm)
    lm = GPTJ(TC.GPTJConfig(**W.GPTJ_TP), device="cpu", seed=0)
    lm.blocks[1].w_in.bias = nn.Parameter(torch.zeros(2, 4))
    with pytest.raises(ValueError, match="rank mismatch for blocks.1.w_in.bias"):
        tp_axes(lm)


def test_tp_refused_on_gpt2_and_with_int8():
    mapper = TC.MapperConfig(dim_clip=16, dim_embedding=64, prefix_length=4, clip_length=2,
                             num_layers=1, num_heads=2)
    gpt2 = CaptionerBundle.create(TC.CaptionerConfig(lm_type="gpt2", mapper=mapper),
                                  TC.GPT2Config(vocab_size=64, n_positions=32, n_embd=64,
                                                n_layer=1, n_head=4), None, device="cpu")
    with pytest.raises(ValueError, match="GPT-J"):
        gpt2.enable_tensor_parallel(2)
    gptj = CaptionerBundle.create(TC.CaptionerConfig(lm_type="gptj", mapper=mapper),
                                  TC.GPTJConfig(**W.GPTJ_TP), None, device="cpu")
    gptj.enable_int8_decode()
    with pytest.raises(ValueError, match="mutually exclusive"):
        gptj.enable_tensor_parallel(2)
