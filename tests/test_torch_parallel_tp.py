"""Tensor-parallel GPT-J decode (parallel/tp.py, GPTJ.shard_heads) over a
model axis of 1, 2 and 4 gloo processes, and data x model = 2 x 2, against
the unsharded port and JAX on the same weights. Tolerances: f32 logits
1e-5 relative; greedy and sampled tokens (generate, and the serving
engine's ring decode) exact. The layout: rank r's shard of every weight
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
    """{(data, model): [each rank's results]}, and the unsharded port's
    results under None."""
    out = tmp_path_factory.mktemp("tp")
    got = {None: W.tp_cases(GPTJ(TC.GPTJConfig(**W.GPTJ_TP), device="cpu", seed=0))}
    for world in (1, 2, 4):
        run_spawned(W.tp_worker, world, (str(out),), timeout=60, workdir=out)
    for data, model in LAYOUTS:
        got[(data, model)] = [W.load(out, f"tp_{data}x{model}", data * model, r)
                              for r in range(data * model)]
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
