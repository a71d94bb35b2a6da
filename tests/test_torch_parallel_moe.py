"""The MoE mapper (models/moe.py) against JAX's moe.apply on the same
weights (convert.moe_mapper_from_jax), and expert parallelism
(parallel/ep.py) over a model axis of 1, 2 and 4 gloo processes, with the
expert banks sharded and replicated. Tolerances: outputs and the aux loss
1e-5; the gradients of sum(out^2) + 0.01 aux against the one-process
port's at 1e-5. Overflow beyond capacity drops from the MoE branch as
tests/test_ep.py checks it, and identical experts equal the dense mapper.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from clipcap_tpu.core import config as JC
from clipcap_tpu.models import moe as JM
from clipcap_tpu.ops.activations import parse_act_fn as jparse_act_fn
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models import moe
from clipcap_tpu_torch.models.mapper import Mapper
from clipcap_tpu_torch.ops.activations import parse_act_fn
from clipcap_tpu_torch.parallel import ep
from clipcap_tpu_torch.tools.dryrun_multichip import run_spawned

WORLDS = [1, 2, 4]


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
    out = tmp_path_factory.mktemp("moe")
    got = {None: W.moe_run(moe.init(TC.MapperConfig(**W.MOE_MAPPER), moe.MoEConfig(**W.MOE),
                                    device="cpu", seed=4))}
    for world in WORLDS:
        run_spawned(W.moe_worker, world, (str(out),), timeout=60, workdir=out)
        got[world] = [W.load(out, "moe", world, r) for r in range(world)]
    return got


def _jax_moe(seed: int, moe_kw: dict):
    params = JM.init(jax.random.PRNGKey(seed), JC.MapperConfig(**W.MOE_MAPPER),
                     JM.MoEConfig(**moe_kw))
    mapper = moe.init(TC.MapperConfig(**W.MOE_MAPPER), moe.MoEConfig(**moe_kw), device="cpu")
    convert.load(mapper, convert.moe_mapper_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, mapper


@pytest.mark.parametrize("n_top,cf", [(1, 1.25), (2, 1.25), (2, 0.5)])
def test_moe_mapper_matches_jax(n_top, cf):
    moe_kw = dict(n_experts=8, n_top=n_top, capacity_factor=cf)
    params, mapper = _jax_moe(2, moe_kw)
    prefix = W.moe_prefix()
    want, want_aux = JM.apply(params, jnp.asarray(prefix.numpy()),
                              JC.MapperConfig(**W.MOE_MAPPER), JM.MoEConfig(**moe_kw))
    with torch.no_grad():
        got, aux = moe.apply(mapper, prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-5)


def test_identical_experts_match_dense_mapper():
    cfg = TC.MapperConfig(**W.MOE_MAPPER)
    dense = Mapper(cfg, device="cpu", seed=0)
    mapper = moe.init(cfg, moe.MoEConfig(n_experts=4, n_top=2, capacity_factor=8.0),
                      device="cpu", seed=0)
    with torch.no_grad():
        for d, m in zip(dense.layers, mapper.layers):
            for name in ("ln1", "ln2", "wq", "wkv", "wo"):
                m.get_submodule(name).load_state_dict(d.get_submodule(name).state_dict())
            m.mlp.w1.copy_(d.fc1.weight.T[None].expand(4, -1, -1))
            m.mlp.b1.copy_(d.fc1.bias[None].expand(4, -1))
            m.mlp.w2.copy_(d.fc2.weight.T[None].expand(4, -1, -1))
            m.mlp.b2.copy_(d.fc2.bias[None].expand(4, -1))
        for name in ("linear", ):
            mapper.get_submodule(name).load_state_dict(dense.get_submodule(name).state_dict())
        mapper.prefix_const.copy_(dense.prefix_const)
        prefix = W.moe_prefix()
        got, aux = moe.apply(mapper, prefix)
        np.testing.assert_allclose(got.numpy(), dense(prefix).numpy(), rtol=1e-5, atol=1e-5)
    assert np.isfinite(float(aux)) and float(aux) > 0


def test_capacity_overflow_drops_from_moe_branch():
    """capacity_factor 0 -> the capacity clamps to 1: at most E * cap = 2
    token slots survive across both choices; every other row adds exactly
    0 (tests/test_ep.py's case, against JAX's rows too)."""
    moe_cfg = moe.MoEConfig(n_experts=2, n_top=2, capacity_factor=0.0)
    ffn = JM.moe_ffn_init(jax.random.PRNGKey(4), 8, 16, 2)
    x = jax.random.normal(jax.random.PRNGKey(5), (1, 8, 8))
    want, want_aux = JM.moe_ffn_apply(x, ffn, JM.MoEConfig(n_experts=2, n_top=2,
                                                           capacity_factor=0.0),
                                      jparse_act_fn("gelu"))
    port = moe.moe_ffn_init(8, 16, 2, device="cpu")
    with torch.no_grad():
        port.gate.copy_(torch.from_numpy(np.array(ffn["gate"]["w"])))
        for leaf in ("w1", "b1", "w2", "b2"):
            getattr(port, leaf).copy_(torch.from_numpy(np.array(ffn[leaf])))
        y, aux = moe.moe_ffn_apply(torch.from_numpy(np.array(x)), port, moe_cfg,
                                   parse_act_fn("gelu"))
    rows = y[0].abs().sum(dim=-1).numpy()
    assert np.isfinite(rows).all()
    assert (rows > 0).sum() <= 2 and (rows == 0).sum() >= 6
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_param_shardings_split_only_the_expert_banks():
    mapper = moe.init(TC.MapperConfig(**W.MOE_MAPPER), moe.MoEConfig(**W.MOE), device="cpu")
    specs = ep.moe_param_shardings(mapper, None)
    for name, p in mapper.named_parameters():
        leaf = name.split(".")[-1]
        banked = ".mlp." in name and leaf in ("w1", "b1", "w2", "b2")
        assert specs[name] == (("model",) + (None,) * (p.dim() - 1) if banked else ()), name
    assert sum(1 for s in specs.values() if s) == 4 * W.MOE_MAPPER["num_layers"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bank", ["sharded", "replicated"])
def test_expert_parallel_matches_one_process(runs, world, bank):
    want = runs[None]
    for r, rank_res in enumerate(runs[world]):
        got = rank_res[bank]
        np.testing.assert_allclose(got["out"].numpy(), want["out"].numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(got["aux"]), float(want["aux"]), rtol=1e-5)
        for name, g in got["grads"].items():
            full = want["grads"][name]
            if bank == "sharded" and name.split(".")[-1] in ("w1", "b1", "w2", "b2"):
                full = full.chunk(world)[r]  # this rank's experts
            np.testing.assert_allclose(g.numpy(), full.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
