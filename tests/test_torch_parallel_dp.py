"""Data-parallel decode and serving (parallel/dp.py and the cache_constraint
hook of generate, beam search and ServingEngine) in 1, 2 and 4 gloo
processes, against the one-process port and JAX's engine on the same
weights. Tolerances: every token exact (greedy, injected noise, int8,
beam, serving), and sampled decoding with the seeded generator exact at
every world size (the sampler keys its randomness by the global row);
K2/K3's plain versions with row_base equal the full batch's rows exactly
(alt_prob to 1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import GenerationSettings as JSettings
from clipcap_tpu.decode import generate as jgenerate
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.tools.dryrun_multichip import run_spawned

WORLDS = [1, 2, 4]
CASES = ["greedy", "int8", "sampled", "injected", "beam", "k2", "k3", "serve", "serve_sampled"]


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
    """{world: rank 0's results}, and the one-process port's under None."""
    out = tmp_path_factory.mktemp("dp")
    got = {None: W.dp_cases()}
    for world in WORLDS:
        run_spawned(W.dp_worker, world, (str(out),), timeout=60, workdir=out)
        got[world] = W.load(out, "dp", world)
    return got


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_dp_equals_one_process(runs, world, case):
    _same(runs[world][case], runs[None][case])


@pytest.mark.parametrize("world", WORLDS)
def test_dp_greedy_equals_jax(runs, world):
    lm = GPT2(TC.GPT2Config(**W.GPT2_DP), device="cpu", seed=0)
    sd = {k: convert.to_numpy(v) for k, v in lm.state_dict().items()}
    params = jax.tree_util.tree_map(jnp.asarray, convert.gpt2_params(sd, W.GPT2_DP["n_layer"]))
    prefix = W.dp_inputs()[0].numpy()
    want = jgenerate(JG, params, JC.GPT2Config(**W.GPT2_DP), jnp.asarray(prefix),
                     JSettings(max_new_tokens=10, greedy=True))
    np.testing.assert_array_equal(runs[world]["greedy"]["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


@pytest.mark.parametrize("world", WORLDS)
def test_bundle_data_parallel_composes_with_int8(runs, world):
    assert runs[world]["bundle_data"] == world
    assert runs[world]["bundle_layout"] == "dp"
    assert "already enabled" in runs[world]["second_enable"]
    assert "GPT-J" in runs[world]["tp_enable"]  # GPT-2's 25 heads do not split


def test_sampled_decode_does_not_depend_on_world_size(runs):
    """Seeded sampled decode at 2 and 4 ranks equals 1 rank, token for token."""
    one = runs[1]["sampled"]["tokens"]
    assert torch.equal(runs[2]["sampled"]["tokens"], one)
    assert torch.equal(runs[4]["sampled"]["tokens"], one)
