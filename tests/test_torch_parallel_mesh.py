"""The port's mesh (core/mesh.py) and its refusals, the sharding rules
that need no process group, and the whole parallel drive:
`python -m clipcap_tpu_torch.tools.dryrun_multichip --device cpu --world 8`
on a (data, pipe, model) = (2, 2, 2) mesh, as MULTICHIP_r05.json ran the
JAX drive, prints its OK line with all six paths `ok`. A mesh that does
not take exactly the world raises JAX's ValueError before any process
group is joined; so do an indivisible batch and a mesh with no `data`
axis for data-parallel decode.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from clipcap_tpu.core.mesh import MeshSpec as JMeshSpec
from clipcap_tpu.parallel.sharding import _zero_spec as jzero_spec
from clipcap_tpu_torch.core import mesh as M
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.parallel import dp, sharding

ROOT = Path(__file__).resolve().parents[1]
OK_PATHS = ["pp_train=ok", "tp_decode=ok", "dp_int8_decode=ok", "dp_serving=ok",
            "sp_encode=ok", "ep_moe=ok"]


def test_dryrun_multichip_on_8_gloo_ranks():
    out = subprocess.run([sys.executable, "-m", "clipcap_tpu_torch.tools.dryrun_multichip",
                          "--device", "cpu", "--world", "8", "--timeout", "150"],
                         capture_output=True, text=True, cwd=ROOT, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("dryrun_multichip OK")]
    assert len(line) == 1, out.stdout
    assert "mesh=({'data': 2, 'pipe': 2, 'model': 2})" in line[0]
    for path in OK_PATHS:
        assert path in line[0], line[0]


def test_mesh_spec_matches_jax():
    spec = M.MeshSpec(data=2, pipe=2, model=2)
    assert spec.axis_names == JMeshSpec(data=2, pipe=2, model=2).axis_names
    assert (M.DATA_AXIS, M.PIPE_AXIS, M.MODEL_AXIS) == ("data", "pipe", "model")


@pytest.mark.parametrize("spec,world", [(M.MeshSpec(data=2), 1), (M.MeshSpec(model=4), 2),
                                        (M.MeshSpec(data=2, pipe=2, model=2), 4)])
def test_mesh_must_take_the_whole_world(spec, world):
    need = spec.data * spec.pipe * spec.model
    with pytest.raises(ValueError, match=f"needs {need} devices, have {world}"):
        M.check_mesh(spec, world)


def test_make_mesh_refuses_before_joining_a_group():
    joined = torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        M.make_mesh(M.MeshSpec(data=2), device_type="cpu")
    assert torch.distributed.is_initialized() == joined


@pytest.mark.parametrize("n,shards,index,want", [(8, 1, 0, (0, 8)), (8, 2, 1, (4, 8)),
                                                 (12, 4, 2, (6, 9))])
def test_shard_rows_are_named_sharding_blocks(n, shards, index, want):
    assert M.shard_rows(n, shards, index) == want


def test_indivisible_batch_is_refused():
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 shards"):
        M.shard_rows(6, 4, 0)


def test_dp_decode_needs_a_data_axis():
    with pytest.raises(ValueError, match="has no 'data' axis"):
        dp.dp_decode_shardings(SimpleNamespace(mesh_dim_names=("model",)))


def test_dp_layout_behind_other_hooks_is_none():
    assert dp.layout_of(None) is None
    assert dp.layout_of(lambda cache: cache) is None


@pytest.mark.parametrize("shape", [(4, 64, 256), (1024, 64), (50257, 768), (12, 768, 2304),
                                   (3, 5), (4, 16, 16)])
@pytest.mark.parametrize("data", [1, 2, 4, 8])
def test_zero_spec_is_jax_s(shape, data):
    assert sharding._zero_spec(shape, data, 2**10) == tuple(jzero_spec(shape, data, 2**10))


def test_batch_shardings_put_the_batch_axis_on_data():
    specs = sharding.batch_shardings(None, {"tokens": np.zeros((8, 5)), "prefix": np.zeros((8,))})
    assert specs == {"tokens": ("data", None), "prefix": ("data",)}


def test_jax_layout_stacks_layers_and_transposes_linears():
    cap = TC.CaptionerConfig(lm_type="gpt2", mapper=TC.MapperConfig(**W.MAPPER_TRAIN))
    layout = sharding.jax_layout(Captioner(cap, TC.GPT2Config(**W.GPT2_TRAIN), device="cpu"))
    assert layout["lm.blocks.2.c_fc.weight"] == ((4, 128, 512), True, True)
    assert layout["lm.blocks.0.ln1.weight"] == ((4, 128), True, False)
    assert layout["lm.wte"] == ((512, 128), False, False)
    assert layout["mapper.linear.weight"] == ((16, 512), False, True)
    assert layout["mapper.layers.0.wkv.weight"] == ((1, 128, 256), True, True)
