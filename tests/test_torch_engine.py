"""The port's generate() against the JAX engine.

- tests/fixtures/golden_tokens.json: on the JAX `captioner.init(PRNGKey(0))`
  parameters converted to the port, `greedy` must match token for token,
  and `sampled_top_p` too when fed the per-step `jax.random.gumbel` draws
  that the JAX engine makes (engine.py:303, sampling.py:389);
- eos_logprob, min_length and max_length against JAX generate on a small
  case (eos_logprob at rtol 1e-5);
- on the CPU, "fused" and "fused_step" take the threshold path, as in the
  JAX engine, so their trajectories are identical to "threshold".
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode import engine as JE
from clipcap_tpu.models import captioner as JCAP
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.models.captioner import Captioner
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.ops.kernels import fused_sampler as FS

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "golden_tokens.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and torch's default pool (one thread per core) in each
    would oversubscribe the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_step_gumbel(seed: int, n: int, shape) -> np.ndarray:
    """The per-step draws of JAX generate: rng, key = split(rng); gumbel(key)."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(key, shape, dtype=jnp.float32)))
    return np.stack(out)


@pytest.fixture(scope="module")
def golden_world():
    lm_cfg = JC.GPT2Config(**GOLDEN["lm_cfg"])
    cap_cfg = JC.CaptionerConfig(lm_type="gpt2", mapper=JC.MapperConfig(**GOLDEN["map_cfg"]))
    params = JCAP.init(jax.random.PRNGKey(0), cap_cfg, lm_cfg)
    clip_embed = jax.random.normal(jax.random.PRNGKey(1), (GOLDEN["batch"], 512), jnp.float32)
    model = Captioner(TC.CaptionerConfig(mapper=TC.MapperConfig(**GOLDEN["map_cfg"])),
                      TC.GPT2Config(**GOLDEN["lm_cfg"]), device="cpu")
    convert.load(model, convert.captioner_state_dict(_tree(params)))
    with torch.no_grad():
        prefix = model.project_prefix(torch.from_numpy(np.array(clip_embed)))
    return model, prefix


def test_golden_greedy(golden_world):
    model, prefix = golden_world
    out = TE.generate(model.lm, prefix,
                      TE.GenerationSettings(max_new_tokens=GOLDEN["new_tokens"], greedy=True),
                      device="cpu")
    assert out["tokens"].tolist() == GOLDEN["greedy"]


def test_golden_sampled_top_p_with_jax_draws(golden_world):
    model, prefix = golden_world
    n, b = GOLDEN["new_tokens"], GOLDEN["batch"]
    noise = torch.from_numpy(_jax_step_gumbel(7, n, (b, GOLDEN["lm_cfg"]["vocab_size"])))
    out = TE.generate(model.lm, prefix,
                      TE.GenerationSettings(max_new_tokens=n, top_p=0.8, repetition_penalty=1.2),
                      gumbel_noise=noise, device="cpu")
    assert out["tokens"].tolist() == GOLDEN["sampled_top_p"]
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


LM = dict(vocab_size=97, n_positions=64, n_embd=64, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def small_world():
    params = JG.init(jax.random.PRNGKey(0), JC.GPT2Config(**LM))
    model = convert.load(GPT2(TC.GPT2Config(**LM), device="cpu"),
                         convert.gpt2_state_dict(_tree(params)))
    prefix = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, 5, 64)))
    return params, model, prefix


@pytest.mark.parametrize("kw", [
    dict(top_p=0.8, repetition_penalty=1.2, min_length=2, max_length=[10, 4, 6],
         eos_token_id=5),
    dict(top_k=8.0, temperature=0.7, min_length=2, max_length=10, eos_token_id=5,
         min_alternate_prob=0.05, force_eos_log_prob=-3.0),
    dict(top_p=[0.4, 0.6, 0.9], stop_token_id=7, max_stops=2, stop_on_special=(11,)),
])
def test_generate_matches_jax_with_jax_draws(kw, small_world):
    params, model, prefix = small_world
    n = 8
    jkw = {k: (jnp.asarray(v) if isinstance(v, list) else v) for k, v in kw.items()}
    want = JE.generate(JG, params, JC.GPT2Config(**LM), jnp.asarray(prefix),
                       JE.GenerationSettings(max_new_tokens=n, **jkw),
                       rng=jax.random.PRNGKey(2))
    noise = torch.from_numpy(_jax_step_gumbel(2, n, (3, LM["vocab_size"])))
    got = TE.generate(model, torch.from_numpy(prefix),
                      TE.GenerationSettings(max_new_tokens=n, **kw), gumbel_noise=noise,
                      device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    np.testing.assert_array_equal(got["stopped"].numpy(), np.asarray(want["stopped"]))
    if "eos_token_id" in kw:
        np.testing.assert_allclose(got["eos_logprob"].numpy(), np.asarray(want["eos_logprob"]),
                                   rtol=1e-5)
    else:
        assert "eos_logprob" not in got


@pytest.mark.parametrize("method", ["fused", "fused_step"])
def test_cpu_fused_methods_take_the_threshold_path(method, small_world):
    _, model, prefix = small_world
    kw = dict(max_new_tokens=8, top_p=0.8, repetition_penalty=1.2, min_length=2,
              max_length=10, eos_token_id=5)
    a = TE.generate(model, torch.from_numpy(prefix),
                    TE.GenerationSettings(filter_method=method, **kw), seed=3, device="cpu")
    b = TE.generate(model, torch.from_numpy(prefix),
                    TE.GenerationSettings(filter_method="threshold", **kw), seed=3,
                    device="cpu")
    assert a["tokens"].tolist() == b["tokens"].tolist()
    assert FS.LAUNCHES == {"fused_filter_sample": 0, "fused_step_sample": 0, "fused_filter": 0}


def test_generate_refuses_other_device_and_sort(small_world):
    """Another device than the prompt's, and a filter method that does not
    exist, are refused; "sort" itself runs (tests/test_torch_sort_filters.py
    holds it against JAX)."""
    _, model, prefix = small_world
    with pytest.raises(ValueError):
        TE.generate(model, torch.from_numpy(prefix), TE.GenerationSettings(max_new_tokens=2))
    with pytest.raises(ValueError):
        TE.generate(model, torch.from_numpy(prefix),
                    TE.GenerationSettings(max_new_tokens=2, filter_method="sorted"), device="cpu")
    out = TE.generate(model, torch.from_numpy(prefix),
                      TE.GenerationSettings(max_new_tokens=2, top_p=0.5, filter_method="sort"),
                      device="cpu")
    assert out["tokens"].shape == (3, 2)


def test_trim_and_decode():
    class Tok:
        all_special_ids = [9]

        def decode_tokens(self, ids):
            return ",".join(map(str, ids))

    result = {"tokens": torch.tensor([[1, 9, 2, 0], [3, 4, 0, 0]]),
              "lengths": torch.tensor([3, 2])}
    assert TE.trim_and_decode(result, Tok()) == ["1,2", "3,4"]
    assert TE.trim_and_decode(result, Tok(), strip_special=False, skip_ids=(3,)) == ["1,9,2", "4"]
