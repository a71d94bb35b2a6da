"""The port's speculative greedy decode (decode/speculative.py) against the
JAX package's, on the CPU, in the cases of tests/test_speculative.py:

- the target as its own draft (full acceptance, about (gamma+1)x fewer
  chunks), a deliberately unrelated draft (near-zero acceptance), the int8
  target (one decode step per chunk token), eos stopping, and a GPT-J
  target with a GPT-2 draft;
- a GPT-J target whose vocabulary is wider than its GPT-2 draft's (fault 8
  of ROADMAP.md §3): the draft embeds the target's wider ids clamped to
  its last row, as JAX's gather does; the embedding raised IndexError
  before.

Each gives JAX's tokens, lengths and chunks, and the tokens equal the
port's own target-only greedy generate (f32, so no near ties)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.decode.speculative import speculative_greedy as jax_speculative
from clipcap_tpu.models import gpt2 as JG2
from clipcap_tpu.models import gptj as JGJ
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.decode import engine as TE
from clipcap_tpu_torch.decode.speculative import speculative_greedy
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Int8
from clipcap_tpu_torch.models.gptj import GPTJ

T_CFG = dict(vocab_size=211, n_positions=128, n_embd=48, n_layer=3, n_head=4)
D_CFG = dict(vocab_size=211, n_positions=128, n_embd=24, n_layer=1, n_head=2)
J_CFG = dict(vocab_size=211, n_positions=128, n_embd=48, n_layer=2, n_head=4, rotary_dim=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_clear_jax_caches():
    """One intra-op thread; and JAX's compilation caches cleared after the
    module, as tests/test_speculative.py does (its while_loop executables
    trip a latent jaxlib CPU bug in a later unrelated compile)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    jax.clear_caches()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    """tests/test_speculative.py's world: JAX's init of the GPT-2 target and
    draft and the prompts, with the port's modules loaded from them."""
    tp = JG2.init(jax.random.PRNGKey(0), JC.GPT2Config(**T_CFG))
    dp = JG2.init(jax.random.PRNGKey(9), JC.GPT2Config(**D_CFG))
    t_prompt = jax.random.normal(jax.random.PRNGKey(1), (1, 5, T_CFG["n_embd"])) * 0.3
    d_prompt = jax.random.normal(jax.random.PRNGKey(2), (1, 5, D_CFG["n_embd"])) * 0.3
    target = convert.load(GPT2(TC.GPT2Config(**T_CFG), device="cpu"),
                          convert.gpt2_state_dict(_np(tp)))
    draft = convert.load(GPT2(TC.GPT2Config(**D_CFG), device="cpu"),
                         convert.gpt2_state_dict(_np(dp)))
    return dict(tp=tp, dp=dp, t_prompt=t_prompt, d_prompt=d_prompt, target=target, draft=draft)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _same_as_jax(got: dict, want: dict):
    for key in ("tokens", "lengths", "chunks"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def _greedy(lm, prompt, n, eos=None):
    return TE.generate(lm, prompt, TE.GenerationSettings(max_new_tokens=n, greedy=True,
                                                         eos_token_id=eos), device="cpu")


def test_self_draft_accepts_everything(world):
    w = world
    want = jax_speculative(JG2, w["tp"], JC.GPT2Config(**T_CFG), JG2, w["tp"],
                           JC.GPT2Config(**T_CFG), w["t_prompt"], w["t_prompt"],
                           max_new_tokens=20, gamma=4)
    got = speculative_greedy(w["target"], w["target"], _t(w["t_prompt"]), _t(w["t_prompt"]),
                             max_new_tokens=20, gamma=4, device="cpu")
    _same_as_jax(got, want)
    assert torch.equal(got["tokens"], _greedy(w["target"], _t(w["t_prompt"]), 20)["tokens"])
    assert int(got["lengths"][0]) == 20 and int(got["chunks"][0]) <= -(-(20 - 1) // 5) + 1


def test_unrelated_draft_gives_target_greedy(world):
    w = world
    want = jax_speculative(JG2, w["tp"], JC.GPT2Config(**T_CFG), JG2, w["dp"],
                           JC.GPT2Config(**D_CFG), w["t_prompt"], w["d_prompt"],
                           max_new_tokens=20, gamma=3)
    got = speculative_greedy(w["target"], w["draft"], _t(w["t_prompt"]), _t(w["d_prompt"]),
                             max_new_tokens=20, gamma=3, device="cpu")
    _same_as_jax(got, want)
    assert torch.equal(got["tokens"], _greedy(w["target"], _t(w["t_prompt"]), 20)["tokens"])
    assert int(got["chunks"][0]) <= 20


def test_int8_target_steps_token_by_token(world):
    """The int8 target has no multi-token continuation (nor has JAX's
    adapter): verification takes one decode step per chunk token."""
    w = world
    q = JG2.quantize_params(w["tp"])
    q8 = convert.load(GPT2Int8(TC.GPT2Config(**T_CFG), device="cpu"),
                      convert.gpt2_state_dict(_np(q)))
    assert not q8.chunked_forward
    tb = w["t_prompt"].astype(jnp.bfloat16)
    want = jax_speculative(JG2.gpt2_int8, q, JC.GPT2Config(**T_CFG), JG2, w["dp"],
                           JC.GPT2Config(**D_CFG), tb, w["d_prompt"], max_new_tokens=12,
                           gamma=3)
    got = speculative_greedy(q8, w["draft"], _t(tb).bfloat16(), _t(w["d_prompt"]),
                             max_new_tokens=12, gamma=3, device="cpu")
    _same_as_jax(got, want)
    assert torch.equal(got["tokens"], _greedy(q8, _t(tb).bfloat16(), 12)["tokens"])


def test_eos_stops_like_plain_greedy(world):
    w = world
    ref = _greedy(w["target"], _t(w["t_prompt"]), 20)["tokens"]
    eos = int(ref[0, 7])  # a token plain greedy emits mid-sequence
    want = jax_speculative(JG2, w["tp"], JC.GPT2Config(**T_CFG), JG2, w["dp"],
                           JC.GPT2Config(**D_CFG), w["t_prompt"], w["d_prompt"],
                           max_new_tokens=20, gamma=4, eos_token_id=eos)
    got = speculative_greedy(w["target"], w["draft"], _t(w["t_prompt"]), _t(w["d_prompt"]),
                             max_new_tokens=20, gamma=4, eos_token_id=eos, device="cpu")
    _same_as_jax(got, want)
    plain = _greedy(w["target"], _t(w["t_prompt"]), 20, eos=eos)
    n = int(plain["lengths"][0])
    assert int(got["lengths"][0]) == n
    assert torch.equal(got["tokens"][0, :n], plain["tokens"][0, :n])


@pytest.mark.parametrize("target_vocab", [211, 240])
def test_gptj_target_with_gpt2_draft(world, target_vocab):
    """A GPT-J target with the GPT-2 draft. At a target vocabulary of 240
    against the draft's 211 (fault 8), the target emits ids the draft's
    table lacks; the draft embeds them clamped, as JAX's gather does."""
    w = world
    jcfg = dict(J_CFG, vocab_size=target_vocab)
    jp = JGJ.init(jax.random.PRNGKey(3), JC.GPTJConfig(**jcfg))
    j_prompt = jax.random.normal(jax.random.PRNGKey(4), (1, 5, jcfg["n_embd"])) * 0.3
    target = convert.load(GPTJ(TC.GPTJConfig(**jcfg), device="cpu"),
                          convert.gptj_state_dict(_np(jp)))
    want = jax_speculative(JGJ, jp, JC.GPTJConfig(**jcfg), JG2, w["dp"], JC.GPT2Config(**D_CFG),
                           j_prompt, w["d_prompt"], max_new_tokens=15, gamma=3)
    got = speculative_greedy(target, w["draft"], _t(j_prompt), _t(w["d_prompt"]),
                             max_new_tokens=15, gamma=3, device="cpu")
    _same_as_jax(got, want)
    assert torch.equal(got["tokens"], _greedy(target, _t(j_prompt), 15)["tokens"])
    if target_vocab > D_CFG["vocab_size"]:
        # the case is live: the target emitted ids past the draft's vocabulary
        assert int(got["tokens"].max()) >= D_CFG["vocab_size"]


def test_refuses_a_batch():
    lm = GPT2(TC.GPT2Config(**D_CFG), device="cpu")
    with pytest.raises(ValueError, match="batch-1"):
        speculative_greedy(lm, lm, torch.zeros(2, 3, 24), torch.zeros(2, 3, 24), device="cpu")
