"""The port's ring-KV-cache primitives and GPT-2 ring decode against the
JAX package (clipcap_tpu/ops/ring.py, models/gpt2.py decode_step_ring and
scatter_refill).

Ring primitives match exactly, before the first wrap (idx < T, where a
truncated remainder would unmask never-written slots) and after it. The
ring decode's logits match JAX's in f32 at atol/rtol 1e-5 across refills
and wraps; the refilled rows match inside their attended window (outside
it the JAX paste leaves junk and the port keeps the old values: both are
masked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import gpt2 as JG
from clipcap_tpu.ops import ring as JR
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.gpt2 import GPT2
from clipcap_tpu_torch.ops import ring as TR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and torch's default pool (one thread per core) in each
    would oversubscribe the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


T = 9


@pytest.mark.parametrize("idx", [0, 3, T - 1, T, 17, 40])
def test_ring_timesteps_and_layout_match_jax(idx):
    start = np.asarray([0, 2, max(idx - 4, 0), idx], np.int64)
    gp = TR.ring_timesteps(idx, T, "cpu")
    np.testing.assert_array_equal(gp.numpy(), np.asarray(JR.ring_timesteps(jnp.int32(idx), T)))
    wslot, bias = TR.ring_layout(idx, T, torch.from_numpy(start))
    jw, jbias = JR.ring_layout(jnp.int32(idx), T, jnp.asarray(start, jnp.int32))
    assert wslot == int(jw)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    if idx < T:
        # before the first wrap, never-written slots stay masked for every row
        assert (bias[:, idx + 1:] < 0).all()


@pytest.mark.parametrize("idx", [0, 3, T - 1, T, T + 1, 17, 40])
def test_ring_layout_takes_the_index_as_a_device_tensor(idx):
    """The ring step's device index (a 0-d int64 tensor): the same gp, slot
    and bias as the host int, before, at and across a wrap of the ring."""
    start = torch.tensor([0, 2, max(idx - 4, 0), idx])
    at = torch.tensor(idx)
    assert torch.equal(TR.ring_timesteps(at, T, "cpu"), TR.ring_timesteps(idx, T, "cpu"))
    wslot, bias = TR.ring_layout(idx, T, start)
    dslot, dbias = TR.ring_layout(at, T, start)
    assert isinstance(dslot, torch.Tensor) and dslot.dim() == 0 and int(dslot) == wslot
    assert torch.equal(dbias, bias)


@pytest.mark.parametrize("idx,p", [(5, 5), (7, 5), (12, 5), (30, 4)])
def test_refill_positions_match_jax(idx, p):
    got = TR.refill_positions(idx, p, T, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(JR.refill_positions(jnp.int32(idx),
                                                                              p, T)))


@pytest.mark.parametrize("idx", [6, 11])
def test_paste_rows_matches_jax_inside_the_window(idx):
    rng = np.random.default_rng(0)
    big = rng.normal(size=(2, 5, T, 3, 4)).astype(np.float32)
    small = rng.normal(size=(2, 2, 5, 3, 4)).astype(np.float32)
    rp = TR.refill_positions(idx, 5, T, "cpu")
    got = TR.paste_rows(torch.from_numpy(big.copy()), torch.from_numpy(small), 1, rp, time_axis=2)
    want = np.asarray(JR.paste_rows(jnp.asarray(big), jnp.asarray(small), jnp.int32(1),
                                    jnp.asarray(rp.numpy()), time_axis=2))
    win = rp.numpy()
    np.testing.assert_array_equal(got.numpy()[:, 1:3][:, :, win], want[:, 1:3][:, :, win])
    np.testing.assert_array_equal(got.numpy()[:, 1:3][:, :, win], small)
    # other rows are untouched
    for r in (0, 3, 4):
        np.testing.assert_array_equal(got.numpy()[:, r], big[:, r])
        np.testing.assert_array_equal(want[:, r], big[:, r])


def test_paste_rows_axis0_matches_jax():
    big = np.arange(24, dtype=np.float32).reshape(6, 4)
    small = -np.ones((2, 4), np.float32)
    got = TR.paste_rows_axis0(torch.from_numpy(big.copy()), torch.from_numpy(small), 3)
    want = JR.paste_rows_axis0(jnp.asarray(big), jnp.asarray(small), jnp.int32(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


LM = dict(vocab_size=96, n_positions=96, n_embd=32, n_layer=2, n_head=4)


def test_decode_step_ring_matches_jax_across_refills_and_wraps():
    """Three rows on a 9-slot ring: prefill P=5, decode, refill rows [1, 3)
    at two points, and run until the global index has wrapped the ring
    several times. Logits at every step at f32 atol/rtol 1e-5."""
    cfg_j = JC.GPT2Config(**LM)
    params = JG.init(jax.random.PRNGKey(0), cfg_j)
    model = convert.load(GPT2(TC.GPT2Config(**LM), device="cpu"),
                         convert.gpt2_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(1)
    b, p = 3, 5
    prefix = rng.normal(size=(b, p, 32)).astype(np.float32)

    jcache = JG.init_cache(cfg_j, b, T)
    jlogits, jcache = JG.prefill(params, cfg_j, jnp.asarray(prefix), jcache)
    cache = model.init_cache(b, T)
    with torch.no_grad():
        logits, cache = model.prefill(torch.from_numpy(prefix), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)

    pos = np.full(b, p, np.int64)
    start = np.zeros(b, np.int64)
    refill_at = {4: 1, 11: 2}  # step -> first refilled row (block to row 3)
    for step in range(24):
        if step in refill_at:
            q = refill_at[step]
            new = rng.normal(size=(b - q, p, 32)).astype(np.float32)
            js = JG.init_cache(cfg_j, b - q, p)
            _, js = JG.prefill(params, cfg_j, jnp.asarray(new), js)
            jcache = JG.scatter_refill(jcache, js, jnp.int32(q))
            small = model.init_cache(b - q, p)
            with torch.no_grad():
                _, small = model.prefill(torch.from_numpy(new), small)
            cache = GPT2.scatter_refill(cache, small, q)
            assert cache.index == int(jcache.index)
            start[q:] = cache.index - p
            pos[q:] = p
        tok = rng.integers(0, LM["vocab_size"], b)
        jemb = JG.embed_tokens(params, jnp.asarray(tok))[:, None]
        jlogits, jcache = JG.decode_step_ring(params, cfg_j, jemb, jcache,
                                              jnp.asarray(pos, jnp.int32),
                                              jnp.asarray(start, jnp.int32))
        with torch.no_grad():
            emb = model.embed_tokens(torch.from_numpy(tok))[:, None]
            logits, cache = model.decode_step_ring(emb, cache, torch.from_numpy(pos),
                                                   torch.from_numpy(start))
        assert cache.index == int(jcache.index)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5,
                                   err_msg=f"step {step}")
        pos = np.minimum(pos + 1, LM["n_positions"] - 1)
    assert cache.index > 2 * T  # the ring wrapped more than twice
