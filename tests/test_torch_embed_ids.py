"""Token ids outside [0, V) embed as JAX's gather embeds them: a negative
id wraps once by the row count (numpy's table[-1] is the last row), then
every id is clamped to [0, V - 1]. The token shards of preprocessing are
padded with -1, and training reads them; before the repair the port's
`models/common.gather_rows` clamped -1 to row 0.

The same ids go through JAX's `embed_tokens` and the port's for GPT-2,
GPT-J and T5 (float and int8 modules), and the rows must be equal bit for
bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.core import config as JC
from clipcap_tpu.models import gpt2 as JG2
from clipcap_tpu.models import gptj as JGJ
from clipcap_tpu.models import t5 as JT5
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.core import config as TC
from clipcap_tpu_torch.models.common import gather_rows
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Int8
from clipcap_tpu_torch.models.gptj import GPTJ, GPTJInt8
from clipcap_tpu_torch.models.t5 import T5, T5Int8

V = 37
FAMILIES = {
    "gpt2": (JC.GPT2Config, TC.GPT2Config, JG2, GPT2, GPT2Int8, convert.gpt2_state_dict,
             dict(vocab_size=V, n_positions=16, n_embd=16, n_layer=1, n_head=2)),
    "gptj": (JC.GPTJConfig, TC.GPTJConfig, JGJ, GPTJ, GPTJInt8, convert.gptj_state_dict,
             dict(vocab_size=V, n_positions=16, n_embd=16, n_layer=1, n_head=2, rotary_dim=4)),
    "t5": (JC.T5Config, TC.T5Config, JT5, T5, T5Int8, convert.t5_state_dict,
           dict(vocab_size=V, d_model=16, d_kv=8, d_ff=32, num_layers=1, num_decoder_layers=1,
                num_heads=2, relative_attention_num_buckets=8,
                relative_attention_max_distance=16)),
}
# -1 the last row, -V the first, -V-3 below it (clamped to the first), V and
# V+5 past the end (clamped to the last), 0 itself
IDS = np.asarray([[-1, -V, -V - 3, V, V + 5, 0]])


def test_gather_rows_wraps_then_clamps_as_jax():
    table = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    ids = np.asarray([-1, 7, -9, -5, 2])
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table[[4, 4, 0, 0, 2]])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_embed_tokens_of_out_of_range_ids_equal_jax(family):
    jcfg, tcfg, jmod, float_cls, int8_cls, to_sd, kw = FAMILIES[family]
    params = jmod.init(jax.random.PRNGKey(0), jcfg(**kw))
    want = np.asarray(jmod.embed_tokens(params, jnp.asarray(IDS)))
    model = convert.load(float_cls(tcfg(**kw), device="cpu"),
                         to_sd(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model.embed_tokens(torch.from_numpy(IDS)).numpy()
    np.testing.assert_array_equal(got, want)
    # the int8 module embeds through its float table (stored in its own dtype)
    q8 = int8_cls(tcfg(**kw), device="cpu")
    key = "wte" if "wte" in params else "shared"
    table = getattr(q8, key)
    with torch.no_grad():
        table.copy_(torch.from_numpy(np.array(params[key])).to(table.dtype))
        got = q8.embed_tokens(torch.from_numpy(IDS)).float().numpy()
    want = jmod.embed_tokens({key: jnp.asarray(table.float().numpy())}, jnp.asarray(IDS))
    np.testing.assert_array_equal(got, np.asarray(want))
