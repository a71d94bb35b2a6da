"""The serving engine's CUDA graph step on the card (decode/serving.py):
a small GPT2Int8 at 48 slots with K3 ("fused_step"), two serve calls with
refills. Every decode step replays the captured graph, and the served
tokens equal, request for request, those of the same engine with the graph
step off (eager) for the same seed.

Needs a CUDA card and skips without one. The file imports no JAX, so on
the card, where JAX is not installed, it runs without the suite's conftest:

    python -m pytest tests/test_torch_serving_graph.py --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from clipcap_tpu_torch.core.config import GPT2Config
from clipcap_tpu_torch.decode.engine import GenerationSettings
from clipcap_tpu_torch.decode.serving import Request, ServingEngine
from clipcap_tpu_torch.models.gpt2 import GPT2, quantize_params

LM = dict(vocab_size=50257, n_positions=128, n_embd=256, n_layer=4, n_head=4)
P = 8  # prefix length
SLOTS = 48
SETTINGS = GenerationSettings(max_new_tokens=24, top_p=0.8, repetition_penalty=1.2,
                              eos_token_id=50256, stop_token_id=13, filter_method="fused_step")


def _requests(n: int, seed: int):
    caps = np.random.default_rng(seed).integers(3, 20, n)
    return [Request(request_id=i, prefix_embeds=i % 64, max_length=int(c))
            for i, c in enumerate(caps)]


@pytest.mark.cuda
def test_graph_step_serves_the_eager_engines_tokens(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.manual_seed(0)
    cfg = GPT2Config(**LM)
    lm = quantize_params(GPT2(cfg, device="cuda", dtype=torch.bfloat16, seed=1))
    pool = torch.randn(64, P, LM["n_embd"], device="cuda", dtype=torch.bfloat16)

    def engine():
        return ServingEngine(lm, cfg, prefix_len=P, settings=SETTINGS, slots=SLOTS,
                             steps_per_sync=8, dtype=torch.bfloat16, device="cuda").warmup()

    with monkeypatch.context() as m:
        m.setattr(lm, "graph_safe_ring_step", False, raising=False)
        eager = engine()
    graphed = engine()
    assert eager._graph is None and graphed._graph is not None
    for seed, n in ((11, 150), (12, 90)):
        reqs = _requests(n, seed)
        want = eager.serve(reqs, seed=seed, prefix_pool=pool)
        got = graphed.serve(reqs, seed=seed, prefix_pool=pool)
        st = graphed.last_stats
        assert st["graph_steps"] == st["steps"] > 0 and st["refills"]
        assert eager.last_stats["graph_steps"] == 0 < eager.last_stats["steps"]
        assert set(got) == set(want) == {r.request_id for r in reqs}
        for rid in want:
            assert (got[rid]["tokens"], got[rid]["stopped"]) == \
                (want[rid]["tokens"], want[rid]["stopped"]), (seed, rid)
