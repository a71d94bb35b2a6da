"""DeepSeek-V3 through the serving engine on the card, at Moonlight-16B-A3B's
published widths and 2 layers (1 dense, 1 MoE of 64 experts top-6 plus 2
shared), in bf16, with the benchmark's seeded init
(benchmark/families/deepseek_v3.py): the engine's logits at every prefill and at every decode
step that fed a served token, against the plain float32 reference's full
forward (benchmark/reference/deepseek_v3.py) over the request's prefix and
tokens. The routed experts run as grouped GEMMs on the card, the engine
replays the ring step as a CUDA graph, and a ring step, at the host's
index or the device's, runs with no host synchronization (PyTorch's sync
debug mode).

The tolerance is bf16's: the model stores its weights, activations and
latent ring in bf16, and logits that spread by ~6 (the final norm's gain
6.6, as the benchmark's configuration sets it) move by about a tenth of a
logit against float32; the reference at 8 bits must land outside it
(TOL_LOGITS, the readings beside it).

Needs a CUDA card and skips without one. The file imports no JAX, so on
the card, where JAX is not installed, it runs without the suite's conftest:

    python -m pytest tests/test_torch_deepseek_v3_card.py --noconftest -p no:cacheprovider -s
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from benchmark.drivers.serve_large import fill
from benchmark.families import deepseek_v3 as FAM
from benchmark.reference import common as C
from benchmark.reference import deepseek_v3 as R
from clipcap_tpu_torch.models.deepseek_v3 import DeepseekV3

CONFIG = Path(__file__).resolve().parents[1] / "benchmark/configs/clipcap-moonlight16b.json"

# bf16 keeps 8 bits of mantissa: the weights, the products' inputs and the
# latent ring round at ~4e-3 relative, and 2 layers move logits of spread
# ~6 by 0.137 at worst over 136 positions on the card; the same model's
# reference with its matrices at 8 bits (the precision below bf16) lies
# 2.57 from float32's at worst (an H100 80GB HBM3). Half a logit leaves
# 3.6x room above the first and 5x below the second, and the test asserts
# both sides.
TOL_LOGITS = 0.5


@pytest.mark.cuda
def test_engine_logits_match_the_reference_at_published_widths(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from test_torch_deepseek_v3 import serve_error

    C.no_tf32()
    spec = dict(json.loads(CONFIG.read_text()), num_hidden_layers=2)
    cfg = FAM.program_configs(spec)[0]
    lm = DeepseekV3(cfg, device="cuda", dtype=torch.bfloat16).eval()
    fill(lm, FAM.layout(spec, prefix=""), 0, "cuda", torch.bfloat16)  # the benchmark's init
    w = {"lm." + k: v for k, v in lm.state_dict().items()}
    ref = R.LM(w, dataclasses.asdict(cfg))
    control = R.LM(w, dataclasses.asdict(cfg), quant_bits=8)  # one step below bf16
    worst, n, ctrl = serve_error(lm, ref, monkeypatch, n_requests=24, slots=8, prefix_len=10,
                                 control=control)
    print(f"card: {torch.cuda.get_device_name(0)}; {n} positions, largest logit error "
          f"{worst!r}, the int8 control's {ctrl!r} (tolerance {TOL_LOGITS})")
    assert n >= 100
    assert worst < TOL_LOGITS < ctrl
    # a ring step reads nothing back to the host: no op in it synchronizes
    cache = lm.init_cache(8, 16)
    emb = lm.embed_tokens(torch.arange(8, device="cuda"))[:, None]
    pos, start = torch.full((8,), 3, device="cuda"), torch.zeros(8, dtype=torch.long,
                                                                   device="cuda")
    index = torch.full((), 5, dtype=torch.long, device="cuda")
    with torch.no_grad():
        lm.decode_step_ring(emb, cache._replace(index=3), pos, start)  # warm
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm.decode_step_ring(emb, cache._replace(index=4), pos, start)
            lm.decode_step_ring(emb, cache._replace(index=5), pos, start, index=index)
        finally:
            torch.cuda.set_sync_debug_mode("default")
