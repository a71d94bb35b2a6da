"""CPU rehearsals of the `serve_large` driver over a tiny DeepSeek-V3
captioner (clipcap-moonlight16b cut to a few rows), and the block-wise
judge against the all-float32 one."""

from __future__ import annotations

import copy
import json

import pytest

from benchmark import run as B

CELL = "moonlight16b.serve_backlog"


def large_context(seed: int = 12345678901, seconds: float = 2.0, trace: bool = False):
    """The cell's files with Moonlight, the mapper and the mix cut to CPU size."""
    c, config, traffic, limits = B.load_cell(CELL)
    config = copy.deepcopy(config)
    config.update(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
                  num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
                  n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                  kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16)
    config["mapper"].update(dim_clip=32, dim_embedding=64, prefix_length=2, clip_length=2,
                            num_layers=1, num_heads=4)
    # logits spread 0.02 x sqrt(64) x 37.5 = 6, as at full size
    config["assumed"]["final_norm_gain"] = 37.5
    traffic = copy.deepcopy(traffic)
    traffic.update(slots=8, steps_per_sync=4, pool_rows=64, judge_requests=16, warm_s=0.5,
                   close_slack_s=0.5)
    traffic["caps"].update(mean=6.0, std=2.0, min=2, max=10)
    traffic["settings"].update(max_new_tokens=12, eos_token_id=511)
    return B.Context(cell=c, config=config, traffic=traffic, limits=limits, seed=seed,
                     seconds=seconds, trace=trace, device="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsed_run_prints_a_sound_last_line(trace, capsys):
    B.emit(B.run_cell(large_context(trace=trace)))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in B.cell_metrics(B.manifest(), CELL, trace)}
    assert set(line["metrics"]) <= want
    # the judged tokens' logits were all found on the timed path
    assert line["checks"]["logit_unmatched"]["value"] == 0
    assert line["checks"]["logit_rms"]["value"] < line["checks"]["logit_rms"]["limit"]
    if trace:  # no device trace on the CPU: the engine's and the expert log's readings
        assert set(line["metrics"]) == {"moe.expert_skew.captions", "mfu.captions",
                                        "serve.occupancy.captions",
                                        "serve.host_ms_per_step.captions"}
        assert line["metrics"]["moe.expert_skew.captions"]["value"] >= 1.0
    else:
        assert set(line["metrics"]) == want


def test_logit_check_reads_the_controls_above_the_program(capsys):
    """At test size the program (bf16) lies 0.015 from the reference, the
    control at 8 bits 0.034 and at 4 bits 0.62 (median root mean square
    over the judged columns): the check reads each control's own logits
    at the positions the run found, and 4 bits fail its limit."""
    from benchmark.drivers import serve_large as SL

    got = {}
    for bits in (8, 4):
        ctx = large_context()
        ctx.control_bits = bits
        got[bits] = SL.run(ctx)["verdict"]
    for bits, v in got.items():
        assert v["logits"]["unmatched"] == 0 and v["control"]["logits"]["positions"] > 50
        assert v["control"]["sampled"]["logit_rms"] > 1.5 * v["logit_rms"], (bits, v["logits"])
    assert got[4]["control"]["sampled"]["logit_rms"] > large_context().limits["logit_rms"]


def test_fill_draws_what_make_draws():
    import torch

    from benchmark import weights as W
    from benchmark.drivers import serve_large as SL

    ctx = large_context()
    layout = W.captioner_layout(ctx.config)
    want = W.make(layout, 7, "cpu", torch.bfloat16)
    own = {name: torch.empty(shape, dtype=torch.bfloat16) for name, shape, _, _ in layout}

    class Holder(torch.nn.Module):
        def state_dict(self, keep_vars=False):
            return own

    SL.fill(Holder(), layout, 7, "cpu", torch.bfloat16)
    assert all(torch.equal(own[k], want[k]) for k in want)


def test_blockwise_judge_gives_the_all_float32_judges_numbers():
    import numpy as np

    from benchmark import traffic as T
    from benchmark.drivers import serve_large as SL
    from benchmark.reference import serving, serving_blockwise

    ctx = large_context()
    bundle, pool, engine = SL.build(ctx)
    caps = T.seeded_caps(ctx.traffic, ctx.seed)
    from clipcap_tpu_torch.decode.serving import Request

    n = 24
    res = engine.serve([Request(i, i % len(pool), max_length=int(caps[i])) for i in range(n)],
                       seed=ctx.seed, prefix_pool=pool)
    req_caps = {i: int(caps[i]) for i in res}
    rows = {i: i % len(pool) for i in res}
    a = serving.judge(ctx, res, req_caps, rows, control_bits=4)
    b = serving_blockwise.judge(ctx, res, req_caps, rows, control_bits=4)
    assert a["tokens_judged"] == b["tokens_judged"] > 0
    for key in ("served_gap", "far_share", "cap_faults"):
        assert np.isclose(a[key], b[key], rtol=1e-4, atol=1e-5), (key, a[key], b[key])
    assert np.isclose(a["control"]["first"]["served_gap"], b["control"]["first"]["served_gap"],
                      rtol=1e-4, atol=1e-5)
