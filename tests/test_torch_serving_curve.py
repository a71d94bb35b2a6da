"""tools/serving_latency_curve.py, the H100 curve behind
`cli.serve --target_p50_s`: on the CPU at a tiny GPT-2 it prints one JSON
line per slot count, with every request answered, finite latencies and
the card field naming the CPU. Its workload is bench.py's `_bench_serving`
(the prefix length, the 67-token bound, the caps' draw), and the stored
curve is ordered as a measured one is and picks by JAX's rule."""

import json

import numpy as np
import pytest
import torch

import bench
from clipcap_tpu.cli import serve as JSV
from clipcap_tpu_torch.cli import serve
from clipcap_tpu_torch.core.config import GPT2Config
from clipcap_tpu_torch.tools import serving_latency_curve as SLC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread beside the suite's other workers: the tool's steps are
    many small ops, which a shared thread pool slows most."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_curve_tool_prints_one_line_per_slot_count(tmp_path, capsys, monkeypatch):
    lm = tmp_path / "lm.json"
    lm.write_text(GPT2Config(vocab_size=64, n_positions=128, n_embd=32, n_layer=2,
                             n_head=4).to_json())
    # GPT-2's eos and stop lie outside this vocabulary: two of its tokens stand in
    monkeypatch.setattr(SLC, "EOS", 3)
    monkeypatch.setattr(SLC, "STOP", 5)
    lines = SLC.main(["--device", "cpu", "--lm_config_json", str(lm), "--slots", "4,8",
                      "--requests", "12"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == lines and [x["slots"] for x in printed] == [4, 8]
    for x in printed:
        assert x["requests"] == 12 and x["card"] == "cpu" and x["layers"] == 2
        assert len(x["captions_per_s_runs"]) == len(x["latency_p50_s_runs"]) == SLC.RUNS
        assert 0 < x["latency_p50_s"] <= x["latency_p99_s"] and x["captions_per_s"] > 0
        assert 0 < x["occupancy"] <= 1 and x["steps"] > 0
        assert x["ring_len"] == SLC.PREFIX_LEN + SLC.MAX_NEW + 1


def test_workload_is_bench_serving_and_curve_picks_by_jax_rule():
    assert (SLC.PREFIX_LEN, SLC.MAX_NEW) == (bench.PREFIX_LEN, bench.SERVE_MAX_NEW)
    assert (SLC.EOS, SLC.STOP) == (50256, 13)  # _bench_serving's eos_token_id, stop_token_id
    host_rng = np.random.default_rng(0)  # bench.py's draw, as _bench_serving makes it
    want = np.clip(np.round(host_rng.normal(12.0, 4.0, 2048)), 5, 30).astype(np.int32)
    np.testing.assert_array_equal(SLC.request_caps(2048), want)
    curve = serve.LATENCY_CURVE_P50_S
    assert sorted(curve) == sorted(JSV.LATENCY_CURVE_P50_S) == [128, 256, 512]
    for target in (0.1, curve[128], curve[256] - 1e-3, curve[512], 100.0):
        assert serve.pick_slots_for_p50(target) == JSV.pick_slots_for_p50(target, curve)
