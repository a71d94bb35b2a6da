"""CPU rehearsals of benchmark/tools/trace_overhead.py at tiny sizes: the
rounds with the port's tracer on read each of the cell's program-span
readings (benchmark/program_spans.py), the rounds with it off record
nothing, and at a fixed rate the program's assigned - arrival equals the
harness's latency - `latency_s` for every request of the window."""

from __future__ import annotations

import pytest

from benchmark import program_spans as PS
from benchmark.tests.tiny import beam_context, serving_context
from benchmark.tools import trace_overhead as TO

CONTEXTS = {
    "gpt2xl.serve_backlog": lambda: serving_context("gpt2xl.serve_backlog", seconds=1.0),
    "gpt2xl.serve_rate": lambda: serving_context("gpt2xl.serve_rate", seconds=1.5),
    "gptj6b.beam_folder": lambda: beam_context(seconds=0.5),
}


@pytest.mark.parametrize("cell", sorted(CONTEXTS))
def test_rehearsed_rounds_read_the_program_spans(cell):
    from clipcap_tpu_torch.utils import profiling as P

    out = TO.measure(CONTEXTS[cell](), rounds=2)
    assert P.active() is None
    off, on = out["rounds"]
    assert off["tracer"] is False and "readings" not in off and "spans" not in off
    assert on["tracer"] is True and on["spans"] > 0
    want = {name for name, cells in PS.CELLS.items() if cell in cells}
    assert set(on["readings"]) | {"bundle.init_s.setup"} == want
    assert all(v is not None and v >= 0 for v in on["readings"].values()), on["readings"]
    assert out["bundle.init_s.setup"] > 0
    assert "bundle.create" in out["setup_spans_s"]
    if cell.startswith("gpt2xl."):  # the prefix pool and the engine's warm-up
        assert {"bundle.map", "bundle.int8_quantize", "serving.warmup"} <= set(out["setup_spans_s"])
    if cell == "gpt2xl.serve_rate":
        assert on["assigned_wait_max_diff_s"] is not None
        assert on["assigned_wait_max_diff_s"] < 1e-3


def test_idle_time_goes_to_the_innermost_span():
    from clipcap_tpu_torch.utils import profiling as P

    tr = P.Tracer()
    tr.begin("call", 0)
    tr.add("step.a", 10, 20)
    tr.add("step.b", 20, 40)
    tr.end(50)
    tr.begin("other", 60)
    tr.end(70)
    idle = PS.idle_by_span([(5, 15), (30, 65), (75, 80)], tr.spans)
    got = {k: round(v * 1e9) for k, v in idle.items()}
    assert got == {"call": 5 + 10, "step.a": 5, "step.b": 10, "other": 5, "host.other": 10 + 5}
