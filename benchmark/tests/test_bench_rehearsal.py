"""CPU rehearsals of each driver at tiny sizes: a whole run past the look
for a card, its last line parsed as the driver of the checks parses it."""

from __future__ import annotations

import json

import pytest

from benchmark import run as B
from benchmark.tests.tiny import beam_context, serving_context

CONTEXTS = {
    "gpt2xl.serve_backlog": lambda trace: serving_context("gpt2xl.serve_backlog", trace=trace),
    "gpt2xl.serve_rate": lambda trace: serving_context("gpt2xl.serve_rate", trace=trace),
    "gptj6b.beam_folder": lambda trace: beam_context(trace=trace),
}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(CONTEXTS))
def test_rehearsed_run_prints_a_sound_last_line(cell, trace, capsys):
    B.emit(B.run_cell(CONTEXTS[cell](trace)))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    man = B.manifest()
    want = {m["name"] for m in B.cell_metrics(man, cell, trace)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want  # every end-to-end metric, setup_s too
    for m in line["metrics"].values():
        assert m["value"] >= 0 and m["unit"]
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)
