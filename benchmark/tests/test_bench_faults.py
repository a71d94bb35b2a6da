"""With the timed path broken underneath, a run's `correct` comes out false:
once for each fault a cell can have (benchmark/tools/faults.py)."""

from __future__ import annotations

import pytest

from benchmark import run as B
from benchmark.tests.tiny import beam_context, serving_context
from benchmark.tools.faults import FAULTS


# Samplers that draw from the wrong set now and then show in the share of
# far-off tokens, which wants more tokens judged than the tiny default.
SHARE_FAULTS = ("penalty_off", "top_p_wide")


@pytest.mark.parametrize("cell, fault", [
    ("gpt2xl.serve_backlog", "token"), ("gpt2xl.serve_backlog", "state"),
    ("gpt2xl.serve_rate", "token"), ("gpt2xl.serve_backlog", "penalty_off"),
    ("gpt2xl.serve_backlog", "top_p_wide"), ("gptj6b.beam_folder", "beam_token"),
    ("gptj6b.beam_folder", "state")])
def test_a_planted_fault_is_not_correct(cell, fault):
    ctx = beam_context() if cell.startswith("gptj6b") else serving_context(cell)
    if fault in SHARE_FAULTS:
        ctx.seconds = 3.0
        ctx.traffic.update(slots=32, judge_requests=96)
    undo = FAULTS[fault]()
    try:
        out = B.run_cell(ctx)
    finally:
        undo()
    assert out["correct"] is False, out["checks"]
