"""The controls at test size: the reference one step below the
configuration's precision in the program's place (serving: the int8
decode at 4 bits), and the program's own lower path (beam: GPT-J's int8
decode). benchmark/tools/control.py reads the same on the card at the
cells' size, where the limits were set between the two readings. Serving's
control fails its limit here too; beam's int8 error at this size lies
below the full size's limit (PERF.md), so its test holds the ordering:
the control reads above the sound run of the same seed."""

from __future__ import annotations

from benchmark import run as B
from benchmark.drivers import beam, serve
from benchmark.tests.tiny import beam_context, serving_context


def test_serving_control_fails_the_limit():
    ctx = serving_context(seconds=1.5)
    ctx.control_bits = 4
    out = B.run_cell(ctx)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["served_gap"]["value"] > ctx.limits["served_gap"]
    assert out["checks"]["cap_faults"]["value"] == 0


def one_call(control_bits=None):
    """The beam context with one call of 8 distinct images: a window of 0 s
    runs exactly one call, so both runs judge the same images on a loaded
    CPU too."""
    ctx = beam_context(seconds=0.0)
    ctx.traffic.update(images=8, batches=1)
    ctx.control_bits = control_bits
    return ctx


def test_beam_control_reads_above_the_sound_run():
    sound = beam.run(one_call())["verdict"]["score_gap"]
    ctx = one_call(control_bits=8)
    control = beam.run(ctx)["verdict"]["score_gap"]
    assert sound <= ctx.limits["score_gap"] < 1.0
    assert control > 2 * sound
