"""Idle share of the card over the traced window, in %: 1 - the union of
the intervals in which a device operation ran, over the window's length
(benchmark/device.py reduce_trace)."""

from benchmark.device import idle_pct


def read(rec):
    return idle_pct(rec)
