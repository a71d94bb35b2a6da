"""Host spans inside the port: a `Tracer` that keeps named intervals on
`time.perf_counter_ns()` in memory.

Two kinds of record, kept apart:

- call-stack spans (`Tracer.spans`): host activity, properly nested on the
  one thread that issues the work. Each names its enclosing span by index
  (`parent`). Only these may name a stretch of idle device time.
- intervals (`Tracer.intervals`): spans that may overlap one another, such
  as a served request's phases (`serving.request.*`, each with its
  `request_id`) or the parallel `nvcc` builds (`kernels.build`).

Tracing is off unless a tracer is active: `start()`/`stop()` or
`with tracing() as tr:`. The instrumented code reads `active()` once per
call and tests it for None at each span site, so with no tracer it records
nothing and pays one test per site. `perf_counter_ns` is the clock a
device-side marker can be stamped with, so the spans map onto a profiler's
device timeline by one offset.

    from clipcap_tpu_torch.utils import profiling as P
    with P.tracing() as tr:
        engine.serve(requests, prefix_pool=pool)
    tr.write_jsonl("spans.jsonl")
    print(tr.summary())
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

now_ns = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # index in Tracer.spans of the enclosing call-stack span
    request_id: Any = None
    attrs: Optional[dict] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Open:
    """The context manager of one call-stack span."""

    __slots__ = ("tracer", "name", "attrs")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        self.tracer.begin(self.name, **(self.attrs or {}))
        return self

    def __exit__(self, *exc):
        self.tracer.end()
        return False


class Tracer:
    """Records in memory: `spans` (call-stack, in the order they began; a
    span still open is None) and `intervals` (overlapping, each with the
    call-stack span open when it was recorded as parent)."""

    def __init__(self):
        self.spans: List[Optional[Span]] = []
        self.intervals: List[Span] = []
        self._open: List[tuple] = []  # (index, name, start_ns, attrs)

    def begin(self, name: str, t_ns: Optional[int] = None, **attrs) -> int:
        """Open a call-stack span inside the innermost open one, at t_ns
        (now by default); returns its index."""
        i = len(self.spans)
        self.spans.append(None)
        self._open.append((i, name, now_ns() if t_ns is None else t_ns, attrs or None))
        return i

    def end(self, t_ns: Optional[int] = None) -> Span:
        """Close the innermost open span at t_ns (now by default)."""
        i, name, t0, attrs = self._open.pop()
        sp = Span(name, t0, now_ns() if t_ns is None else t_ns, self._parent(), None, attrs)
        self.spans[i] = sp
        return sp

    def span(self, name: str, **attrs) -> _Open:
        """`with tracer.span(name):` a call-stack span around the block."""
        return _Open(self, name, attrs or None)

    def add(self, name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
        """A closed call-stack span [t0_ns, t1_ns] inside the innermost open
        one (a step's tiles, timed by the caller)."""
        self.spans.append(Span(name, t0_ns, t1_ns, self._parent(), None, attrs or None))

    def interval(self, name: str, t0_ns: int, t1_ns: int, request_id: Any = None,
                 **attrs) -> None:
        """An interval that may overlap others: a request's phase, a build."""
        self.intervals.append(Span(name, t0_ns, t1_ns, self._parent(), request_id,
                                   attrs or None))

    def _parent(self) -> Optional[int]:
        return self._open[-1][0] if self._open else None

    # ---- reading ----------------------------------------------------------------

    def named(self, name: str) -> List[Span]:
        """Every closed record called `name`, of either kind."""
        return [s for s in self.spans if s is not None and s.name == name] + [
            s for s in self.intervals if s.name == name]

    def summary(self) -> Dict[str, dict]:
        """Per name: count, total, p50 and p95 seconds."""
        by: Dict[str, list] = {}
        for s in self.spans + self.intervals:
            if s is not None:
                by.setdefault(s.name, []).append(s.seconds)
        return {n: {"count": len(v), "total_s": float(np.sum(v)),
                    "p50_s": float(np.percentile(v, 50)), "p95_s": float(np.percentile(v, 95))}
                for n, v in sorted(by.items())}

    def records(self):
        """Each closed record as a JSON-ready dict, call-stack spans first."""
        for kind, items in (("stack", self.spans), ("interval", self.intervals)):
            for i, s in enumerate(items):
                if s is None:
                    continue
                rec = {"kind": kind, "index": i, "name": s.name, "start_ns": s.start_ns,
                       "end_ns": s.end_ns, "parent": s.parent}
                if s.request_id is not None:
                    rec["request_id"] = s.request_id
                rec.update(s.attrs or {})
                yield rec

    def write_jsonl(self, path: str) -> int:
        """Write records() as JSON lines; returns the number written."""
        n = 0
        with open(path, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec, default=str) + "\n")
                n += 1
        return n


_ACTIVE: Optional[Tracer] = None
#: the shared no-op context manager of a span site with no tracer
NULL = contextlib.nullcontext()


def active() -> Optional[Tracer]:
    return _ACTIVE


def start(tracer: Optional[Tracer] = None) -> Tracer:
    """Make `tracer` (a new one by default) the active tracer."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a tracer is already active")
    _ACTIVE = tracer if tracer is not None else Tracer()
    return _ACTIVE


def stop() -> Optional[Tracer]:
    """Switch tracing off; returns the tracer that was active."""
    global _ACTIVE
    tr, _ACTIVE = _ACTIVE, None
    return tr


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None):
    tr = start(tracer)
    try:
        yield tr
    finally:
        stop()


def span(name: str, **attrs):
    """A call-stack span on the active tracer, or the shared no-op."""
    return NULL if _ACTIVE is None else _ACTIVE.span(name, **attrs)


def traced(name: str):
    """Decorator: a call-stack span `name` around every call made while a
    tracer is active."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            tr = _ACTIVE
            if tr is None:
                return fn(*a, **k)
            with tr.span(name):
                return fn(*a, **k)

        return call

    return wrap
