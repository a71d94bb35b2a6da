"""Readings of the port's own spans (clipcap_tpu_torch/utils/profiling.py's
`Tracer`), and the split of a profile's idle device time by the innermost
program span the host was in.

A reading takes `program`, a dict a run assembles around a window:

- `tracer`: the Tracer that was active from before the build to the
  reference (its `spans`, call-stack, and `intervals`, overlapping);
- `t_open_ns`, `t_close_ns`: the window on time.perf_counter_ns;
- `window_ids`: the request ids the window judges (serving at a fixed
  rate), `calls` and `beam_steps` (beam).

Each returns None when the program recorded nothing to read (a program
without the tracer, or an untraced run). `READERS` maps the per-layer
metric names to them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _stack(tracer, name: str, t0_ns: int, t1_ns: int) -> list:
    """The call-stack spans `name` that start inside [t0_ns, t1_ns]."""
    return [s for s in tracer.spans
            if s is not None and s.name == name and t0_ns <= s.start_ns <= t1_ns]


def phase_s(tracer, name: str, ids) -> List[float]:
    """Seconds of each interval `name` whose request id is in `ids`."""
    ids = set(ids)
    return [(s.end_ns - s.start_ns) / 1e9 for s in tracer.intervals
            if s.name == name and s.request_id in ids]


def _p95(values) -> Optional[float]:
    return float(np.percentile(values, 95)) if len(values) else None


def _phase_p95(name: str):
    def read(program: Optional[dict]) -> Optional[float]:
        if not program or program.get("tracer") is None or not program.get("window_ids"):
            return None
        return _p95(phase_s(program["tracer"], name, program["window_ids"]))

    return read


def lm_host_ms_per_step(program: Optional[dict]) -> Optional[float]:
    """Host ms in `serving.step.lm` (the embedding, the 48 layers' launches
    and the logits' cast) per decode step dispatched inside the window."""
    if not program or program.get("tracer") is None:
        return None
    spans = _stack(program["tracer"], "serving.step.lm", program["t_open_ns"],
                   program["t_close_ns"])
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(spans)


def beam_host_ms_per_step(program: Optional[dict]) -> Optional[float]:
    """Host ms in `beam.step` inside the window over calls x steps."""
    if not program or program.get("tracer") is None or not program.get("calls"):
        return None
    spans = _stack(program["tracer"], "beam.step", program["t_open_ns"], program["t_close_ns"])
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / (
        program["calls"] * program["beam_steps"])


def bundle_init_s(program: Optional[dict]) -> Optional[float]:
    """Seconds in `bundle.create` (the constructors' own weight draws)
    before the window."""
    if not program or program.get("tracer") is None:
        return None
    spans = [s for s in program["tracer"].spans if s is not None and s.name == "bundle.create"
             and s.end_ns <= program["t_open_ns"]]
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9 if spans else None


READERS = {
    "serve.pull_wait_p95_s.latency": _phase_p95("serving.request.queued"),
    "serve.admit_wait_p95_s.latency": _phase_p95("serving.request.admit"),
    "serve.harvest_lag_p95_s.latency": _phase_p95("serving.request.harvest"),
    "serve.lm_host_ms_per_step.captions": lm_host_ms_per_step,
    "beam.host_ms_per_step.captions": beam_host_ms_per_step,
    "bundle.init_s.setup": bundle_init_s,
}

#: the cells each reading is read in
CELLS = {
    "serve.pull_wait_p95_s.latency": ("gpt2xl.serve_rate",),
    "serve.admit_wait_p95_s.latency": ("gpt2xl.serve_rate",),
    "serve.harvest_lag_p95_s.latency": ("gpt2xl.serve_rate",),
    "serve.lm_host_ms_per_step.captions": ("gpt2xl.serve_backlog",),
    "beam.host_ms_per_step.captions": ("gptj6b.beam_folder",),
    "bundle.init_s.setup": ("gpt2xl.serve_backlog", "gptj6b.beam_folder", "gpt2xl.serve_rate"),
}


# ---- idle device time by program span -----------------------------------------------


def device_gaps(prof, marker_ns: int, t0_ns: int, t1_ns: int) -> Tuple[list, float]:
    """The idle intervals of a CUDA-only torch.profiler trace inside the
    host window [t0_ns, t1_ns], on the host's clock, and the busy seconds.
    The marker kernel (benchmark/device.py launch_marker, launched at
    marker_ns) maps the device clock onto the host's."""
    from torch.autograd import DeviceType

    events, markers = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        if "double" in name and "fill" in name.lower():
            markers.append(start)
        elif dur > 0:
            events.append((start, start + dur))
    if not markers:
        raise RuntimeError("found no clock marker in the trace")
    offset = markers[0] - marker_ns
    busy = sorted((max(s - offset, t0_ns), min(e - offset, t1_ns)) for s, e in events
                  if e - offset > t0_ns and s - offset < t1_ns)
    gaps, cur = [], t0_ns
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1_ns:
        gaps.append((cur, t1_ns))
    return gaps, ((t1_ns - t0_ns) - sum(e - s for s, e in gaps)) / 1e9


def innermost_segments(spans) -> List[Tuple[int, int, str]]:
    """The host timeline as [(start, end, name)] of the innermost call-stack
    span at each instant, in order; time outside every span is left out.
    Exact for properly nested spans, at any depth."""
    items = sorted((s.start_ns, -s.end_ns, s.name) for s in spans if s is not None)
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, name) of the open spans
    cur = 0

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                segs.append((cur, end, name))
                cur = end

    for start, neg_end, name in items:
        close_until(start)
        if stack and start > cur:
            segs.append((cur, start, stack[-1][1]))
        stack.append((-neg_end, name))
        cur = start
    close_until(float("inf"))
    return segs


def idle_by_span(gaps, spans) -> Dict[str, float]:
    """Seconds of the idle intervals `gaps` (host ns, sorted) under each
    innermost program span, and under `host.other` outside every span."""
    segs = innermost_segments(spans)
    named: Dict[str, float] = {}
    j = 0
    for gs, ge in gaps:
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        covered, k = 0, j
        while k < len(segs) and segs[k][0] < ge:
            a, b = max(gs, segs[k][0]), min(ge, segs[k][1])
            if b > a:
                named[segs[k][2]] = named.get(segs[k][2], 0.0) + (b - a) / 1e9
                covered += b - a
            k += 1
        if ge - gs > covered:
            named["host.other"] = named.get("host.other", 0.0) + (ge - gs - covered) / 1e9
    return dict(sorted(named.items(), key=lambda kv: -kv[1]))
