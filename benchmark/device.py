"""The yardstick on the device side: the card's name and power limit, the
published peaks, the kernels' least times, host spans, and the reduction of
a profiler trace to busy time, device operations and named idle gaps.

The bounds are frozen copies of chip_smoke.py's `bound`, `attention_bound`
and `sampler_bound` (chip_smoke.py, section 3), and the raw kineto-event
reading is the one of clipcap_tpu_torch/tools/serving_latency_curve.py's
`profile_serve`, which skips `key_averages()` (too slow at ~8,400 launches
a serving step). They are copied here so that a change to the port cannot
move the yardstick.
"""

from __future__ import annotations

import bisect
import subprocess
import time
from typing import Dict, List, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense rates (chip_smoke.py's constants).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
PEAKS = {"float32": F32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S, "int8": INT8_OPS_PER_S}


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time in ms: bytes over HBM bandwidth or operations over the
    peak, whichever is larger, and which of the two it was."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b: int, t: int, h: int, dh: int, dtype: str) -> Tuple[float, str]:
    """K1: q, k, v read once and o written once; 4*T*T*dh operations per
    (image, head) at the rate of the inputs' type ("f32" or "bf16")."""
    nbytes = 4 * b * t * h * dh * (4 if dtype == "f32" else 2)
    return bound(nbytes, 4 * b * h * t * t * dh,
                 F32_OPS_PER_S if dtype == "f32" else BF16_OPS_PER_S)


def sampler_bound(rows: int, vocab: int, prologue: bool, topk: bool = False) -> Tuple[float, str]:
    """K2/K3: the f32 logits read once (and K3's int8 `appears` mask and eos
    gate), the per-row settings read and the outputs written once.
    Operations per token: softmax 4, a top-p cutoff by a four-pass radix
    select 12, the Gumbel add and top-2 compare 3, K3's prologue 6, a top-k
    cutoff 12."""
    nbytes = rows * vocab * 4 + rows * 8 + rows * 12
    per_token = 4 + 12 + 3 + (12 if topk else 0)
    if prologue:
        nbytes += rows * vocab + rows * 8
        per_token += 6
    return bound(nbytes, rows * vocab * per_token, F32_OPS_PER_S)


def card() -> Dict[str, object]:
    """The first card's name (torch) and power limit in W (nvidia-smi)."""
    import torch

    out = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True)
        out["power_limit_w"] = float(res.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return out


class Spans:
    """Host spans (name, start ns, end ns) on time.perf_counter_ns, kept in
    memory. `wrap(obj, attr, name)` times every call of a method in place."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    def add(self, name: str, t0: int, t1: int) -> None:
        self.items.append((name, t0, t1))

    def wrap(self, obj, attr: str, name: str):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                self.items.append((name, t0, time.perf_counter_ns()))

        setattr(obj, attr, timed)
        return fn


MARKER_ELEMS = 7  # a float64 fill of 7 elements: nothing else on the path launches one


def launch_marker():
    """A small kernel that marks a host instant on the device's timeline:
    launched on an idle card, it starts within microseconds."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.empty(MARKER_ELEMS, dtype=torch.float64, device="cuda").fill_(1.0)
    torch.cuda.synchronize()
    return t


def reduce_trace(prof, marker_ns: int, t0_ns: int, t1_ns: int, spans: Spans, top: int = 10,
                 span_time: Tuple[str, ...] = ()) -> Dict[str, object]:
    """Busy time, device operations and named idle gaps of a CUDA-only
    torch.profiler trace over the host window [t0_ns, t1_ns]
    (time.perf_counter_ns). The marker kernel, launched on an idle card at
    marker_ns, maps the host clock onto the device's. Returns busy_s,
    window_s, device_ops [[name, s]] (the `top` names by device time),
    idle_gaps [[span name, s]] (idle device time grouped by the host span
    it fell in, longest first), kernels {name: (seconds, launches)} and
    span_device_s {span name: device seconds of the operations that started
    inside a span of that name}, for the names in `span_time`."""
    from torch.autograd import DeviceType

    events = []
    markers = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        dur = e.duration_ns()
        start = e.start_ns()
        name = e.name()
        if "double" in name and ("fill" in name.lower() or "Fill" in name):
            markers.append(start)
            continue
        if dur > 0:
            events.append((start, start + dur, name))
    if not markers:
        raise RuntimeError("found no clock marker in the trace")
    offset = markers[0] - marker_ns  # device clock minus host clock
    d0, d1 = t0_ns + offset, t1_ns + offset
    by_name: Dict[str, List[float]] = {}
    inside = []
    for s, e, name in events:
        if e <= d0 or s >= d1:
            continue
        s, e = max(s, d0), min(e, d1)
        inside.append((s, e))
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (e - s) / 1e9
        acc[1] += 1
    if not inside:
        raise RuntimeError("the trace holds no device operation inside the window")
    inside.sort()
    busy, gaps = 0, []
    cur_s, cur_e = inside[0]
    if cur_s > d0:
        gaps.append((d0, cur_s))
    for s, e in inside[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if cur_e < d1:
        gaps.append((cur_e, d1))
    # name each gap by the innermost host span holding its midpoint
    items = sorted((s + offset, e + offset, n) for n, s, e in spans.items)
    starts = [s for s, _, _ in items]
    named: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host.other"
        for j in range(i, max(i - 16, -1), -1):  # spans nest a few deep at most
            s, e, n = items[j]
            if s <= mid <= e:
                name = n
                break
        named[name] = named.get(name, 0.0) + (ge - gs) / 1e9
    span_device_s = {}
    for want in span_time:
        iv = sorted((s + offset, e + offset) for n, s, e in spans.items if n == want)
        ivs = [s for s, _ in iv]
        total = 0
        for s, e, _ in events:
            j = bisect.bisect_right(ivs, s) - 1
            if j >= 0 and s <= iv[j][1] and d0 < s < d1:
                total += e - s
        span_device_s[want] = total / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"span_device_s": span_device_s, "busy_s": busy / 1e9, "window_s": (d1 - d0) / 1e9,
            "device_ops": [[n[:120], v[0]] for n, v in ranked[:top]],
            "idle_gaps": sorted(([n, s] for n, s in named.items()), key=lambda x: -x[1])[:top],
            "kernels": {n: (v[0], v[1]) for n, v in by_name.items()}}


def kernel_mean_s(trace: Dict[str, object], fragment: str) -> Optional[float]:
    """Mean device seconds per launch of the kernels whose name holds
    `fragment`; None when the trace has none."""
    s, n = 0.0, 0
    for name, (sec, count) in trace["kernels"].items():
        if fragment in name:
            s += sec
            n += count
    return s / n if n else None


def idle_pct(rec: dict) -> Optional[float]:
    """100 x (1 - device busy / traced window), or None without a trace."""
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
