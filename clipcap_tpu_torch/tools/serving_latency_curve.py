"""The serving latency curve on the card: captions/s and request latency
of continuous batching at several slot counts (the counterpart of the JAX
package's bench.py `_bench_serving`, whose TPU figures fill
clipcap_tpu/cli/serve.py's curve). `cli.serve --target_p50_s` picks its
slot count from the medians this tool prints
(cli/serve.LATENCY_CURVE_P50_S).

The workload is `_bench_serving`'s: GPT2-XL in int8 at all 48 layers
(models/gpt2.GPT2Int8 quantized from seeded bf16 weights: no checkpoint
ships), a pool of 2,048 seeded bf16 prefixes of 40 positions, each
request's cap drawn as clip(round(N(12, 4)), 5, 30) from
numpy's default_rng(0), max_new_tokens 67, top-p 0.8, repetition penalty
1.2, eos 50256, stop 13, the sampled step in K3 (`filter_method=
"fused_step"`), refill_size 64, steps_per_sync 8, the refill ladder
(1, 16, 64, 256) at 512 slots or more, pipeline depth 2, and "length"
admission looking ahead over every request.

For each slot count it serves the requests once to warm up (the kernels'
build, the allocator), then RUNS timed times, then once more under
torch.profiler (the card's activity only), and prints one JSON line as
soon as that slot count is measured: captions/s, p50 and p99 `latency_s`
(medians over the RUNS runs, with each run's values), occupancy,
dispatched steps, each run's wall, K3's launches a run, and the card's
name and power limit; from the profiled serve, every launch on the card
(kernels and copies, the refills' prefills included), the device's busy
time (the launches' durations summed) and its share of that serve's
wall, each also per dispatched step, and the kernels that took the most
device time.
Compare slot counts within one call: the wall moves between machines and
calls.

    python -m clipcap_tpu_torch.tools.serving_latency_curve [--slots 128,256,512] \
        [--device cuda]

`--lm_config_json` (a GPT2Config JSON) replaces GPT2-XL and `--requests`
shrinks the workload, for a run on the CPU, which profiles nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PREFIX_LEN = 40  # bench.py's PREFIX_LEN
MAX_NEW = 67  # bench.py's SERVE_MAX_NEW
EOS, STOP = 50256, 13  # bench.py's eos and stop tokens: GPT-2's "<|endoftext|>" and "."
RUNS = 3  # timed serves per slot count, after one warm-up


def card_line(device: torch.device) -> str:
    """nvidia-smi's "name, power.limit" of the first card; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def request_caps(n: int) -> np.ndarray:
    """bench.py's natural-EOS caption lengths: clip(round(N(12, 4)), 5, 30)."""
    rng = np.random.default_rng(0)
    return np.clip(np.round(rng.normal(12.0, 4.0, n)), 5, 30).astype(np.int64)


def build_lm(cfg, device: torch.device):
    """GPT2Int8 quantized from a GPT-2 seeded in bf16 on `device`."""
    from ..models.gpt2 import GPT2, quantize_params

    float_lm = GPT2(cfg, device=device, dtype=torch.bfloat16, seed=0)
    lm = quantize_params(float_lm)
    del float_lm
    return lm


def profile_serve(serve, top: int = 6) -> dict:
    """One serve under torch.profiler (CUDA activity only): its launches on
    the card, their summed device time, the serve's wall under the
    profiler, and the `top` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}  # from the raw events: key_averages() is slow at this count
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    if not by_name:
        raise RuntimeError("the profiler recorded no launch on the card")
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"launches": sum(n for _, n in by_name.values()), "busy_ms": busy_ms,
            "profiled_wall_ms": wall_ms, "busy_share": busy_ms / wall_ms,
            "top_kernels": [{"name": name[:80], "ms": ms, "launches": n}
                            for name, (ms, n) in ranked]}


def measure(lm, cfg, slots: int, pool: torch.Tensor, caps: np.ndarray) -> dict:
    """One warm-up serve, RUNS timed ones and, on the card, a profiled one
    at `slots` slots."""
    from ..decode.engine import GenerationSettings
    from ..decode.serving import Request, ServingEngine
    from ..ops.kernels.fused_sampler import LAUNCHES

    settings = GenerationSettings(max_new_tokens=MAX_NEW, top_p=0.8, repetition_penalty=1.2,
                                  eos_token_id=EOS, stop_token_id=STOP,
                                  filter_method="fused_step")
    eng = ServingEngine(lm, cfg, prefix_len=PREFIX_LEN, settings=settings, slots=slots,
                        refill_size=min(64, slots), steps_per_sync=8,
                        refill_sizes=(1, 16, 64, 256) if slots >= 512 else None,
                        pipeline_depth=2, dtype=torch.bfloat16, device=pool.device)
    reqs = [Request(i, i, max_length=int(c)) for i, c in enumerate(caps)]
    n = len(reqs)

    def serve():
        return eng.serve(reqs, seed=0, prefix_pool=pool, admission="length",
                         admission_lookahead=n)

    serve()  # warm-up
    walls, rates, p50s, p99s, occupancy, steps, k3 = [], [], [], [], [], [], []
    for _ in range(RUNS):
        launches = LAUNCHES["fused_step_sample"]
        t0 = time.perf_counter()
        res = serve()
        wall = time.perf_counter() - t0
        if len(res) != n:
            raise RuntimeError(f"{len(res)} of {n} requests answered at {slots} slots")
        launched = LAUNCHES["fused_step_sample"] - launches
        if pool.is_cuda and launched != eng.last_stats["steps"]:
            raise RuntimeError(f"K3 launched {launched} times over {eng.last_stats['steps']} "
                               f"dispatched steps at {slots} slots")
        lat = np.asarray([r["latency_s"] for r in res.values()])
        walls.append(wall)
        rates.append(n / wall)
        p50s.append(float(np.percentile(lat, 50)))
        p99s.append(float(np.percentile(lat, 99)))
        occupancy.append(eng.last_stats["occupancy"])
        steps.append(eng.last_stats["steps"])
        k3.append(launched)
    line = {"slots": slots,
            "captions_per_s": statistics.median(rates), "captions_per_s_runs": rates,
            "latency_p50_s": statistics.median(p50s), "latency_p50_s_runs": p50s,
            "latency_p99_s": statistics.median(p99s), "latency_p99_s_runs": p99s,
            "occupancy": statistics.median(occupancy), "steps": statistics.median(steps),
            "wall_s_runs": walls, "k3_launches_runs": k3, "requests": n,
            "mean_cap": float(caps.mean()), "ring_len": eng.ring_len}
    if pool.is_cuda:
        prof = profile_serve(serve)
        per = eng.last_stats["steps"]
        line.update(prof, launches_per_step=prof["launches"] / per,
                    device_ms_per_step=prof["busy_ms"] / per,
                    profiled_wall_ms_per_step=prof["profiled_wall_ms"] / per)
    return line


def main(argv=None) -> list:
    from ..core.config import GPT2Config

    p = argparse.ArgumentParser(description="serving latency curve at several slot counts")
    p.add_argument("--slots", default="128,256,512", help="comma-separated slot counts")
    p.add_argument("--lm_config_json", default=None, help="a GPT2Config JSON for GPT2-XL")
    p.add_argument("--requests", type=int, default=2048)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a run on the CPU")

    cfg = (GPT2Config.from_json(Path(args.lm_config_json).read_text()) if args.lm_config_json
           else GPT2Config.variant("gpt2-xl"))
    card = card_line(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        lm = build_lm(cfg, device)
        gen = torch.Generator(device=device).manual_seed(5)
        pool = torch.randn(args.requests, PREFIX_LEN, cfg.n_embd, generator=gen,
                           device=device).to(torch.bfloat16)
        caps = request_caps(args.requests)
        lines = []
        for slots in (int(s) for s in args.slots.split(",")):
            line = measure(lm, cfg, slots, pool, caps)
            line.update(layers=cfg.n_layer, n_embd=cfg.n_embd, card=card, device=str(device))
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
