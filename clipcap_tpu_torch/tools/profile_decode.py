"""Phase-split timing of GPT-2 decode on the card (the port of
clipcap_tpu/tools/profile_decode.py; a development tool).

Times the prefill of a 40-token prefix alone, and the prefill followed by
`steps - 1` greedy decode steps, at one or more batch sizes, for the bf16
LM (models/gpt2.GPT2) and the int8 one (models/gpt2.GPT2Int8, quantized
from it by quantize_params). Each time is the median of three host-clock
walls that end in a device synchronize, after a warm-up call; the step
time is (full - prefill) / (steps - 1). Weights are seeded random ones.

    python -m clipcap_tpu_torch.tools.profile_decode [--variant gpt2-xl] \
        [--batches 256,512] [--steps 32] [--paths bf16,int8] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core.config import GPT2Config
from ..models.gpt2 import GPT2, quantize_params

PREFIX_LEN = 40


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, reps: int = 3) -> float:
    fn()  # warm-up: kernel builds, allocator, cuBLAS handles
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


@torch.inference_mode()
def profile(lm, lm_q8, batch: int, steps: int, paths=("bf16", "int8")) -> dict:
    """{path: prefill_ms, total_ms, per_step_ms, captions_per_sec} at `batch` rows."""
    cfg, device = lm.cfg, lm.wte.device
    total_len = PREFIX_LEN + steps
    gen = torch.Generator(device=device).manual_seed(1)
    prefix = torch.randn(batch, PREFIX_LEN, cfg.n_embd, generator=gen,
                         device=device).to(torch.bfloat16)
    out = {}
    for name, model in (("bf16", lm), ("int8", lm_q8)):
        if name not in paths:
            continue

        def prefill_only(model=model):
            cache = model.init_cache(batch, total_len)
            return model.prefill(prefix, cache)

        def full(model=model):
            logits, cache = model.prefill(prefix, model.init_cache(batch, total_len))
            tok = logits[:, -1].argmax(-1)
            for _ in range(steps - 1):
                emb = model.embed_tokens(tok)[:, None, :].to(torch.bfloat16)
                logits, cache = model.decode_step(emb, cache)
                tok = logits.argmax(-1)
            return tok

        t_prefill = _time(prefill_only, device)
        t_full = _time(full, device)
        per_step = (t_full - t_prefill) / max(steps - 1, 1)
        out[name] = dict(prefill_ms=t_prefill * 1e3, total_ms=t_full * 1e3,
                         per_step_ms=per_step * 1e3, captions_per_sec=batch / t_full)
        print(f"B={batch} {name}: prefill {t_prefill*1e3:7.1f} ms  "
              f"step {per_step*1e3:6.2f} ms  total {t_full*1e3:7.1f} ms  "
              f"-> {batch / t_full:6.1f} captions/s")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="prefill and per-step decode times of GPT-2")
    ap.add_argument("--batches", default="256,512")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--variant", default="gpt2-xl")
    ap.add_argument("--paths", default="bf16,int8", help="comma list of bf16,int8")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    paths = tuple(args.paths.split(","))
    cfg = GPT2Config.variant(args.variant)
    lm = GPT2(cfg, device=device, dtype=torch.bfloat16, seed=0).requires_grad_(False)
    lm_q8 = quantize_params(lm) if "int8" in paths else None
    return {b: profile(lm, lm_q8, b, args.steps, paths=paths)
            for b in (int(x) for x in args.batches.split(","))}


if __name__ == "__main__":
    main()
