"""Where the time of one train step goes on the card.

    python -m clipcap_tpu_torch.tools.profile_train_step [--path prefix|pixels|train_visual]

Builds chip_smoke.py's training configuration at full width (the CLI's
default mapper with a 512-wide prefix, GPT-2 124M, and for the pixel paths
CLIP ViT-B/32 at 224 px, frozen or trained; seeded random weights, batch
16 of seeded tokens, bf16 compute, remat, AutoClip), warms the step up,
and prints:
- the wall time of a step (the mean over 5, between synchronizations) and
  the card's name and power limit;
- every call that synchronizes the host with the device inside one step
  (torch.cuda.set_sync_debug_mode), with where it was made;
- a profile of one step recording host and device activity: the host
  operators by their own host time, the device's busy time and the
  number of kernel launches.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import subprocess
import time
import warnings


def build_step(path: str, device: str = "cuda"):
    """(step, state, batch) of the chosen path at chip_smoke's widths."""
    import torch

    from ..core.config import (CaptionerConfig, GPT2Config, MapperConfig, TrainConfig,
                               ViTConfig)
    from ..train import train_step as TTS

    vit_cfg = None if path == "prefix" else ViTConfig.clip_variant("ViT-B/32")
    mapper = MapperConfig(dim_clip=512, dim_embedding=768, clip_length=50,
                          use_all_features=vit_cfg is not None)
    cap_cfg = CaptionerConfig(visual_encoder_type="none" if vit_cfg is None else "CLIP",
                              visual_encoder_variant="ViT-B/32", mapper=mapper,
                              train_visual_encoder=path == "train_visual")
    lm_cfg = GPT2Config.variant("gpt2")
    train_cfg = TrainConfig(total_steps=1000, weight_decay=0.01)
    state, tx = TTS.create_train_state(0, cap_cfg, lm_cfg, train_cfg, vit_cfg=vit_cfg,
                                       device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(1, 50256, (16, 40), generator=gen, device=device)
    tokens[:, 30:] = -1
    batch = {"tokens": tokens}
    if vit_cfg is None:
        batch["prefix"] = torch.randn(16, 512, generator=gen, device=device)
    else:
        batch["pixels"] = torch.randn(16, 3, 224, 224, generator=gen, device=device)
    return TTS.make_train_step(cap_cfg, lm_cfg, train_cfg, tx, visual_cfg=vit_cfg), state, batch


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--path", default="prefix", choices=["prefix", "pixels", "train_visual"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step runs on the card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    step, state, batch = build_step(args.path)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"{card}: {args.path} train step, batch 16: {wall_ms:.1f} ms", flush=True)

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = step(state, batch)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    print(f"synchronizing calls in one step: {len(syncs)}", flush=True)
    for line in syncs[:20]:
        print("  ", line)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    print(f"profiled step: {prof_ms:.1f} ms wall, {sum(e.count for e in device)} kernel launches, "
          f"device busy {busy_ms:.1f} ms", flush=True)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in host) / 1e3
    print(f"host operators, own time {total:.1f} ms in all; the top 25:")
    for e in host[:25]:
        print(f"  {e.key[:60]:60s} {e.self_cpu_time_total / 1e3:8.2f} ms  x{e.count}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
