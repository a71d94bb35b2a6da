"""Folder beam captioning: clipcap_tpu_torch/cli/infer.py's `caption_pixels`
with `use_beam_search=True`, called back to back.

Set-up writes the synthetic GPT-2 vocabulary under TMPDIR and builds the
GPT-J tokenizer from it, builds the captioner bundle (CLIP ViT-B/32, the
mapper, GPT-J) in bf16 from seeded weights, makes `batches` distinct
batches of seeded pixels on the host, as a folder's loader hands them
over, and runs one call to warm up. Each call goes through
`prefix_from_pixels` (the ViT with K1, the mapper) and
`beam_search_batched` (5 beams x 67 tokens, stop ".") for `images`
images. The window starts with the first call and closes at the end of the
first call that finishes after `--seconds`; the rate is the images
captioned over that time.

The timed path's beams are read where `caption_pixels` gets them: a
wrapper around `decode.beam.beam_search_batched` keeps each call's result.
After the window the program is freed and benchmark/reference/beam.py
judges the captioned beams of the images drawn from the seed (every
distinct image, at the mix's `judge_images`).
"""

from __future__ import annotations

import gc
import importlib
import sys
import tempfile
import time

from .. import device as D
from .. import flops as F
from .. import weights as W


def build(ctx):
    """The bf16 bundle (int8 decode switched on for the control) and the
    host pixel batches."""
    import torch

    from clipcap_tpu_torch.core.config import CaptionerConfig, MapperConfig, ViTConfig
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.tokenizers.api import create_tokenizer

    cfg, mix = ctx.config, ctx.traffic
    family = importlib.import_module(f"benchmark.families.{cfg['family']}")
    lm_cfg, lm_type, lm_variant = family.program_configs(cfg)
    with tempfile.TemporaryDirectory() as vocab_dir:
        W.write_gpt2_vocab(vocab_dir)
        tokenizer = create_tokenizer(lm_type, vocab_dir)
    v = cfg["visual"]
    vit_cfg = ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"], width=v["width"],
                        layers=v["layers"], heads=v["heads"], mlp_ratio=v["mlp_ratio"],
                        output_dim=v["output_dim"], style="clip",
                        layer_norm_epsilon=v["layer_norm_epsilon"])
    cap_cfg = CaptionerConfig(lm_type=lm_type, lm_variant=lm_variant, visual_encoder_type="CLIP",
                              visual_encoder_variant=v["variant"],
                              mapper=MapperConfig(**cfg["mapper"]))
    bundle = CaptionerBundle.create(cap_cfg, lm_cfg, tokenizer, vit_cfg=vit_cfg, seed=ctx.seed,
                                    device=ctx.device, dtype=torch.bfloat16)
    state = W.make(W.captioner_layout(cfg), ctx.seed, ctx.device, torch.bfloat16)
    bundle.model.load_state_dict(state, strict=True)
    del state
    if ctx.control_bits == 8:  # the program's own int8 decode path: the control
        bundle.enable_int8_decode()
    batches = [W.pixels(mix["images"], v["image_size"], ctx.seed, b, ctx.device).cpu().numpy()
               for b in range(mix["batches"])]
    return bundle, batches


def run(ctx) -> dict:
    import torch

    from clipcap_tpu_torch.cli import infer
    from clipcap_tpu_torch.decode import beam as beam_mod

    from ..reference import beam as R

    mix, cfg = ctx.traffic, ctx.config
    on_card = ctx.device == "cuda"
    card = D.card() if on_card else {"kind": "cpu", "power_limit_w": None}
    bundle, batches = build(ctx)
    kw = dict(use_beam_search=True, beam_size=mix["beam_size"], entry_length=mix["max_new_tokens"],
              beam_image_batch=mix["images"])
    spans = D.Spans()
    captured = []
    search = beam_mod.beam_search_batched
    started = []

    def capture(*a, **k):
        t0 = time.perf_counter_ns()
        started.append(t0)
        res = search(*a, **k)
        captured.append(res)
        if ctx.trace:
            spans.add("beam.call", t0, time.perf_counter_ns())
        return res

    beam_mod.beam_search_batched = capture
    try:
        infer.caption_pixels(bundle, None, batches[0], **kw)  # warm-up
        if on_card:
            torch.cuda.synchronize()
        captured.clear()
        if ctx.trace:
            spans.wrap(bundle, "prefix_from_pixels", "encode")
        prof, marker = None, None
        if ctx.trace and on_card:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            marker = D.launch_marker()
        t0 = ctx.window_opens()
        t_end = t0 + ctx.seconds
        calls = 0
        while True:
            c0 = time.perf_counter_ns()
            infer.caption_pixels(bundle, None, batches[calls % len(batches)], **kw)
            if ctx.trace:  # the loop's device work ends at the call's copy to the host
                c1 = time.perf_counter_ns()
                spans.add("caption.call", c0, c1)
                spans.add("beam.loop", started[-1], c1)
            calls += 1
            if time.perf_counter() >= t_end:
                break
        t_close = time.perf_counter()
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
    finally:
        beam_mod.beam_search_batched = search
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    images = calls * mix["images"]
    window = t_close - t0
    rec = {"card": card, "memory_peak_bytes": memory_peak, "attempted": images, "failed": 0,
           "e2e": {"captions_per_s": images / window}, "layer": {}, "trace": None}
    print(f"window {window!r} s: {calls} calls of {mix['images']} images", file=sys.stderr)
    if ctx.trace:
        lay = rec["layer"]
        lay["model_ops"] = calls * F.beam_call_ops(cfg, mix)
        lay["window_s"] = window
        lay["peak_ops_per_s"] = D.PEAKS[cfg["peak"]]
        v = cfg["visual"]
        lay["k1_bound_ms"] = D.attention_bound(mix["images"], (v["image_size"] // v["patch_size"])
                                               ** 2 + 1, v["heads"], v["width"] // v["heads"],
                                               "bf16")[0]
        lay["beam_steps"] = mix["max_new_tokens"] - 1
        lay["calls"] = calls
        if prof is not None:
            tr = D.reduce_trace(prof, marker, int(t0 * 1e9), int(t_close * 1e9), spans,
                                span_time=("beam.loop",))
            rec["trace"] = tr
            lay["beam_device_s"] = tr["span_device_s"]["beam.loop"]

    # --- correctness: the program's outputs to the host, the program freed
    results = [{k: v.cpu() for k, v in res.items()} for res in captured]
    del bundle, captured
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = R.judge(ctx, results, calls)
    rec["verdict"] = verdict
    rec["checks"] = [("score_gap", verdict["score_gap"], ctx.limits["score_gap"])]
    print(f"judged {verdict['images_judged']} images: mean score gap "
          f"{verdict['score_gap_mean']!r}; reference {verdict['reference_s']!r} s", file=sys.stderr)
    return rec
