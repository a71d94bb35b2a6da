#!/usr/bin/env python3
"""Drive the PyTorch port's captioning, serving, evaluation, preprocessing,
Gen-B synthesis, serving and apps, training and parallel paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--xl_layers N] [--gptj_layers N] [--t0_layers N]

From the root of the repository, on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. It

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel from csrc/ (one nvcc per source, in parallel) and
   prints the build time and ptxas's registers and spills;
3. holds each kernel (K1 attention, K2/K3 sampler, K4 filter) against its
   plain PyTorch version on the card at the paths' shapes (stated
   tolerances; K1 also on views of one packed qkv projection, as the ViT
   block hands it) and takes the device time (torch.profiler) of the
   kernel, the plain version, and the one PyTorch library call that
   computes the same function where there is one (SDPA for attention),
   beside the least time the card could take (the bound); K1 also at the
   encoders' batches of 1, 8 and 64 images, L2-cold, and in bf16 at the
   main shape, at T=577 and at 1, 8 and 16 images, and K1's gradient (the
   autograd Function: the kernel's forward, the plain-torch backward)
   against autograd through the plain version at B=16, T=50 and T=577 in
   f32 and bf16, with the backward's device time beside the forward's and
   SDPA's backward; K2/K3/K4 at 1, 8, 9,
   16, 64, 72 and 512 rows of V=50257
   (every cluster size the launcher picks, and each path's rows), on
   hard rows (ties, all equal, -inf columns, top-p near 0 and 1), with
   top-p within ~1e-7 of a cumulative mass (the kept sets may differ by
   the tie token: the disagreement is bounded), for
   bit-identical repeats and Philox draws inside the kept set, and timed
   at 8, 16, 64, 72 and 512 rows with the cluster size used;
4. drives the main path at full width — CLIP ViT-B/32 at 224 px, the default
   ClipCap mapper, GPT-2 124M, seeded random f32 weights — through
   CaptionerBundle.encode_image, greedy generate, NoBeamCaptionSampler and a
   "fused_step" generate, with every launch counter set to 0 just before and
   read just after; checks the outputs against the same port on the CPU;
5. drives the serving path on the same model: ServingEngine.serve over 256
   requests on 64 slots, greedy, "fused" and "fused_step", with the launch
   counters set to 0 just before and read just after; checks greedy
   requests against their solo generate and one sampler launch per
   dispatched step;
6. drives the infer path (cli/infer.py) on the same model: writes it with
   the port's checkpoint writer and a seeded OpenAI-layout CLIP ViT-B/32
   state dict with torch.save, reads both back onto the card through the
   port's loaders (every parameter equal to what was written), then runs
   cli.infer.main on 64 seeded JPEGs by beam search (64 images x beam 5 x
   67 tokens, one chunk of 320 rows) and on 8 by the no-beam top-p sweep,
   with the launch counters set to 0 just before and read just after;
   checks K1 per encoder call, K2 per decode step, one finite-scored JSON
   entry per image, and the best beams of two images against the CPU;
   times and profiles the beam call; then cli.serve --target_p50_s on the
   checkpoint picks its slot count from the stored H100 curve (f5);
7. drives the evaluate path (cli/evaluate.py) on the same checkpoint and on
   the model cast to bf16, written by the port's writer and read back bit
   for bit: cli.evaluate.main over 16 seeded JPEGs with 5 captions each in
   chunks of 8 (the no-beam sweep, the CLIP-guided tree, CLIP scores, the
   validation loss), with the launch counters set to 0 just before and read
   just after; checks K1 per encoder call (bf16 in the bf16 captioner), K2
   per no-beam decode step, finite scores, the first chunk's loss and two
   images' CLIP-guided captions against the CPU, and the bf16 loss near
   f32's; times and profiles a CLIP-guided chunk and a validator chunk per
   dtype, and the main path's sampler call on the bf16 model;
8. drives the training path (cli/train.py) at full width (CLIP ViT-B/32,
   the CLI's default mapper with --prefix_size 512, GPT-2 124M, batch 16,
   bf16 compute, remat, AutoClip): 12 steps on seeded prefix shards in two
   files, a resume from the step-7 checkpoint, 12 prefix-only steps, a
   resume from the committed train state the JAX package saved (h3: on
   the card and on the CPU, losses held within CARD_VS_CPU); then
   (g)'s COCO folder with (f)'s CLIP ViT-B/32, 3 steps and one validation,
   and 2 steps with --train_visual_encoder, with the launch counters set to
   0 just before these two runs and read just after; checks finite losses,
   the metrics lines, the final checkpoint read back bit for bit, the
   resumed step's loss, the frozen parts unchanged and the trained ones
   moved, K1 per step and K2 in the validation; times and profiles a step
   of each path, and holds one f32 step against the CPU and the bf16 loss
   against f32's;
9. drives int8 decode (phase (i), run before (h)): the int8 products
   (torch._int_mm at every GPT2-XL linear shape and the paths' rows, the
   f32 attention dots on int8 values) against exact CPU products; a
   GPT2-XL captioner (full width, 4 of its 48 layers since phase (o) came,
   8 since (m), 12 before, for the run's time; --xl_layers 48 runs it
   whole) seeded on the card in
   bf16 and quantized by bundle.enable_int8_decode() (every q and s against
   the CPU's, prefill logits within 16 bf16 steps); the no-beam sweep on
   the bf16 and the int8 LM (device ms and launches per step, busy share, captions/s);
   int8 beam search at 64 images x beam 5 x 67 tokens through the
   shared-prefix cache, its step bit-equal to the replicated cache's;
   int8 serving of 256 requests on 64 slots, greedy and "fused_step"; the
   int8 ViT-B/32 at B=64 (K1 12 a call, cosine to the float encode above
   0.995); cli.infer, cli.serve and cli.evaluate with --int8_decode on
   (f)'s checkpoint, the best beams of 2 images against the CPU;
10. drives GPT-J-6B (phase (j), after (i), before (h)): K2/K3/K4 against
   their plain versions at its vocabulary of 50400 (9, 16, 64, 72 and 512
   rows, every cluster size there); the captioner (CLIP ViT-B/32, the
   mapper at 4096, GPT-J-6B: 2 of its 28 layers since phase (o) came, 4
   since (m), 8 before, for the run's time, --gptj_layers 28 for all; 16
   heads of 256) seeded on the
   card in bf16, a 2-layer cut held against the CPU (logits, the int8
   quantization); the no-beam sweep, beam search and serving in bf16 and
   in int8; speculative greedy decode with the model as its own draft and
   with the GPT-2 124M captioner as a draft; the three CLIs on a 2-layer
   GPT-J checkpoint, with and without --int8_decode; and (j6) prefix-only
   training over GPT-J-6B at all 28 layers frozen in int8 (BASELINE config #4: a 2-layer
   transformer mapper at 4096, batch 16, lm_apply=apply_q8), the int8 LM
   bit-identical after the steps, a 2-layer cut's loss against the CPU;
11. drives T0-11B (phase (k), after (j), before (m)): K2/K3/K4 against
   their plain versions at T0's vocabulary of 32128; the captioner (CLIP
   ViT-B/32, the mapper at 4096, T5Config.variant("t0-11b") at 2 + 2 of
   its 24 + 24 layers since phase (o) came (6 + 6 since (n), 8 + 8 since
   (m)), for the run's time, --t0_layers 24 for all; 64 heads of 64, d_ff
   10240, gated-gelu, untied
   lm_head) seeded
   on the card in bf16 and driven by token ids, K1 in a bf16 and an f32
   encode, a 2 + 2-layer cut held against the CPU (buckets, logits, the
   int8 quantization, greedy tokens); greedy decode at batch 64, the
   no-beam sweep, beam search at 320 rows (160 in int8, for the run's
   time) and serving (256 requests on 64 slots, greedy and "fused_step")
   in bf16 and in int8; cli.infer and
   cli.serve on a 2 + 2-layer T0 checkpoint with a tokenizer.json that
   the `tokenizers` package writes; each figure as a JSON line when it is
   measured;
12. drives dataset preprocessing (phase (l), after (g), before (i)):
   writes 2,048 seeded JPEGs (200-640 px, quality 90) with 5-30-word
   captions in two webdataset tars, a GPT-2 vocabulary and OpenAI-layout
   ViT-B/32 and ViT-L/14 state dicts; (l1) times the host's JPEG decode
   alone (native libjpeg at 1 and all cores, PIL beside it) and stages
   the pixels on the card through data/pipeline.device_prefetch; (l2) times the
   encoders alone on uint8 pixels already on the card (ViT-B/32 f32 and
   int8 at batch 256 and 1024, ViT-L/14 at 256; K1 once a layer per
   encode); (l3) runs `python -m clipcap_tpu_torch.tools.preprocess`'s
   main end to end from the tars (ViT-B/32 f32 at 256 and 1024, int8 at
   1024, ViT-L/14 at 256 over 512 images) with the launch counters set to
   0 just before each run and read just after, and profiles a rerun for
   the device's busy share; checks both shard readers' batches equal, the
   first 64 token rows equal a CPU run's and their prefixes within 1e-3 of
   it, the int8 prefixes within (i5)'s cosine bound of the f32 ones; and
   holds K1 against its plain version at the encoders' shapes
   [1024, 50, 12, 64], [256, 50, 12, 64] and [256, 257, 16, 64] f32;
13. drives Gen-B caption synthesis (phase (m), after (k), before (h)):
   writes seeded weights in their published layouts (a BLIP captioner in
   HF's BlipForConditionalGeneration layout: ViT-L/16 at 384 px and the
   text decoder at bert-base width, vocabulary 30524; a BLIP retrieval
   model: ViT-B/16 at 384 px, the text encoder, ITM and ITC heads;
   OpenAI-layout CLIP ViT-L/14 and RN50x64 at 448 px in fp16; a 30524-line
   vocab.txt) and loads them through cli.loading; (m1) holds K1 at
   [1, 577, 16, 64], [1, 577, 12, 64] and [1, 257, 16, 64] f32 and K2 at
   [40, 30524] (top-k 2500, the grid's per-row top-p, after a 1.3
   penalty) against their plain versions; (m2a) the text decoder's 2-layer
   cut against the CPU (logits, sampled tokens with injected noise); (m2)
   SynthesisEngine.synthesize of 40 candidates for one image with the
   default grids in f32 and (m4) SynthesisEngine.rank in all five modes,
   with the launch counters set to 0 just before and read just after
   (K1 once a layer per encode, K2 once a step), the rankers' scores
   against the CPU; (m3) enable_int8_decode (q and s equal the CPU's, the
   logits within 16 bf16 steps of f32's) and an int8 synthesis; per-step
   device ms, launches and busy share of both; (m5) `python -m
   clipcap_tpu_torch.cli.caption_me --mode CLIP-ViT-L` from the files;
14. drives the rest of Gen B (phase (n), right after (m), on (m)'s files
   and modules): (n1) K3 and K2 at BLIP serving's [64, 30524] (top-k 2500,
   top-p 0.5, penalty 1.3, min-length gate, eos [SEP]) against their plain
   versions, timed, and K1 at [16, 577, 16, 64] against its plain
   version; (n2) the BLIP captioner behind ServingEngine
   (serving_decoder_lm, token ids): 16 images encoded on the card (K1 at
   [16, 577, 16, 64]), 128 requests with the default grid's caps on 64
   slots, greedy, "fused" (K2) and "fused_step" (K3) with Gen B's knobs,
   the launch counters set to 0 before the encode and read after the
   serves; greedy requests against their solo decoder_lm runs, a
   no-refill "fused_step" serve against generate(seed), the 2-layer cut's
   ring steps against the CPU, one K2/K3 launch a dispatched step, and a
   ring step's device time split by op and input shape; (n3) BLIP beam
   search, 8 images x beam 3 x 30 tokens, the cut's best beams against the
   CPU's; (n4) cli.sweep.main over configs/sweep_bayes_01.yaml's space
   with its mode pinned to CLIP-ViT-L (2 trials, 4 images), (n5)
   cli.human_eval.main's plain packet and the multi-filter one through
   prepare_human_eval with the retrieval model as BLIP ranker, (n6) Gumbel
   caption optimization on the retrieval model (one step against the CPU,
   50 steps timed), the counters set to 0 before (n4) and read after (n6);
   then K2 against its plain version at each sweep trial's shape;
15. drives the parallel paths under NCCL at world size 1 (phase (o),
   core.mesh.init_distributed with a file:// rendezvous, after (i); each
   part on the handles of the phase it follows): (o2) after (i), DP decode
   of (i)'s int8 GPT2-XL; (o4) after (j), enable_tensor_parallel(1) on
   (j)'s GPT-J-6B, the logits bit for bit, K2 at [72, 50400]; (o7) after
   (n), the ring-attention ViT on (m)'s BLIP ViT-L/16 at 384 px against
   K1's forward; after (h): (o5) torchrun cli.train --zero_shard_params on
   (h)'s shards, (o1) DP decode and (o3) DP serving on the main bundle,
   (o6) the GPipe step, (o8) the expert-parallel MoE mapper, (o9)
   tools/dryrun_multichip's drive; every result equal to the unsharded path's, the
   device ms, launches and NCCL kernels per step printed plain and
   parallel; K2/K3 also launched with row_base (a data-parallel shard's
   first row) in the sampler checks;
16. prints one JSON line of kernels, the card line, and last
   {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line is
printed. Without a CUDA card, or without the repository around it, the
script exits non-zero at once. It needs no network and imports no JAX.
"""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s
# and f32 operations/s outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# K1 tolerances: f32 as tests/test_pallas_attention.py; bf16 one bf16 ulp of
# the output plus the kernel rounding its unnormalised probabilities to bf16
# where the plain version rounds the normalised ones
K1_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
SAMPLER_RTOL = 1e-5
# card against the same port on the CPU (f32, TF32 off): summation order only
CARD_VS_CPU = (1e-3, 1e-3)
FLIP_GAP = 1e-4  # a greedy token may differ only where the CPU top-2 gap is below this
TOP_P_SWEEP = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]  # cli/infer.py:97-98


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def say(*args) -> None:
    print(*args, flush=True)


def figure_line(card: str, label: str, figures: dict) -> None:
    """One JSON line of measured figures, printed as soon as they are
    measured, with the card's name and power limit."""
    say(json.dumps({"figure": label, "card": card, **figures}))


class IdTokenizer:
    """GPT-2's special ids without a vocabulary file: captions are printed
    as token ids (no GPT-2 vocabulary ships with the repository)."""

    bos_token_id = 50256
    all_special_ids = [50256]

    def encode_text(self, text: str):
        if text != ".":
            raise SmokeError(f"IdTokenizer knows only '.', not {text!r}")
        return [13]  # GPT-2's id of "."

    def decode_tokens(self, ids):
        return " ".join(str(int(i)) for i in ids)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Wall time of one call of `fn` (CUDA events over `iters` calls after a
    warm-up): the device time, or the host's where the host is slower."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, kernel: str | None = None,
              skip: str | None = None) -> float:
    """Device time of one call of `fn`: the CUDA kernels it launches, summed
    (torch.profiler, CUPTI), averaged over `iters` calls after a warm-up,
    with no host time in it. With `kernel`, only the kernels whose name holds
    that word, per launch; with `skip`, all but those whose name holds that
    word, per call. Raises if the profiler recorded no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):  # a profiler run now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0 and (kernel is None or kernel in e.key)
                  and (skip is None or skip not in e.key)]
        if events:
            break
    check(bool(events), f"the profiler recorded no {kernel or 'CUDA'} kernel")
    total_ms = sum(e.self_device_time_total for e in events) / 1e3
    return total_ms / (sum(e.count for e in events) if kernel else iters)


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(torch, got, want, atol: float, rtol: float, what: str) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements off, max abs err "
          f"{float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    return float(err.max())


# --- 3. kernels against their plain versions -----------------------------------------


def packed_qkv(torch, gen, b, t, h, dh, dtype):
    """q, k, v as the ViT block hands them to K1: [B, T, H, dh] views of one
    packed [B, T, 3*H*dh] projection (token stride 3*H*dh), not copies."""
    qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(dtype)
    return tuple(y.reshape(b, t, h, dh) for y in qkv.chunk(3, dim=-1))


def attention_bound(b, t, h, dh, dtype):
    """q, k, v read once and o written once; 4*T*T*dh operations per (image,
    head) at the rate of the inputs' type (f32 outside the tensor cores)."""
    nbytes = 4 * b * t * h * dh * (4 if dtype == "f32" else 2)
    return bound(nbytes, 4 * b * h * t * t * dh, F32_OPS_PER_S if dtype == "f32"
                 else BF16_OPS_PER_S)


def check_attention(torch, FA):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    shapes = [(50, 12, 64), (257, 16, 64), (577, 12, 64), (50, 8, 128)]
    for (t, h, dh) in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            atol, rtol = K1_TOL[name]
            q, k, v = (torch.randn(8, t, h, dh, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            got = FA.fused_attention(q, k, v)
            torch.cuda.synchronize()
            err = assert_close(torch, got, FA.fused_attention_plain(q, k, v), atol, rtol,
                               f"K1 B=8 T={t} H={h} dh={dh} {dtype}")
            worst[name] = max(worst[name], err)
            say(f"K1 B=8 T={t} H={h} dh={dh} {name}: max abs err {err:.3e} "
                f"(atol {atol}, rtol {rtol})")
            # the same on views of one packed qkv projection, read in place
            q, k, v = packed_qkv(torch, gen, 4, t, h, dh, dtype)
            got = FA.fused_attention(q, k, v)
            torch.cuda.synchronize()
            check(got.is_contiguous(), "K1 output on packed views is not contiguous")
            err = assert_close(torch, got, FA.fused_attention_plain(
                q.contiguous(), k.contiguous(), v.contiguous()), atol, rtol,
                f"K1 packed qkv B=4 T={t} H={h} dh={dh} {dtype}")
            worst[name] = max(worst[name], err)
            say(f"K1 packed qkv views B=4 T={t} H={h} dh={dh} {name}: max abs err {err:.3e}")
    # the batches the paths' ViT-B/32 encoders hand K1: one image (the no-beam
    # infer call and the evaluate path's per-image scores, both encoders), 8
    # (an evaluate chunk: the captioner in f32 or bf16, the scorer in f32) and
    # 64 (the main path, a beam chunk); bf16 at 16 images too
    for dtype, batches in ((torch.float32, (1, 8, 64)), (torch.bfloat16, (1, 8, 16))):
        name = str(dtype).split(".")[1]
        for b in batches:
            q, k, v = packed_qkv(torch, gen, b, 50, 12, 64, dtype)
            got = FA.fused_attention(q, k, v)
            torch.cuda.synchronize()
            err = assert_close(torch, got, FA.fused_attention_plain(
                q.contiguous(), k.contiguous(), v.contiguous()), *K1_TOL[name],
                f"K1 packed qkv B={b} T=50 H=12 dh=64 {name}")
            worst[name] = max(worst[name], err)
            say(f"K1 packed qkv views B={b} T=50 H=12 dh=64 {name}: max abs err {err:.3e}")

    def sdpa(q, k, v):
        return lambda: F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)))

    # the main path's shape: ViT-B/32 encode of 64 images, f32 views of the packed qkv
    b, t, h, dh = 64, 50, 12, 64
    q, k, v = packed_qkv(torch, gen, b, t, h, dh, torch.float32)
    ms = device_ms(torch, lambda: FA.fused_attention(q, k, v), kernel="attn_kernel")
    plain_ms = device_ms(torch, lambda: FA.fused_attention_plain(q, k, v))
    library_ms = device_ms(torch, sdpa(q, k, v))
    wall_ms = time_ms(torch, lambda: FA.fused_attention(q, k, v))
    bound_ms, bound_by = attention_bound(b, t, h, dh, "f32")
    # L2-cold: a 128 MiB write between launches evicts q, k, v (39.3 MB fit
    # in the 50 MB L2); the fill's own kernel is left out of both times
    flush = torch.empty(1 << 25, device="cuda")

    def cold(fn):
        def run():
            flush.fill_(1.0)
            fn()
        return run

    cold_ms = device_ms(torch, cold(lambda: FA.fused_attention(q, k, v)), kernel="attn_kernel")
    library_cold_ms = device_ms(torch, cold(sdpa(q, k, v)), skip="FillFunctor")
    del flush
    say(f"K1 B={b} T={t} H={h} dh={dh} f32 packed qkv (device ms): kernel {ms:.4f}, plain "
        f"{plain_ms:.4f}, SDPA {library_ms:.4f}, bound {bound_ms:.4f} ({bound_by}); L2-cold: "
        f"kernel {cold_ms:.4f}, SDPA {library_cold_ms:.4f}; wrapper wall {wall_ms:.4f}")
    out = dict(max_abs_err=worst["float32"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms, max_abs_err_bf16=worst["bfloat16"],
               cold_ms=cold_ms, library_cold_ms=library_cold_ms)
    # bf16 at the main shape, at BLIP's T=577, and at the evaluate path's 8
    # and 16 images
    for key, bb, t in (("bf16", b, 50), ("bf16_t577", b, 577), ("bf16_b8", 8, 50),
                       ("bf16_b16", 16, 50)):
        q, k, v = packed_qkv(torch, gen, bb, t, h, dh, torch.bfloat16)
        kms = device_ms(torch, lambda: FA.fused_attention(q, k, v), kernel="attn_kernel")
        pms = device_ms(torch, lambda: FA.fused_attention_plain(q, k, v), 5)
        lms = device_ms(torch, sdpa(q, k, v))
        bms, bby = attention_bound(bb, t, h, dh, "bf16")
        say(f"K1 B={bb} T={t} H={h} dh={dh} bf16 packed qkv (device ms): kernel {kms:.4f}, "
            f"plain {pms:.4f}, SDPA {lms:.4f}, bound {bms:.4f} ({bby})")
        out[key] = dict(shape=[bb, t, h, dh], ms=kms, plain_ms=pms, library_ms=lms,
                        bound_ms=bms, bound_by=bby)
    return out


# K1's backward (plain torch ops, as XLA differentiates the TPU kernel):
# against autograd through the plain forward, the same operations in
# another order; f32 at the forward's budget, bf16 one bf16 step
K1_GRAD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
K1_GRAD_SHAPES = [(16, 50), (16, 577)]  # (h)'s batch: ViT-B/32, and BLIP ViT-B at 384 px


def attention_backward_bound(b, t, h, dh, dtype):
    """q, k, v and dO read once, dq, dk and dv written once; 10*T*T*dh
    operations per (image, head): the scores recomputed, dP, dV, dQ, dK."""
    nbytes = 7 * b * t * h * dh * (4 if dtype == "f32" else 2)
    return bound(nbytes, 10 * b * h * t * t * dh, F32_OPS_PER_S if dtype == "f32"
                 else BF16_OPS_PER_S)


def check_attention_grad(torch, FA):
    """K1's gradient on packed-qkv views at (h)'s shapes: the Function's
    output carries a grad_fn, and its dq, dk, dv (the kernel's forward, the
    plain backward) equal autograd through fused_attention_plain within
    K1_GRAD_TOL; then the device times of the backward beside the kernel's
    forward and SDPA's backward on the same inputs."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    h, dh = 12, 64
    out = {}
    for b, t in K1_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(dtype)
            q, k, v = (y.reshape(b, t, h, dh).requires_grad_()
                       for y in qkv.chunk(3, dim=-1))
            dout = torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype)
            o = FA.fused_attention(q, k, v)
            check(o.grad_fn is not None, "K1's output on CUDA has no grad_fn")
            got = torch.autograd.grad(o, (q, k, v), dout)
            want = torch.autograd.grad(FA.fused_attention_plain(q, k, v), (q, k, v), dout)
            errs = [assert_close(torch, g, w, *K1_GRAD_TOL[name],
                                 f"K1 backward d{n} B={b} T={t} {name}")
                    for n, g, w in zip("qkv", got, want)]
            qd, kd, vd = (x.detach() for x in (q, k, v))
            fwd_ms = device_ms(torch, lambda: FA.fused_attention(qd, kd, vd), kernel="attn_kernel")
            bwd_ms = device_ms(torch, lambda: FA.fused_attention_backward_plain(qd, kd, vd, dout),
                               5)
            qs, ks, vs = (x.transpose(1, 2).requires_grad_() for x in (qd, kd, vd))
            so = F.scaled_dot_product_attention(qs, ks, vs)
            dso = dout.transpose(1, 2)
            lib_ms = device_ms(torch, lambda: torch.autograd.grad(so, (qs, ks, vs), dso,
                                                                  retain_graph=True))
            bms, bby = attention_backward_bound(b, t, h, dh, "f32" if name == "float32" else "bf16")
            key = f"{name}_t{t}"
            out[key] = dict(shape=[b, t, h, dh], max_abs_err=max(errs), backward_ms=bwd_ms,
                            forward_ms=fwd_ms, library_backward_ms=lib_ms, bound_ms=bms,
                            bound_by=bby)
            say(f"K1 backward B={b} T={t} H={h} dh={dh} {name} (packed qkv views): dq/dk/dv max "
                f"abs err {max(errs):.3e} (atol/rtol {K1_GRAD_TOL[name][0]}); device ms: "
                f"backward {bwd_ms:.4f} (plain torch) beside the kernel's forward {fwd_ms:.4f}, "
                f"SDPA backward {lib_ms:.4f}, bound {bms:.4f} ({bby})")
            del qkv, q, k, v, dout, o, got, want, so
    return out


def sampler_bound(rows: int, vocab: int, prologue: bool, topk: bool = False):
    """The least time of the top-p filter + sampler at [rows, vocab] (the
    main path's flags: no top-k). Bytes: the f32 logits read once (and the
    int8 `appears` mask and eos gate for the prologue), the per-row settings
    read and the outputs written once. Operations the function needs per
    token, not the design's 28-step bisection: max, exp and sum for the
    softmax (4); the top-p cutoff by a radix select of the f32 keys in four
    8-bit passes, a shift, mask and mass add each (12); the Gumbel add and a
    top-2 compare (3); the prologue's logsumexp, penalty and temperature (6);
    with `topk` (Gen B's top-k 2500), the top-k cutoff's radix select (12)."""
    nbytes = rows * vocab * 4 + rows * 8 + rows * 12
    per_token = 4 + 12 + 3 + (12 if topk else 0)
    if prologue:
        nbytes += rows * vocab + rows * 8
        per_token += 6
    return bound(nbytes, rows * vocab * per_token, F32_OPS_PER_S)


def filter_bound(rows: int, vocab: int):
    """K4: the f32 logits read once and the filtered row written once, plus
    the per-row settings; operations per token: max, a top-k and a top-p
    cutoff by four-pass radix selects (12 each), the softmax (4)."""
    return bound(2 * rows * vocab * 4 + rows * 8, rows * vocab * (1 + 12 + 12 + 4),
                 F32_OPS_PER_S)


# every cluster size the launcher picks at V=50257, and the rows each path
# hands K2: the no-beam infer call's 9, the evaluate chunk's 16 (8 images x
# 2 top-p), the main path's 72
SAMPLER_ROWS = [1, 8, 9, 16, 64, 72, 512]
TIMED_ROWS = [8, 16, 64, 72, 512]
# GPT-J's vocabulary of 50400 at the GPT-J path's rows: --no_beam's 9, the
# evaluate chunk's 16, serving's 64 slots, the sweep's 72, and 512 (one
# block per row, the widest row a block holds)
GPTJ_VOCAB, GPTJ_SAMPLER_ROWS = 50400, [9, 16, 64, 72, 512]
HARD_KK = [1.0, 40.0]  # and the whole vocabulary
HARD_PP = [0.0, 1e-4, 0.5, 0.999, 1.0]
TIE_MARGIN = 1e-5  # hard rows keep top-p this far (relative) from every cumulative mass


def sampler_inputs(torch, S, rows, vocab, seed):
    """Seeded logits (N(0, 9)), the top-p sweep and top-k 0/40 on alternate
    rows, injected Gumbel noise, a 24-token history mask, and the eos gate on
    even rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, vocab, generator=gen, device="cuda") * 3
    top_p = torch.tensor(TOP_P_SWEEP, device="cuda").repeat(rows // 9 + 1)[:rows].contiguous()
    top_k = torch.tensor([0.0, 40.0], device="cuda").repeat(rows // 2 + 1)[:rows].contiguous()
    noise = S.gumbel_like(x, gen)
    hist = torch.randint(0, vocab, (rows, 24), generator=gen, device="cuda")
    appears = S.token_occurrence_mask(hist, vocab)
    suppress = torch.arange(rows, device="cuda") % 2 == 0
    return x, top_k, top_p, noise, appears, suppress


def hard_rows(torch, FS, vocab):
    """Rows where the cutoffs are hard: logits quantised to 0.25 (many
    ties), all equal, N(0, 100) with -inf columns, and a narrow quantised row,
    each under every top-k in HARD_KK and top-p in HARD_PP. Each top-p is
    moved down (by 3e-5 relative steps) until it lies more than TIE_MARGIN
    from every cumulative mass of its top-k-filtered row (f64 on the host),
    so the summation order cannot decide a cutoff; the mass of the whole
    row is exempt where every finite value lies within 100 of the max (both
    outcomes keep the same set there, as at top-p 1.0)."""
    import numpy as np

    rng = np.random.default_rng(8)
    # N(0, 100) with -inf columns: wide enough that top-p 0.999 falls between
    # cumulative masses more than TIE_MARGIN apart
    kinds = [np.round(rng.normal(size=vocab) * 3 * 4) / 4, np.full(vocab, 0.5),
             rng.normal(size=vocab) * 10, np.round(rng.normal(size=vocab) * 4) / 4]
    kinds[2][rng.random(vocab) < 0.05] = -np.inf
    rows, kks, pps = [], [], []
    for k in HARD_KK + [float(vocab)]:
        for p in HARD_PP:
            for kind in kinds:
                rows.append(kind)
                kks.append(k)
                pps.append(p)
    x = torch.tensor(np.stack(rows), dtype=torch.float32, device="cuda")
    kk = torch.tensor(kks, device="cuda")
    xk = FS.fused_filter_plain(x, kk, torch.zeros_like(kk), do_topp=False).double().cpu().numpy()
    for r, p in enumerate(pps):
        if p <= 0:
            continue
        v = xk[r][np.isfinite(xk[r])]
        vals, counts = np.unique(v, return_counts=True)
        e = np.exp(vals - vals.max()) * counts
        cum = np.cumsum(e[::-1])[::-1] / e.sum()  # mass of {x >= vals[i]}
        if vals.max() - vals.min() < 100:
            cum = cum[1:]
        for _ in range(200):
            if cum.size == 0 or np.min(np.abs(cum - p)) > TIE_MARGIN * p:
                break
            p *= 1 - 3e-5
        else:
            raise SmokeError(f"hard row {r}: no top-p near {pps[r]} clears the tie margin")
        pps[r] = p
    return x, kk, torch.tensor(pps, device="cuda")


def mid_gap_top_p(torch, FS, x, kk, top_p):
    """Each row's top-p moved to the middle of the gap between the two
    cumulative masses of its top-k-filtered row around it (f64, ties
    grouped), so the kernel's and the plain version's summation orders
    cannot decide its cutoff. Returns the moved top-p [rows] f32 and the
    smallest half-gap relative to it."""
    xk = FS.fused_filter_plain(x, kk, torch.zeros_like(top_p), do_topp=False)
    v, _ = torch.sort(xk.double(), dim=-1, descending=True)
    fin = torch.isfinite(v)
    e = torch.where(fin, torch.exp(v - v[:, :1]), torch.zeros_like(v))
    cum = torch.cumsum(e, dim=-1) / e.sum(dim=-1, keepdim=True)
    end = fin.clone()
    end[:, :-1] &= v[:, :-1] != v[:, 1:]
    pp = top_p.double()[:, None]
    lower = torch.where(end & (cum <= pp), cum, torch.zeros_like(cum)).amax(dim=-1)
    upper = torch.where(end & (cum > pp), cum, torch.full_like(cum, float("inf"))).amin(dim=-1)
    moved = torch.where(torch.isfinite(upper) & (top_p > 0), (lower + upper) / 2, top_p.double())
    half = torch.where(torch.isfinite(upper) & (top_p > 0), (upper - lower) / 2 / moved,
                       torch.full_like(moved, float("inf")))
    return moved.float(), float(half.min())


def prologue_plain(torch, x, appears, suppress, penalty, temperature, eos):
    """sampler_plain's prologue (suppression, penalty, temperature) on x."""
    x = x.clone()
    x[suppress, eos] = float("-inf")
    x = torch.where(appears, torch.where(x < 0, x * penalty, x / penalty), x)
    return x * (1.0 / temperature)


TIE_OFFSETS = (-1e-7, -3e-8, 0.0, 3e-8, 1e-7)  # top-p this far (relative) from a mass
TIE_BOUND = 1e-5  # a token kept by one side only has a mass before it this near top-p


def check_top_p_ties(torch, FS, S, vocab: int, rows: int = 72) -> dict:
    """K2, K3 and K4 with each row's top-p put within ~1e-7 (relative) of a
    cumulative mass of its row (TIE_OFFSETS, then f32 rounding), where
    K2's fixed-point mass and the plain version's f32 sums may keep
    different sets. The disagreement is bounded, not avoided: a token kept
    by one side only must have a mass before it (f64, ties grouped) within
    TIE_BOUND of top-p; next and alt equal the plain version's unless one
    of them is such a token; alt_prob within SAMPLER_RTOL plus the share of
    the kept mass such tokens hold. Returns the counts and worst figures."""
    x, _, sweep, noise, _, _ = sampler_inputs(torch, S, rows, vocab, rows + 1)
    v, order = torch.sort(x.double(), dim=-1, descending=True)
    q = torch.softmax(v, dim=-1)
    cum = torch.cumsum(q, dim=-1)
    # each token's mass before it: of the values strictly above its own
    iota = torch.arange(vocab, device="cuda").expand(rows, vocab)
    starts = torch.ones_like(v, dtype=torch.bool)
    starts[:, 1:] = v[:, 1:] != v[:, :-1]
    first = torch.cummax(torch.where(starts, iota, torch.zeros_like(iota)), dim=-1).values
    before_sorted = torch.where(first > 0, cum.gather(1, (first - 1).clamp(min=0)),
                                torch.zeros_like(cum))
    before = torch.empty_like(before_sorted).scatter_(1, order, before_sorted)
    # top-p at the cumulative mass where the sweep's value falls (inside a
    # group of equal values no cut can fall, and both sides keep the group)
    j = (cum <= sweep.double()[:, None]).sum(dim=-1, keepdim=True).clamp(max=vocab - 1)
    mass = cum.gather(1, j)[:, 0]
    offsets = torch.tensor(TIE_OFFSETS, device="cuda", dtype=torch.float64)
    top_p = (mass * (1 + offsets.repeat(rows // len(TIE_OFFSETS) + 1)[:rows])).float()
    kk0 = torch.zeros(rows, device="cuda")

    kept_k = torch.isfinite(FS.fused_filter(x, 0, top_p, do_topk=False))
    kept_p = torch.isfinite(FS.fused_filter_plain(x, kk0, top_p, do_topk=False))
    only = kept_k ^ kept_p
    pd = top_p.double()[:, None]
    off = torch.where(only, (before - pd).abs() / pd, torch.zeros_like(before))
    check(bool((off <= TIE_BOUND).all()),
          f"top-p ties [{rows}, {vocab}]: a token kept by one side only has a mass before it "
          f"{float(off.max()):.2e} (relative) from top-p, beyond {TIE_BOUND}")
    probs = torch.softmax(x.double(), dim=-1)
    share = torch.where(only, probs, torch.zeros_like(probs)).sum(-1) / top_p.double()
    plain = FS.sampler_plain(x, kk0, top_p, 7, do_topk=False, do_topp=True, want_alt_prob=True,
                             gumbel_noise=noise)
    worst = 0.0
    for name, got in (("K2", FS.fused_filter_sample(x, 0, top_p, 7, do_topk=False,
                                                    gumbel_noise=noise)),
                      ("K3", FS.fused_step_sample(x, 0, top_p, 7, do_topk=False,
                                                  gumbel_noise=noise))):
        ar = torch.arange(rows, device="cuda")
        in_only = [only[ar, t.long()] for t in (got[0], got[1], plain[0], plain[1])]
        moved_next = in_only[0] | in_only[2]
        moved_alt = moved_next | in_only[1] | in_only[3]
        check(bool(((got[0] == plain[0]) | moved_next).all()),
              f"{name} top-p ties: next differs from the plain version away from a tie token")
        check(bool(((got[1] == plain[1]) | moved_alt).all()),
              f"{name} top-p ties: alt differs from the plain version away from a tie token")
        same = ~moved_alt
        err = (got[2].double() - plain[2].double()).abs()
        allowed = 1e-7 + (SAMPLER_RTOL + share) * plain[2].double().abs()
        check(bool(((err <= allowed) | ~same).all()),
              f"{name} top-p ties: alt_prob off by {float(err.max()):.3e}, beyond the kept "
              f"mass's share of the tie tokens")
        agree = ~only.any(-1) & (plain[2] > 0)
        rel = torch.where(agree, err / plain[2].double(), torch.zeros_like(err))
        worst = max(worst, float(rel.max()))
    diff_rows = int(only.any(-1).sum())
    stats = dict(rows_differing=diff_rows, most_tokens=int(only.sum(-1).max()),
                 worst_tie_offset=float(off.max()), largest_tie_share=float(share.max()),
                 worst_alt_prob_rel=worst)
    say(f"top-p ties [{rows}, {vocab}]: top-p within {max(map(abs, TIE_OFFSETS)):.0e} of a "
        f"cumulative mass; kept sets differ on {diff_rows} rows (at most {stats['most_tokens']} "
        f"tokens, each with a mass before it {stats['worst_tie_offset']:.2e} from top-p, "
        f"holding up to {stats['largest_tie_share']:.2e} of the kept mass); K2/K3 next/alt "
        f"equal the plain version's away from those tokens, alt_prob within the tokens' share, "
        f"and within {worst:.2e} relative on the rows whose sets agree")
    return stats


def check_sampler(torch, FS, S, vocab: int = 50257, sampler_rows=SAMPLER_ROWS,
                  timed_rows=TIMED_ROWS, eos: int = 50256):
    """K2/K3 (and K4's correctness) against their plain versions at every
    row count in `sampler_rows` of `vocab` (K3's eos gate at id `eos`), on
    hard rows, for determinism, Philox and the independence of the cluster
    size; then device times at `timed_rows`. Returns the K2/K3 and K4
    entries (at 72 rows, with the timed sweep) and K4's launches in this
    phase."""
    k4_before = FS.LAUNCHES["fused_filter"]
    worst = {"K2": 0.0, "K3": 0.0}

    def compare(name, got, want):
        check(torch.equal(got[0], want[0]), f"{name}: next differs from the plain version")
        check(torch.equal(got[1], want[1]), f"{name}: alt differs from the plain version")
        err = assert_close(torch, got[2], want[2], 1e-7, SAMPLER_RTOL, f"{name} alt_prob")
        if want[3] is not None:
            err = max(err, assert_close(torch, got[3], want[3], 1e-6, SAMPLER_RTOL,
                                        f"{name} eos_lp"))
        worst[name[:2]] = max(worst[name[:2]], err)

    def filter_exact(name, x, top_k, top_p, kk, **gates):
        got = FS.fused_filter(x, top_k, top_p, **gates)
        want = FS.fused_filter_plain(x, kk, top_p, **gates)
        torch.cuda.synchronize()
        check(torch.equal(torch.isfinite(got), torch.isfinite(want)),
              f"{name}: kept set differs from the plain version")
        check(torch.equal(got, want), f"{name}: kept values differ from the plain version")
        return got

    def step_kw(appears, suppress, penalty=1.2, temperature=0.9):
        return dict(appears=appears, penalty=penalty, temperature=temperature, eos_token_id=eos,
                    suppress_eos=suppress, want_eos_lp=True)

    def plain_step(x, kk, top_p, seed, appears, suppress, noise, penalty=1.2, temperature=0.9):
        return FS.sampler_plain(x, kk, top_p, seed, do_topk=True, do_topp=True,
                                want_alt_prob=True, gumbel_noise=noise,
                                appears=appears.view(torch.int8), penalty=penalty,
                                temperature=temperature, eos_token_id=eos,
                                suppress_eos=suppress.float(), want_eos_lp=True)

    clusters, gaps = {}, []
    for rows in sampler_rows:
        x, top_k, top_p, noise, appears, suppress = sampler_inputs(torch, S, rows, vocab, rows)
        kk = FS.resolve_top_k(top_k, rows, vocab, "cuda")
        clusters[rows] = FS.cluster_size(rows, vocab)
        # the sweep's top-p, each moved off the cumulative masses of the row
        # each kernel filters: after top-k, after the prologue, without top-k
        pp_k, gap_k = mid_gap_top_p(torch, FS, x, kk, top_p)
        pp_3, gap_3 = mid_gap_top_p(torch, FS, prologue_plain(torch, x, appears, suppress, 1.2,
                                                              0.9, eos), kk, top_p)
        pp_0, gap_0 = mid_gap_top_p(torch, FS, x, torch.zeros_like(kk), top_p)
        gaps.append(min(gap_k, gap_3, gap_0))
        # K2 and K3 with injected noise, both filters and alt_prob
        got = FS.fused_filter_sample(x, top_k, pp_k, 7, gumbel_noise=noise)
        compare(f"K2 rows {rows}", (*got, None), FS.sampler_plain(
            x, kk, pp_k, 7, do_topk=True, do_topp=True, want_alt_prob=True, gumbel_noise=noise))
        got = FS.fused_step_sample(x, top_k, pp_3, 9, gumbel_noise=noise,
                                   **step_kw(appears, suppress))
        compare(f"K3 rows {rows}", got, plain_step(x, kk, pp_3, 9, appears, suppress, noise))
        # K4, exact; each filter alone too at the main path's 72 rows
        gates = ([(True, True), (True, False), (False, True)] if rows == 72
                 else [(True, True)])
        for do_topk, do_topp in gates:
            pp = pp_k if do_topk else pp_0
            got = filter_exact(f"K4 rows {rows} top-k {do_topk} top-p {do_topp}", x, top_k,
                               pp, kk, do_topk=do_topk, do_topp=do_topp)
            if rows == 72:
                thr = S.top_k_top_p_filter_threshold(
                    x, top_k if do_topk else 0, pp if do_topp else 0.0,
                    iters=FS.DEFAULT_ITERS)
                check(torch.equal(torch.isfinite(got), torch.isfinite(thr)),
                      f"K4 top-k {do_topk} top-p {do_topp}: kept set differs from "
                      f"top_k_top_p_filter_threshold")
        # Philox: every sampled token lies in the plain filter's kept set
        kept = torch.isfinite(FS.fused_filter_plain(x, kk, pp_k))
        for seed in ((11, 12, 13) if rows == 72 else (11,)):
            nxt, alt, _ = FS.fused_filter_sample(x, top_k, pp_k, seed)
            check(bool(kept[torch.arange(rows, device="cuda"), nxt.long()].all()),
                  f"K2 rows {rows} with Philox sampled a filtered token")
        # determinism: two launches on the same inputs give the same bits
        for name, run in (
                ("K2", lambda: FS.fused_filter_sample(x, top_k, top_p, 21)),
                ("K3", lambda: FS.fused_step_sample(x, top_k, top_p, 21,
                                                    **step_kw(appears, suppress)))):
            a, b = run(), run()
            check(all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                      for u, v in zip(a, b) if u is not None),
                  f"{name} rows {rows}: two launches gave different bits")
        say(f"K2/K3/K4 [{rows}, {vocab}], cluster of {clusters[rows]} blocks per row: "
            f"next/alt exact with injected noise, alt_prob/eos_lp within rtol {SAMPLER_RTOL}, "
            f"K4 exact, Philox draws inside the kept set, two launches bit-identical (top-p "
            f"sweep moved to mid-gap: nearest cumulative mass {gaps[-1]:.2e} relative away)")
        if rows == 64:
            # a data-parallel shard: rows 32-63 launched alone with row_base 32
            # draw the whole launch's Philox noise for those rows
            lo = 32
            part = (x[lo:].contiguous(), top_k[lo:], pp_k[lo:])
            gate = (appears[lo:].contiguous(), suppress[lo:])
            pairs = (("K2", FS.fused_filter_sample(x, top_k, pp_k, 41),
                      FS.fused_filter_sample(*part, 41, row_base=lo)),
                     ("K3", FS.fused_step_sample(x, top_k, pp_k, 43, **step_kw(appears, suppress)),
                      FS.fused_step_sample(*part, 43, row_base=lo, **step_kw(*gate))))
            for name, whole, half in pairs:
                check(torch.equal(half[0], whole[0][lo:]) and torch.equal(half[1], whole[1][lo:]),
                      f"{name} rows {lo}-63 with row_base {lo}: next/alt differ from the whole "
                      f"launch's")
                assert_close(torch, half[2], whole[2][lo:], 1e-7, SAMPLER_RTOL,
                             f"{name} alt_prob with row_base {lo}")
            say(f"K2/K3 [{rows - lo}, {vocab}] with row_base {lo}: next/alt the whole {rows}-row "
                f"launch's rows {lo}-63 exactly, alt_prob within rtol {SAMPLER_RTOL}")
        if rows == 512:
            # the cluster size decides nothing: the first 8 rows alone (another
            # cluster size) give the same tokens with Philox
            big = FS.fused_step_sample(x, top_k, top_p, 31, **step_kw(appears, suppress))
            small = FS.fused_step_sample(x[:8].contiguous(), top_k[:8], top_p[:8], 31,
                                         **step_kw(appears[:8].contiguous(), suppress[:8]))
            check(torch.equal(big[0][:8], small[0]) and torch.equal(big[1][:8], small[1]),
                  "K3 tokens depend on the cluster size")
            assert_close(torch, small[2], big[2][:8], 1e-7, SAMPLER_RTOL,
                         "K3 alt_prob across cluster sizes")
            assert_close(torch, small[3], big[3][:8], 1e-6, SAMPLER_RTOL,
                         "K3 eos_lp across cluster sizes")
            say(f"K3 rows 0-7 of the 512-row batch (cluster {clusters[512]}) and alone "
                f"(cluster {FS.cluster_size(8, vocab)}): same next/alt with Philox, alt_prob/eos_lp within "
                f"rtol {SAMPLER_RTOL}")

    # hard rows: ties, an all-equal row, -inf columns, k in {1, 40, V}, p near 0 and 1
    x, kk, top_p = hard_rows(torch, FS, vocab)
    rows = x.shape[0]
    noise = S.gumbel_like(x, torch.Generator(device="cuda").manual_seed(9))
    got = FS.fused_filter_sample(x, kk, top_p, 3, gumbel_noise=noise)
    compare("K2 hard rows", (*got, None), FS.sampler_plain(
        x, kk, top_p, 3, do_topk=True, do_topp=True, want_alt_prob=True, gumbel_noise=noise))
    appears = torch.zeros(rows, vocab, dtype=torch.bool, device="cuda")
    no_gate = torch.zeros(rows, dtype=torch.bool, device="cuda")
    got = FS.fused_step_sample(x, kk, top_p, 3, gumbel_noise=noise,
                               **step_kw(appears, no_gate, penalty=1.0, temperature=1.0))
    compare("K3 hard rows", got, plain_step(x, kk, top_p, 3, appears, no_gate, noise, 1.0, 1.0))
    kept = torch.isfinite(filter_exact("K4 hard rows", x, kk, top_p, kk))
    nxt, _, _ = FS.fused_filter_sample(x, kk, top_p, 17)
    check(bool(kept[torch.arange(rows, device="cuda"), nxt.long()].all()),
          "K2 hard rows with Philox sampled a filtered token")
    say(f"hard rows [{rows}, {vocab}] (0.25-quantised, all-equal, -inf columns, narrow; top-k "
        f"{HARD_KK + [vocab]}, top-p {HARD_PP} kept {TIE_MARGIN} from every cumulative mass): K2/K3 "
        f"next/alt exact, K4 exact, Philox inside the kept set")

    check_top_p_ties(torch, FS, S, vocab)

    # device times at the main path's flags: top-p only, Philox, no alt_prob
    step_main = dict(penalty=1.2, eos_token_id=eos, want_eos_lp=True)
    sweep = {"fused_filter_sample": {}, "fused_step_sample": {}, "fused_filter": {}}
    results = {}
    for rows in timed_rows:
        clusters[rows] = FS.cluster_size(rows, vocab)
        x, top_k, top_p, _, appears, suppress = sampler_inputs(torch, S, rows, vocab, rows)
        kk = FS.resolve_top_k(top_k, rows, vocab, "cuda")
        kk0 = FS.resolve_top_k(0, rows, vocab, "cuda")

        def k2():
            return FS.fused_filter_sample(x, 0, top_p, 5, do_topk=False, want_alt_prob=False)

        def k3():
            return FS.fused_step_sample(x, 0, top_p, 5, do_topk=False, want_alt_prob=False,
                                        appears=appears, suppress_eos=suppress, **step_main)

        def k4():
            return FS.fused_filter(x, top_k, top_p)

        timed = {"fused_filter_sample": (k2, sampler_bound(rows, vocab, prologue=False)),
                 "fused_step_sample": (k3, sampler_bound(rows, vocab, prologue=True)),
                 "fused_filter": (k4, filter_bound(rows, vocab))}
        for name, (fn, (b_ms, b_by)) in timed.items():
            ms = device_ms(torch, fn, kernel="sampler_kernel")
            sweep[name][rows] = dict(ms=ms, bound_ms=b_ms, cluster=clusters[rows])
            if rows == 72:
                wall = time_ms(torch, fn)
                if name == "fused_filter_sample":
                    plain = device_ms(torch, lambda: FS.sampler_plain(
                        x, kk0, top_p, 5, do_topk=False, do_topp=True, want_alt_prob=False), 5)
                elif name == "fused_step_sample":
                    plain = device_ms(torch, lambda: FS.sampler_plain(
                        x, kk0, top_p, 5, do_topk=False, do_topp=True, want_alt_prob=False,
                        appears=appears.view(torch.int8), penalty=1.2, eos_token_id=eos,
                        suppress_eos=suppress.float(), want_eos_lp=True), 5)
                else:
                    plain = device_ms(torch, lambda: FS.fused_filter_plain(x, kk, top_p), 5)
                results[name] = dict(max_abs_err=worst["K2"] if name == "fused_filter_sample"
                                     else worst["K3"] if name == "fused_step_sample" else 0.0,
                                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=None, cluster=clusters[rows], wall_ms=wall)
        say(f"sampler [{rows}, {vocab}], cluster {clusters[rows]} (device ms, kernel / bound): "
            + "; ".join(f"{k} {sweep[k][rows]['ms']:.4f} / {sweep[k][rows]['bound_ms']:.4f}"
                        for k in sweep))
    # a narrow row (N(0, 0.0625)): its whole range must spread over the buckets
    x, _, top_p, _, _, _ = sampler_inputs(torch, S, 72, vocab, 72)
    x = x / 12
    narrow_ms = device_ms(torch, lambda: FS.fused_filter_sample(
        x, 0, top_p, 5, do_topk=False, want_alt_prob=False), kernel="sampler_kernel")
    results["fused_filter_sample"]["narrow_ms"] = narrow_ms
    say(f"K2 top-p [72, {vocab}] on N(0, 0.0625) logits (device ms): kernel {narrow_ms:.4f}")
    for name, label in (("fused_filter_sample", "K2 top-p"),
                        ("fused_step_sample", "K3 top-p+prologue"),
                        ("fused_filter", "K4 top-p sweep + top-k 40 on alternate rows")):
        r = results[name]
        say(f"{label} [72, {vocab}] (device ms): kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']}); wrapper wall {r['wall_ms']:.4f}")
        r["sweep"] = {str(k): v for k, v in sweep[name].items()}
    launches = FS.LAUNCHES["fused_filter"] - k4_before
    say(f"K4: {launches} launches in this phase (on no decode path)")
    return results, launches


# --- 4. the main path ----------------------------------------------------------------


def greedy_with_gaps(torch, lm, prompt, n: int):
    """Greedy tokens and each step's top-2 logit gap, by prefill/decode_step
    (a token-id LM, BLIP's decoder_lm, takes an id prompt and is fed ids)."""
    ids = getattr(lm, "takes_token_ids", False)
    cache = lm.init_cache(prompt.shape[0], prompt.shape[1] + n,
                          dtype=None if ids else prompt.dtype)
    logits, cache = lm.prefill(prompt, cache)
    logits = logits[:, -1]
    toks, gaps = [], []
    for step in range(n):
        top2 = logits.float().topk(2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        if step + 1 < n:
            logits, cache = lm.decode_step(tok[:, None] if ids else lm.embed_tokens(tok)[:, None],
                                           cache)
    return torch.stack(toks, 1), torch.stack(gaps, 1)


def make_bundle(torch):
    """CLIP ViT-B/32 + the default mapper + GPT-2 124M at full width on the
    card, seeded random f32 weights."""
    from clipcap_tpu_torch.core.config import CaptionerConfig, GPT2Config, MapperConfig, ViTConfig
    from clipcap_tpu_torch.models.bundle import CaptionerBundle

    cap_cfg = CaptionerConfig(lm_type="gpt2", visual_encoder_type="CLIP",
                              visual_encoder_variant="ViT-B/32", mapper=MapperConfig())
    bundle = CaptionerBundle.create(cap_cfg, GPT2Config.variant("gpt2"), IdTokenizer(),
                                    ViTConfig.clip_variant("ViT-B/32"), seed=0, device="cuda")
    n_params = sum(p.numel() for p in bundle.model.parameters())
    say(f"model: ViT-B/32 + mapper (8 layers, 512->768, prefix 10) + GPT-2 124M, "
        f"{n_params / 1e6:.1f}M params, f32, random weights (seed 0)")
    return bundle


def main_path(torch, counters, bundle):
    from clipcap_tpu_torch.data.preprocessing import normalize_on_device
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler

    vit_cfg, lm_cfg = bundle.vit_cfg, bundle.lm_cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    pixels = normalize_on_device(torch.rand(64, 3, 224, 224, generator=gen, device="cuda"))
    sampler = NoBeamCaptionSampler(top_p_values=TOP_P_SWEEP, device="cuda")
    n_new = 24
    step_settings = GenerationSettings(max_new_tokens=n_new, top_p=0.8, repetition_penalty=1.2,
                                       eos_token_id=50256, min_length=5,
                                       filter_method="fused_step")

    def drive():
        """The main path once: (a) encode, (b) greedy, (c) sampler, (d) fused_step."""
        out, secs = {}, {}
        t0 = time.perf_counter()
        out["feats"] = bundle.encode_image(pixels)
        torch.cuda.synchronize()
        secs["a"] = time.perf_counter() - t0
        out["k1_after_a"] = counters()["fused_attention"]
        prefix = bundle.project_prefix(out["feats"][:8])
        out["prefix"] = prefix
        t0 = time.perf_counter()
        out["greedy"] = generate(bundle.lm, prefix, GenerationSettings(
            max_new_tokens=n_new, greedy=True), device="cuda")
        torch.cuda.synchronize()
        secs["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["captions"] = sampler.sample_batch(bundle, pixels[:8])
        torch.cuda.synchronize()
        secs["c"] = time.perf_counter() - t0
        k3_before = counters()["fused_step_sample"]
        bos = bundle.embed_text(torch.full((8, 1), 50256, device="cuda"))
        t0 = time.perf_counter()
        out["step"] = generate(bundle.lm, torch.cat([prefix, bos], 1), step_settings,
                               seed=5, device="cuda")
        torch.cuda.synchronize()
        secs["d"] = time.perf_counter() - t0
        out["k3_rise"] = counters()["fused_step_sample"] - k3_before
        return out, secs

    drive()  # warm-up: cuBLAS handles, allocator; its launches are not counted
    counters(reset=True)
    out, secs = drive()
    launches = counters()

    # (a) encode: 12 attention launches per call, finite [64, 512], agrees with the CPU
    feats = out["feats"]
    check(tuple(feats.shape) == (64, 512), f"encode_image shape {tuple(feats.shape)}")
    check(out["k1_after_a"] == vit_cfg.layers,
          f"K1 launched {out['k1_after_a']} times in one encode, want {vit_cfg.layers}")
    cpu_visual = copy.deepcopy(bundle.model.visual).cpu()
    with torch.no_grad():
        want = cpu_visual(pixels[:2].cpu(), output="pooled")
    err_a = assert_close(torch, feats[:2].cpu(), want, *CARD_VS_CPU, "encode_image card vs CPU")
    del cpu_visual
    say(f"(a) encode_image 64 images: {64 / secs['a']:.1f} images/s; "
        f"card vs CPU max abs err {err_a:.3e}")

    # (b) greedy: prefill logits and tokens against the same port on the CPU
    cpu_lm = copy.deepcopy(bundle.lm).cpu()
    prefix = out["prefix"]
    with torch.no_grad():
        card_logits, _ = bundle.lm.prefill(prefix, bundle.lm.init_cache(8, prefix.shape[1]))
        cpu_logits, _ = cpu_lm.prefill(prefix.cpu(), cpu_lm.init_cache(8, prefix.shape[1]))
        cpu_toks, cpu_gaps = greedy_with_gaps(torch, cpu_lm, prefix.cpu(), n_new)
    err_b = assert_close(torch, card_logits.cpu(), cpu_logits, *CARD_VS_CPU,
                         "prefill logits card vs CPU")
    card_toks = out["greedy"]["tokens"].cpu().long()
    flips = 0
    for row in range(8):
        diff = (card_toks[row] != cpu_toks[row]).nonzero()
        if len(diff):
            s = int(diff[0])
            gap = float(cpu_gaps[row, s])
            check(gap < FLIP_GAP, f"greedy row {row} differs at step {s} where the CPU top-2 "
                  f"gap is {gap:.3e} (>= {FLIP_GAP})")
            flips += 1
    del cpu_lm
    say(f"(b) greedy 8x{n_new}: {8 / secs['b']:.2f} captions/s; prefill logits card vs CPU "
        f"max abs err {err_b:.3e}; rows with a near-tie flip: {flips}")

    # (c) the sampler: one K2 launch per decode step
    caps = out["captions"]
    check(len(caps) == 8 and all(len(c) == len(TOP_P_SWEEP) for c in caps),
          "sample_batch returned the wrong number of captions")
    ids = [int(t) for c in caps for s in c for t in s.split()]
    check(all(0 <= t < lm_cfg.vocab_size for t in ids), "caption token outside the vocabulary")
    check(launches["fused_filter_sample"] == sampler.max_decode_length,
          f"K2 launched {launches['fused_filter_sample']} times, want one per decode step "
          f"({sampler.max_decode_length})")
    n_caps = 8 * len(TOP_P_SWEEP)
    say(f"(c) NoBeamCaptionSampler.sample_batch 8 images x {len(TOP_P_SWEEP)} top-p: "
        f"{n_caps / secs['c']:.2f} captions/s ({sampler.max_decode_length} steps); "
        f"image 0, top-p 0.1: [{caps[0][0][:80]}]")

    # (d) fused_step: K3 per step, eos suppressed before min_length, finite eos logprob
    step = out["step"]
    check(out["k3_rise"] == n_new, f"K3 rose by {out['k3_rise']}, want {n_new}")
    check(bool((step["tokens"][:, :5] != 50256).all()), "eos emitted before min_length")
    lp = step["eos_logprob"]
    check(bool(torch.isfinite(lp).all() and (lp <= 0).all()), "eos_logprob not a log-prob")
    say(f"(d) fused_step generate 8x{n_new}: {8 / secs['d']:.2f} captions/s; "
        f"eos_logprob in [{float(lp.min()):.3f}, {float(lp.max()):.3f}]")
    c_prof = profile_call(torch, "(c)", lambda: sampler.sample_batch(bundle, pixels[:8]),
                          secs["c"] * 1e3)
    return launches, {"images_per_s": 64 / secs["a"], "captions_per_s": n_caps / secs["c"],
                      "c_profile": c_prof}


# --- 5. the serving path -------------------------------------------------------------

SERVE_REQUESTS, SERVE_SLOTS, SERVE_SYNC, SERVE_NEW, EOS = 256, 64, 8, 24, 50256


def first_difference(a, b) -> int:
    return next(j for j in range(max(len(a), len(b)))
                if j >= len(a) or j >= len(b) or a[j] != b[j])


def serving_path(torch, counters, bundle):
    """(e) continuous batching at full width: 256 requests from a pool of
    project_prefix outputs, per-request caps 8-24 from a seed, 64 slots, 8
    steps per sync, through bundle.make_serving_engine and
    ServingEngine.serve: (e1) greedy at pipeline_depth 1 against the card's
    own solo generate of the first 16 requests; (e2) top-p 0.8 "fused" at
    depth 2, one K2 launch per dispatched step; (e3) "fused_step" with
    repetition penalty 1.2 and min_length 5 at depth 2, one K3 launch per
    dispatched step. The launch counters are set to 0 just before the three
    serves and read just after. Then a small greedy run shows that the
    pipelined and the synchronous loop give the same tokens."""
    import dataclasses

    import numpy as np

    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.decode.serving import Request

    dev, vocab = bundle.device, bundle.lm_cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(5)
    pool = bundle.project_prefix(torch.randn(SERVE_REQUESTS, bundle.cap_cfg.mapper.dim_clip,
                                             generator=gen, device=dev))
    caps = np.random.default_rng(6).integers(8, 25, SERVE_REQUESTS).tolist()
    reqs = [Request(i, i, max_length=c) for i, c in enumerate(caps)]
    base = GenerationSettings(max_new_tokens=SERVE_NEW, eos_token_id=EOS)
    greedy = dataclasses.replace(base, greedy=True)
    runs = {"e1": ("greedy", greedy, 1, None),
            "e2": ('top-p 0.8, "fused"', dataclasses.replace(base, top_p=0.8), 2,
                   "fused_filter_sample"),
            "e3": ('top-p 0.8, "fused_step", repetition penalty 1.2, min_length 5',
                   dataclasses.replace(base, top_p=0.8, repetition_penalty=1.2, min_length=5,
                                       filter_method="fused_step"), 2, "fused_step_sample")}
    engines = {name: bundle.make_serving_engine(s, slots=SERVE_SLOTS, steps_per_sync=SERVE_SYNC,
                                                pipeline_depth=depth).warmup()
               for name, (_, s, depth, _) in runs.items()}

    counters(reset=True)
    served = {}
    for name in runs:
        before = counters()
        t0 = time.perf_counter()
        res = engines[name].serve(reqs, seed=7, prefix_pool=pool)
        wall = time.perf_counter() - t0
        after = counters()
        served[name] = (res, wall, {k: after[k] - before[k] for k in after},
                        engines[name].last_stats)
    launches = counters()

    rates = {}
    for name, (desc, settings, depth, kernel) in runs.items():
        res, wall, rise, stats = served[name]
        check(sorted(res) == list(range(SERVE_REQUESTS)), f"({name}) not every request answered")
        for i, r in res.items():
            toks = r["tokens"]
            check(0 < len(toks) <= caps[i] and r["length"] == len(toks),
                  f"({name}) request {i}: {len(toks)} tokens, cap {caps[i]}")
            check(all(0 <= t < vocab for t in toks), f"({name}) token outside the vocabulary")
        for k in ("fused_filter_sample", "fused_step_sample"):
            want = stats["steps"] if k == kernel else 0
            check(rise[k] == want, f"({name}) {k} launched {rise[k]} times over "
                  f"{stats['steps']} dispatched steps, want {want}")
        lat = np.asarray([r["latency_s"] for r in res.values()])
        rates[name] = dict(captions_per_s=SERVE_REQUESTS / wall,
                           p50_s=float(np.percentile(lat, 50)),
                           p99_s=float(np.percentile(lat, 99)), occupancy=stats["occupancy"],
                           steps=stats["steps"], refills=sum(stats["refills"].values()),
                           pipeline_depth=depth)
        say(f"({name}) serve {SERVE_REQUESTS} requests ({desc}; caps 8-24), {SERVE_SLOTS} slots, "
            f"steps_per_sync {SERVE_SYNC}, pipeline_depth {depth}: "
            f"{rates[name]['captions_per_s']:.2f} captions/s; latency_s p50 "
            f"{rates[name]['p50_s']:.4f}, p99 {rates[name]['p99_s']:.4f}; occupancy "
            f"{stats['occupancy']}; {stats['steps']} steps; {rates[name]['refills']} refills; "
            f"host: chunk dispatch {stats['dispatch_s']:.3f} s, refill dispatch "
            f"{stats['refill_dispatch_s']:.3f} s, harvest wait {stats['harvest_wait_s']:.3f} s; "
            f"K2 +{rise['fused_filter_sample']}, K3 +{rise['fused_step_sample']}")

    # (e1): the first 16 requests against the card's solo static engine
    flips = 0
    for i in range(16):
        ref = generate(bundle.lm, pool[i:i + 1], dataclasses.replace(greedy, max_length=caps[i]),
                       device=dev)
        want = ref["tokens"][0, : int(ref["lengths"][0])].tolist()
        got = served["e1"][0][i]["tokens"]
        if got != want:
            s = first_difference(got, want)
            _, gaps = greedy_with_gaps(torch, bundle.lm, pool[i:i + 1], SERVE_NEW)
            gap = float(gaps[0, s])
            check(gap < FLIP_GAP, f"(e1) request {i} differs from its solo run at step {s} "
                  f"where the solo top-2 gap is {gap:.3e} (>= {FLIP_GAP})")
            flips += 1
    # (e3): no eos before min_length
    check(all(EOS not in r["tokens"][:5] for r in served["e3"][0].values()),
          "(e3) eos emitted before min_length")
    # the pipelined and the synchronous loop on a small greedy run
    small = reqs[:48]
    a, b = (bundle.make_serving_engine(greedy, slots=16, steps_per_sync=4,
                                       pipeline_depth=d).serve(small, prefix_pool=pool)
            for d in (1, 2))
    check(all(a[r.request_id]["tokens"] == b[r.request_id]["tokens"] for r in small),
          "pipeline_depth 1 and 2 give different greedy tokens")
    say(f"(e) serving checks: (e1) first 16 requests equal their solo generate "
        f"(near-tie flips: {flips}); (e2)/(e3) one sampler launch per dispatched step, tokens "
        f"in the vocabulary, lengths within caps; (e3) no eos before min_length; "
        f"48 requests on 16 slots: pipeline_depth 1 and 2 give the same greedy tokens")
    profile_call(torch, "(e2)", lambda: engines["e2"].serve(reqs, seed=7, prefix_pool=pool),
                 served["e2"][1] * 1e3)
    return launches, rates


# --- 6. the infer path ---------------------------------------------------------------

INFER_IMAGES, NOBEAM_IMAGES, BEAM, BEAM_NEW, STOP = 64, 8, 5, 67, 13  # 13: GPT-2's "."
CLIP_MERGES = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>"), ("a", "n")]
# the CLIP ViT-B/32 scorer's text tower (OpenAI CLIP)
CLIP_TEXT = dict(vocab_size=49408, context_length=77, width=512, layers=12, output_dim=512)


def write_gpt2_vocab(folder: Path) -> None:
    """A byte-level BPE vocabulary of GPT-2's size (50257): the 256 byte
    symbols, 50000 two-symbol merges and <|endoftext|> last, so "." is id 13
    and <|endoftext|> 50256, as in GPT-2's own files."""
    from clipcap_tpu_torch.tokenizers.bpe import bytes_to_unicode

    base = list(bytes_to_unicode().values())
    merges = [(a, b) for a in base for b in base][:50257 - len(base) - 1]
    vocab = {t: i for i, t in enumerate(base + [a + b for a, b in merges] + ["<|endoftext|>"])}
    check(len(vocab) == 50257 and vocab["."] == STOP, "synthetic GPT-2 vocabulary malformed")
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "vocab.json").write_text(json.dumps(vocab))
    (folder / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


def clip_openai_state_dict(torch, vit_cfg, seed: int, text: dict = CLIP_TEXT,
                           dtype=None) -> dict:
    """A seeded OpenAI-layout CLIP state dict (CPU tensors, f32 unless
    `dtype`): the `vit_cfg` image tower (none when it is None) and `text`'s
    text tower, with the key names and shapes that
    clip_vit_from_openai_state_dict / clip_text_from_openai_state_dict read.
    Drawn on the card, N(0, 0.02) weights and small biases."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.float32

    def w(*shape, s=0.02):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype).cpu()

    def blocks(prefix, d, n):
        out = {}
        for i in range(n):
            p = f"{prefix}transformer.resblocks.{i}."
            out.update({p + "ln_1.weight": 1 + w(d), p + "ln_1.bias": w(d),
                        p + "attn.in_proj_weight": w(3 * d, d), p + "attn.in_proj_bias": w(3 * d),
                        p + "attn.out_proj.weight": w(d, d), p + "attn.out_proj.bias": w(d),
                        p + "ln_2.weight": 1 + w(d), p + "ln_2.bias": w(d),
                        p + "mlp.c_fc.weight": w(4 * d, d), p + "mlp.c_fc.bias": w(4 * d),
                        p + "mlp.c_proj.weight": w(d, 4 * d), p + "mlp.c_proj.bias": w(d)})
        return out

    sd, t = {}, text["width"]
    if vit_cfg is not None:
        d, pch = vit_cfg.width, vit_cfg.patch_size
        sd.update({"visual.conv1.weight": w(d, 3, pch, pch),
                   "visual.class_embedding": w(d, s=d ** -0.5),
                   "visual.positional_embedding": w(vit_cfg.seq_len, d, s=d ** -0.5),
                   "visual.ln_pre.weight": 1 + w(d), "visual.ln_pre.bias": w(d),
                   "visual.ln_post.weight": 1 + w(d), "visual.ln_post.bias": w(d),
                   "visual.proj": w(d, vit_cfg.output_dim, s=d ** -0.5)})
    sd.update({"token_embedding.weight": w(text["vocab_size"], t),
               "positional_embedding": w(text["context_length"], t, s=0.01),
               "ln_final.weight": 1 + w(t), "ln_final.bias": w(t),
               "text_projection": w(t, text["output_dim"], s=t ** -0.5)})
    if vit_cfg is not None:
        sd.update(blocks("visual.", d, vit_cfg.layers))
    sd.update(blocks("", t, text["layers"]))
    return sd


def write_jpegs(folder: Path, n: int, seed: int) -> None:
    """n seeded JPEGs of several sizes and aspect ratios (smooth colour
    fields with noise, so the encoder compresses them as it would photos)."""
    import numpy as np
    from PIL import Image

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        w, h = int(rng.integers(200, 400)), int(rng.integers(200, 400))
        yy, xx = np.mgrid[0:h, 0:w]
        base = rng.random(3) * 255 * (0.5 + 0.5 * np.sin(xx / w * 6 + yy / h * 3))[..., None]
        img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(folder / f"img{i:03d}.jpg", quality=90)


def traced_beam(torch, lm, prompt, device: str, stop: int = STOP, beam: int = BEAM,
                new: int = BEAM_NEW):
    """decode/beam.py's beam_search_batched with each step's selection
    recorded: every call of its _topk_iter takes one pick more than asked
    (the first picks do not change), so each step also gives the gap
    between the beam-th and (beam+1)-th best candidate. Returns (the
    result, each step's selected flat indices [N, beam], gaps [N, steps])."""
    from clipcap_tpu_torch.decode import beam as B

    real, picks = B._topk_iter, []

    def topk_and_next(x, k):
        vals, idx = real(x, k + 1)
        picks.append((idx[:, :k], vals[:, k - 1] - vals[:, k]))
        return vals[:, :k], idx[:, :k]

    B._topk_iter = topk_and_next
    try:
        out = B.beam_search_batched(lm, prompt, beam_size=beam, max_new_tokens=new,
                                    stop_token_id=stop, device=device)
    finally:
        B._topk_iter = real
    return out, [sel for sel, _ in picks], torch.stack([gap for _, gap in picks], 1)


def check_beam_vs_cpu(torch, bundle, prompt, card_out, card_sel, n_check: int = 2,
                      gap_bound: float = FLIP_GAP, label: str = "(f)", stop: int = STOP):
    """The card's best beams of the first n_check images against the port
    on the CPU (the bundle's decode LM, int8 once enabled). A best beam may
    differ only where the CPU's selection is a near-tie: from the first step
    at which the card's selections `card_sel` (traced_beam's, on the same
    batch of images as card_out) and the CPU's differ, the CPU's gap there
    between the beam-th and (beam+1)-th normalised candidates must be below
    `gap_bound` (or, with the same selections throughout, the gap between
    the two best final scores). Returns the number of images with such a
    flip and the CPU seconds."""
    t0 = time.perf_counter()
    cpu_out, cpu_sel, cpu_gaps = traced_beam(torch, copy.deepcopy(bundle.lm_decode).cpu(),
                                             prompt[:n_check].cpu(), "cpu", stop)
    cpu_s = time.perf_counter() - t0

    def best(out, i):
        b = int(out["scores"][i].argmax())
        return out["tokens"][i, b, : int(out["seq_lengths"][i, b])].tolist()

    flips = 0
    for i in range(n_check):
        if best(card_out, i) == best(cpu_out, i):
            continue
        steps = [s for s, (a, b) in enumerate(zip(card_sel, cpu_sel))
                 if not torch.equal(a[i].cpu(), b[i])]
        if steps:
            gap, where = float(cpu_gaps[i, steps[0]]), f"step {steps[0]}"
        else:
            top2 = cpu_out["scores"][i].topk(2).values
            gap, where = float(top2[0] - top2[1]), "the final ordering"
        check(gap < gap_bound, f"{label} beam image {i}: best beam differs from the CPU at "
              f"{where}, where the CPU's gap is {gap:.3e} (>= {gap_bound:.3e})")
        flips += 1
    say(f"{label} beam check: the best beams of images 0-{n_check - 1} ({prompt.shape[0]}-image "
        f"batch on the card) against the port on the CPU: near-tie flips {flips}; smallest "
        f"CPU selection gap {float(cpu_gaps.min()):.3e}")
    return flips, cpu_s


def infer_path(torch, counters, bundle, card: str, work: Path):
    """(f) weights in, captions out, at full width: the bundle is written by
    the port's checkpoint writer and an OpenAI-layout CLIP ViT-B/32 state
    dict by torch.save into `work`, both read back by the port's loaders
    onto the card and held against what was written; then cli.infer.main
    captions a folder of 64 seeded JPEGs by beam search (64 images x beam 5
    x 67 new tokens, one chunk of 320 rows) and 8 of them by the no-beam
    top-p sweep, with a synthetic 50257-entry GPT-2 vocabulary and a short
    CLIP merges file. The launch counters are set to 0 just before these
    two runs and read just after. Then the beam call again, traced once as
    the warm-up, then timed and profiled, its best beams held against the
    CPU, and a timed no-beam image call. The files stay in `work` for the
    evaluate phase."""
    import contextlib
    import math

    import numpy as np
    from PIL import Image

    from clipcap_tpu_torch.cli import infer as infer_cli
    from clipcap_tpu_torch.cli.loading import load_captioner, load_clip_towers
    from clipcap_tpu_torch.core.config import CLIPTextConfig
    from clipcap_tpu_torch.decode.beam import beam_search_batched, best_beam_texts
    from clipcap_tpu_torch.eval.clip_scoring import ClipScoring
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.tokenizers import create_tokenizer
    from clipcap_tpu_torch.tools import import_weights as W
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint

    t_phase = time.perf_counter()
    vit_cfg = bundle.vit_cfg
    # write, then load back through the port's loaders
    t0 = time.perf_counter()
    save_checkpoint(str(work / "ckpt"), bundle.model, bundle.cap_cfg, bundle.lm_cfg)
    clip_sd = clip_openai_state_dict(torch, vit_cfg, seed=11)
    torch.save(clip_sd, work / "clip.pt")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, cap_cfg, lm_cfg, loaded_vit = load_captioner(str(work / "ckpt"), device="cuda")
    visual, text = load_clip_towers("ViT-B/32", str(work / "clip.pt"), device="cuda")
    load_s = time.perf_counter() - t0
    want = bundle.model.state_dict()
    for name, p in model.state_dict().items():
        check(p.is_cuda and torch.equal(p, want[name]), f"loaded captioner {name} differs")
    for mod, conv in ((visual, W.clip_vit_from_openai_state_dict(clip_sd, vit_cfg)),
                      (text, W.clip_text_from_openai_state_dict(clip_sd, text.cfg))):
        for name, p in mod.state_dict().items():
            check(p.is_cuda and torch.equal(p.cpu(), torch.from_numpy(np.array(conv[name]))),
                  f"loaded CLIP {name} differs from the written state dict")
    check(loaded_vit == vit_cfg and cap_cfg == bundle.cap_cfg and lm_cfg == bundle.lm_cfg
          and text.cfg == CLIPTextConfig(**CLIP_TEXT, heads=CLIP_TEXT["width"] // 64),
          "loaded configs differ from the written ones")
    del want
    say(f"(f) loaders: checkpoint ({sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
        f"params) and OpenAI-layout CLIP ViT-B/32 ({sum(p.numel() for p in visual.parameters()) / 1e6:.1f}M"
        f" + text {sum(p.numel() for p in text.parameters()) / 1e6:.1f}M) written in "
        f"{write_s:.1f} s, read back onto the card in {load_s:.1f} s; every parameter on the "
        f"card and equal to what was written")

    # the infer path, its launches counted
    write_gpt2_vocab(work / "vocab")
    (work / "clip_merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES) + "\n")
    write_jpegs(work / "images", INFER_IMAGES, seed=13)
    args = ["--checkpoint_path", str(work / "ckpt"),
            "--tokenizer_vocab_dir", str(work / "vocab"),
            "--folder_path", str(work / "images"), "--clip_model", "ViT-B/32",
            "--clip_checkpoint", str(work / "clip.pt"),
            "--clip_merges", str(work / "clip_merges.txt"), "--device", "cuda"]
    scoring = ClipScoring(visual, text, None)
    pixels = []
    for f in sorted((work / "images").glob("*.jpg")):
        with Image.open(f) as image:
            pixels.append(scoring.preprocess_image(image))
    pixels = np.stack(pixels)
    loaded = CaptionerBundle(model, cap_cfg, lm_cfg,
                             create_tokenizer("gpt2", str(work / "vocab")),
                             vit_cfg=loaded_vit, device="cuda")

    def run(beam, n_img, prefix):
        extra = [] if beam else ["--no_beam", "--total_samples", str(n_img)]
        return infer_cli.main(args + extra + ["--out_filename_prefix", str(work / prefix)])
    del clip_sd
    torch.cuda.synchronize()
    counters(reset=True)
    runs = {}
    for name, beam, n_img in (("beam", True, INFER_IMAGES),
                              ("no_beam", False, NOBEAM_IMAGES)):
        before = counters()
        t0 = time.perf_counter()
        with open(work / f"{name}_stdout.txt", "w") as log, contextlib.redirect_stdout(log):
            data = run(beam, n_img, name)
        torch.cuda.synchronize()
        after = counters()
        runs[name] = (data, time.perf_counter() - t0,
                      {k: after[k] - before[k] for k in after}, n_img)
    launches = counters()

    for name, (data, secs, rise, n_img) in runs.items():
        written = json.loads((work / f"{name}_shutterstock.json").read_text())
        check(len(data) == n_img and written == json.loads(json.dumps(data)),
              f"({name}) the JSON holds {len(written)} entries, want {n_img}")
        check(all(math.isfinite(v) for e in data.values() for v in e["scores"].values()),
              f"({name}) a score is not finite")
        check(all(len(e["generated_captions"]) == 1 for e in data.values()),
              f"({name}) not one caption per image")
        chunks = math.ceil(n_img / 64)
        want_k1 = vit_cfg.layers * (chunks if name == "beam" else 2 * n_img)
        want_k2 = 0 if name == "beam" else 75 * n_img  # NoBeamCaptionSampler: 75 steps
        check(rise["fused_attention"] == want_k1,
              f"({name}) K1 launched {rise['fused_attention']} times, want {want_k1}")
        check(rise["fused_filter_sample"] == want_k2,
              f"({name}) K2 launched {rise['fused_filter_sample']} times, want {want_k2}")
        first = next(iter(data.values()))
        say(f"(f) cli.infer.main {name}: "
            f"{n_img} images in {secs:.1f} s (loading included), one JSON entry and finite "
            f"scores per image; K1 +{rise['fused_attention']}, K2 +"
            f"{rise['fused_filter_sample']}; first caption [{first['generated_captions'][0][:40]!r}]")

    # the beam call alone: 64 images x beam 5 x 67 tokens, one chunk of 320 rows
    with torch.no_grad():
        prompt = loaded.prefix_from_pixels(torch.from_numpy(pixels))

    def beam_call():
        return beam_search_batched(loaded.lm_decode, prompt, beam_size=BEAM,
                                   max_new_tokens=BEAM_NEW, stop_token_id=STOP,
                                   device="cuda")

    # warm-up: the same call with each step's selection recorded
    traced, card_sel, _ = traced_beam(torch, loaded.lm_decode, prompt, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = beam_call()
    texts = best_beam_texts(out, loaded.tokenizer)
    beam_s = time.perf_counter() - t0
    check(len(texts) == INFER_IMAGES and bool(torch.isfinite(out["scores"]).all()),
          "beam call: wrong number of captions or non-finite scores")
    check(torch.equal(traced["tokens"], out["tokens"]),
          "the traced beam call on the card gave other tokens than the timed one")
    flips, cpu_s = check_beam_vs_cpu(torch, loaded, prompt, out, card_sel)
    # one no-beam image call (the sweep's 9 captions), as the infer path makes it
    infer_cli.caption_pixels(loaded, scoring, pixels[:1], use_beam_search=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer_cli.caption_pixels(loaded, scoring, pixels[1:2], use_beam_search=False)
    torch.cuda.synchronize()
    nobeam_s = time.perf_counter() - t0
    rates = dict(beam_captions_per_s=INFER_IMAGES / beam_s, beam_call_s=beam_s,
                 nobeam_image_call_s=nobeam_s,
                 nobeam_captions_per_s=len(TOP_P_SWEEP) / nobeam_s, beam_flips=flips)
    say(f"(f) on {card}: beam {INFER_IMAGES} images x beam {BEAM} x {BEAM_NEW} tokens "
        f"({INFER_IMAGES * BEAM} rows): {beam_s * 1e3:.1f} ms = {rates['beam_captions_per_s']:.2f} captions/s; "
        f"no-beam image call (9 top-p rows x 75 steps, scorer included): "
        f"{nobeam_s * 1e3:.1f} ms = {rates['nobeam_captions_per_s']:.2f} captions/s; "
        f"CPU comparison {cpu_s:.1f} s")
    prof = profile_call(torch, "(f) beam", beam_call, beam_s * 1e3)
    rates.update(busy_share=prof["busy_ms"] / prof["wall_ms"],
                 launches_per_step=prof["launches"] / BEAM_NEW)
    say(f"(f) beam call on {card}: {prof['launches'] / BEAM_NEW:.1f} kernel launches per "
        f"beam step ({prof['launches']} in {BEAM_NEW} steps and the prefill)")
    rates["target_p50"] = serve_target_p50(torch, counters, work, card)
    say(f"infer phase (f): {time.perf_counter() - t_phase:.1f} s")
    return launches, rates, dict(bundle=loaded, visual=visual, text=text)


def serve_target_p50(torch, counters, work: Path, card: str) -> dict:
    """(f5) cli.serve.main --target_p50_s on the main bundle's checkpoint:
    the slot count it prints is pick_slots_for_p50's on the stored H100
    curve (cli/serve.LATENCY_CURVE_P50_S, at its 256-slot p50), and it
    serves 64 seeded feature rows at top-p 0.8, K2 every step."""
    import contextlib
    import io

    import numpy as np

    from clipcap_tpu_torch.cli import serve as serve_cli

    target = serve_cli.LATENCY_CURVE_P50_S[256]
    want = serve_cli.pick_slots_for_p50(target)
    np.save(work / "serve_feats.npy",
            np.random.default_rng(41).normal(size=(64, 512)).astype(np.float32))
    printed = io.StringIO()
    before = counters()["fused_filter_sample"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        n = serve_cli.main(["--checkpoint_path", str(work / "ckpt"),
                            "--tokenizer_vocab_dir", str(work / "vocab"),
                            "--prefixes_npy", str(work / "serve_feats.npy"),
                            "--out_jsonl", str(work / "serve_p50.jsonl"),
                            "--target_p50_s", str(target), "--top_p", "0.8",
                            "--max_new_tokens", "24", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k2 = counters()["fused_filter_sample"] - before
    lines = [json.loads(x) for x in (work / "serve_p50.jsonl").read_text().splitlines()]
    check(f"target_p50_s={target}: serving with {want} slots" in printed.getvalue(),
          f"(f5) cli.serve --target_p50_s {target} did not pick {want} slots: "
          f"{printed.getvalue()[:200]!r}")
    check(n == 64 and len(lines) == 64 and all(0 < x["tokens"] <= 24 for x in lines),
          "(f5) cli.serve --target_p50_s: wrong JSONL")
    check(k2 > 0, "(f5) cli.serve --target_p50_s: K2 was not launched")
    say(f"(f5) cli.serve.main --target_p50_s {target} on {card}: {want} slots from the stored "
        f"H100 curve {serve_cli.LATENCY_CURVE_P50_S}, 64 requests at top-p 0.8 in {secs:.1f} s "
        f"(loading included), K2 +{k2}")
    return dict(target_p50_s=target, slots=want, s=secs, k2_launches=k2)


# --- 7. the evaluate path ------------------------------------------------------------

EVAL_IMAGES, EVAL_CHUNK, EVAL_CAPTIONS = 16, 8, 5
# cli/evaluate.py's samplers: the no-beam sweep, and the CLIP-guided tree
# (branching 2, look-ahead 4, repetition penalty 1.2, 75 tokens)
EVAL_TOP_P, CG_BRANCH, CG_LOOK, CG_MAX = (0.1, 0.2), 2, 4, 75
CAPTION_WORDS = ("a", "the", "two", "cat", "dog", "man", "woman", "bus", "plate", "red",
                 "small", "sits", "runs", "on", "near", "with", "street", "table", "field",
                 "of", "food", "is", "standing", "next", "to")
# the bf16 loss against the f32 loss: |d CE| <= 2 max|d logit|, and a logit
# computed in bf16 through the encoder, the mapper and GPT-2 lies within
# BF16_LOGIT_STEPS relative bf16 steps (2^-8) of the logits' scale: the
# CPU tests hold GPT-2 alone within 4 (tests/test_torch_gpt2_dtypes.py),
# and the pipeline stacks three such stages and the pixels' rounding
BF16_LOGIT_STEPS = 16


def write_coco(folder: Path, n: int, seed: int) -> None:
    """n seeded JPEGs (write_jpegs) under folder/images and a COCO-format
    folder/captions.json with EVAL_CAPTIONS seeded lower-case captions per
    image, which byte-level BPE (GPT-2's and CLIP's) encodes whatever the
    merges."""
    import numpy as np

    write_jpegs(folder / "images", n, seed)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i in range(n):
        name = f"img{i:03d}.jpg"
        images.append({"id": i, "file_name": name, "coco_url": f"http://images.invalid/{name}"})
        for j in range(EVAL_CAPTIONS):
            words = rng.choice(CAPTION_WORDS, size=int(rng.integers(6, 13)))
            annotations.append({"image_id": i, "id": i * EVAL_CAPTIONS + j,
                                "caption": " ".join(words) + "."})
    (folder / "captions.json").write_text(json.dumps({"images": images,
                                                      "annotations": annotations}))


def traced_clip_guided(torch, bundle, scoring, pixels, images, device: str):
    """The CLIP-guided sampler's decode of these images
    (ClipGuidedCaptionSampler.sample_batch's inputs into
    generate_clip_guided_tokens) with each tree chunk's near-ties recorded:
    every top-k takes one pick more than asked (the first picks do not
    change), which gives each row's gap between its k-th and (k+1)-th
    logit, and each image's choice records the gap between its best CLIP
    score and the best one below it (exactly equal scores belong to
    candidates that decode to the same text, such as byte tokens that
    decode to the same replacement characters; argmax takes the first of
    them on either device). Returns (each image's committed ids, {"topk": per chunk
    each image's smallest top-k gap, "clip": its CLIP gap}, inf once the
    image is done)."""
    import numpy as np

    from clipcap_tpu_torch.decode import clip_guided as CG

    n, k = pixels.shape[0], CG_BRANCH
    real = (CG._topk_iter, CG._candidates, CG._best_candidate)
    chunks = []

    def topk(x, kk):
        vals, idx = real[0](x, kk + 1)
        if x.shape[0] == n:  # level 0 of a new chunk
            chunks.append(dict(levels=[], clip=[]))
        chunks[-1]["levels"].append((vals[:, kk - 1] - vals[:, kk]).cpu())
        return vals[:, :kk], idx[:, :kk]

    def candidates(topk_levels, committed, done, *rest):
        chunks[-1]["done"] = list(done)
        return real[1](topk_levels, committed, done, *rest)

    def best(scores):
        below = scores[scores < scores.max()]
        chunks[-1]["clip"].append(float(scores.max() - below.max()) if below.size
                                  else float("inf"))
        return real[2](scores)

    CG._topk_iter, CG._candidates, CG._best_candidate = topk, candidates, best
    try:
        toks = clip_guided_tokens(torch, bundle, scoring, pixels, images, device)
    finally:
        CG._topk_iter, CG._candidates, CG._best_candidate = real
    gaps = {"topk": [], "clip": []}
    for c in chunks:
        live = [i for i in range(n) if not c["done"][i]]
        gaps["topk"].append([min(float(lv[i * k ** d:(i + 1) * k ** d].min())
                                 for d, lv in enumerate(c["levels"]))
                             if i in live else float("inf") for i in range(n)])
        gaps["clip"].append([c["clip"][live.index(i)] if i in live else float("inf")
                             for i in range(n)])
    return toks, gaps


def clip_guided_tokens(torch, bundle, scoring, pixels, images, device: str):
    """What ClipGuidedCaptionSampler.sample_batch decodes for these images,
    as token ids: the captioner's prefix of the pixels, the scorer's image
    embeddings of the PIL images, and the tree search at the evaluate
    CLI's settings."""
    import numpy as np

    from clipcap_tpu_torch.decode.clip_guided import generate_clip_guided_tokens

    with torch.no_grad():
        prefix = bundle.prefix_from_pixels(torch.from_numpy(pixels))
    embs = scoring.embed_image(np.stack([scoring.preprocess_image(im) for im in images]))
    return generate_clip_guided_tokens(bundle, scoring, embs, prefix,
                                       max_decode_length=CG_MAX, look_ahead=CG_LOOK,
                                       branching_factor=CG_BRANCH, device=device)


def evaluate_path(torch, counters, card: str, work: Path, handles: dict, c_prof: dict):
    """(g) checkpoint evaluation at full width, in f32 and bf16: a COCO
    folder of 16 seeded JPEGs with 5 captions each, the f32 checkpoint and
    the CLIP state dict of (f), and the same model cast to bf16, written by
    the port's checkpoint writer and read back (every parameter bf16 and
    bit-equal to what was written). cli.evaluate.main runs on each
    checkpoint (16 images in chunks of 8: the no-beam sweep, the CLIP-guided
    tree, CLIP scores and the validation loss), with the launch counters
    set to 0 just before the two runs and read just after. Then: the first
    chunk's loss against the port on the CPU, the CLIP-guided tokens of
    two images against the CPU (a difference only from a chunk where the
    CPU's top-k or CLIP choice is a near-tie), and per dtype the seconds
    per image, a timed and profiled CLIP-guided chunk and a profiled
    validator chunk; last, the main path's sampler call (c) on the bf16
    model beside (c)'s f32 device time."""
    import contextlib
    import io
    import math

    import numpy as np

    from clipcap_tpu_torch.cli import evaluate as eval_cli
    from clipcap_tpu_torch.cli.loading import load_captioner
    from clipcap_tpu_torch.data.coco import CocoImageDataset
    from clipcap_tpu_torch.data.preprocessing import clip_preprocess, normalize_on_device
    from clipcap_tpu_torch.eval import validator as V
    from clipcap_tpu_torch.eval.clip_scoring import ClipScoring
    from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.ops.kernels import fused_attention as FA
    from clipcap_tpu_torch.tokenizers.clip_bpe import CLIPTokenizer
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint

    t_phase = time.perf_counter()
    f32 = handles["bundle"]
    write_coco(work / "coco", EVAL_IMAGES, seed=17)
    dataset = CocoImageDataset(str(work / "coco" / "captions.json"), str(work / "coco" / "images"))
    items = [dataset[i] for i in range(EVAL_IMAGES)]
    images = [it["image"] for it in items]
    gts_by_id = dataset.get_index().get_captions_by_image_id()
    gts = [gts_by_id[it["image_entry"].id] for it in items]
    size = f32.vit_cfg.image_size
    pixels = np.stack([clip_preprocess(im, size) for im in images])
    scoring = ClipScoring(handles["visual"], handles["text"],
                          CLIPTokenizer.from_merges_file(str(work / "clip_merges.txt")))

    # the bf16 checkpoint: written by the port's writer, read back bit for bit
    t0 = time.perf_counter()
    bf16_model = copy.deepcopy(f32.model).to(torch.bfloat16)
    save_checkpoint(str(work / "ckpt_bf16"), bf16_model, f32.cap_cfg, f32.lm_cfg)
    loaded, cap_cfg, lm_cfg, vit_cfg = load_captioner(str(work / "ckpt_bf16"), device="cuda")
    io_s = time.perf_counter() - t0
    want = bf16_model.state_dict()
    for name, p in loaded.state_dict().items():
        check(p.is_cuda and p.dtype == torch.bfloat16 and want[name].dtype == torch.bfloat16
              and torch.equal(p.view(torch.int16), want[name].view(torch.int16)),
              f"bf16 checkpoint: loaded {name} is not the bf16 bits that were written")
    del want, bf16_model
    bf16 = CaptionerBundle(loaded, cap_cfg, lm_cfg, f32.tokenizer, vit_cfg=vit_cfg, device="cuda")
    say(f"(g) bf16 checkpoint: {sum(p.numel() for p in loaded.parameters()) / 1e6:.1f}M "
        f"parameters written by the port's writer and read back onto the card in {io_s:.1f} s; "
        f"every one bf16 and bit-equal to what was written")

    def args(ckpt):
        return ["--checkpoint_path", str(work / ckpt), "--tokenizer_vocab_dir", str(work / "vocab"),
                "--clip_model", "ViT-B/32", "--clip_checkpoint", str(work / "clip.pt"),
                "--clip_merges", str(work / "clip_merges.txt"),
                "--valid_json_path", str(work / "coco" / "captions.json"),
                "--image_folder_path", str(work / "coco" / "images"),
                "--max_samples", str(EVAL_IMAGES), "--eval_batch_size", str(EVAL_CHUNK),
                "--device", "cuda"]

    # the evaluate path, its launches counted; each validator chunk timed
    real_process, chunk_s = V.CocoCaptionValidator.process, []

    def timed_process(self, bundle, batch):
        t0 = time.perf_counter()
        real_process(self, bundle, batch)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    counters(reset=True)
    for d in FA.LAUNCHES_BY_DTYPE:
        FA.LAUNCHES_BY_DTYPE[d] = 0
    runs = {}
    V.CocoCaptionValidator.process = timed_process
    try:
        for name, ckpt in (("f32", "ckpt"), ("bf16", "ckpt_bf16")):
            before, by_dtype = counters(), dict(FA.LAUNCHES_BY_DTYPE)
            chunk_s.clear()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                results = eval_cli.main(args(ckpt))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = counters()
            runs[name] = dict(results=results, printed=out.getvalue(), secs=secs,
                              chunk_s=list(chunk_s),
                              rise={k: after[k] - before[k] for k in after},
                              k1_dtype={d: FA.LAUNCHES_BY_DTYPE[d] - by_dtype[d]
                                        for d in by_dtype})
    finally:
        V.CocoCaptionValidator.process = real_process
    launches = counters()

    n_chunks = math.ceil(EVAL_IMAGES / EVAL_CHUNK)
    layers = f32.vit_cfg.layers
    # per chunk: the no-beam and the CLIP-guided prefix encodes, the loss's
    # encode, the scorer's batch encode for CLIP-guided, and one scorer
    # encode per image and sampler
    encodes = {"captioner": 3 * n_chunks, "scorer": n_chunks * (1 + 2 * EVAL_CHUNK)}
    for name, r in runs.items():
        printed = json.loads(r["printed"][r["printed"].rindex("\n{") + 1:])
        check(sorted(printed) == ["clip_score", "sampler_scores", "validation_loss"]
              and sorted(printed["sampler_scores"]) == ["clip_guided", "nobeam"],
              f"({name}) evaluate printed {sorted(printed)}")
        check(math.isfinite(printed["validation_loss"]) and math.isfinite(printed["clip_score"])
              and all(math.isfinite(v) for s in printed["sampler_scores"].values()
                      for v in s.values()),
              f"({name}) a printed score is not finite: {printed}")
        check(len(r["results"]["captions"]) == EVAL_IMAGES and len(r["chunk_s"]) == n_chunks,
              f"({name}) {len(r['results']['captions'])} images in {len(r['chunk_s'])} chunks")
        want_k1 = layers * (encodes["captioner"] + encodes["scorer"])
        want_k2 = 75 * n_chunks  # NoBeamCaptionSampler: 75 steps per sample_batch
        want_bf16 = layers * encodes["captioner"] if name == "bf16" else 0
        check(r["rise"]["fused_attention"] == want_k1,
              f"({name}) K1 launched {r['rise']['fused_attention']} times, want {want_k1}")
        check(r["k1_dtype"]["bfloat16"] == want_bf16,
              f"({name}) K1 launched {r['k1_dtype']['bfloat16']} times in bf16, want {want_bf16}")
        check(r["rise"]["fused_filter_sample"] == want_k2,
              f"({name}) K2 launched {r['rise']['fused_filter_sample']} times, want {want_k2}")
        r["printed_json"] = printed
        r["s_per_image"] = sum(r["chunk_s"]) / EVAL_IMAGES
        say(f"(g) cli.evaluate.main {name}: {EVAL_IMAGES} images in chunks of {EVAL_CHUNK} in "
            f"{r['secs']:.1f} s (loading included); validator {r['s_per_image']:.3f} s per image "
            f"(chunks {', '.join(f'{s:.2f}' for s in r['chunk_s'])} s); validation_loss "
            f"{printed['validation_loss']:.6f}, clip_score {printed['clip_score']:.6f}, "
            f"nobeam CIDEr {printed['sampler_scores']['nobeam']['CIDEr']:.4f}, clip_guided "
            f"CIDEr {printed['sampler_scores']['clip_guided']['CIDEr']:.4f}; K1 "
            f"+{r['rise']['fused_attention']} ({r['k1_dtype']['bfloat16']} in bf16), K2 "
            f"+{r['rise']['fused_filter_sample']}")

    # the validation loss: each chunk's again on the card, the first against the CPU
    t_checks = time.perf_counter()
    chunks = [range(i, min(i + EVAL_CHUNK, EVAL_IMAGES)) for i in range(0, EVAL_IMAGES, EVAL_CHUNK)]
    card_losses = {name: [V.CocoCaptionValidator.caption_losses(b, pixels[list(c)],
                                                                [gts[i] for i in c])
                          for c in chunks] for name, b in (("f32", f32), ("bf16", bf16))}
    for name, per_chunk in card_losses.items():
        mean = float(np.mean([x for c in per_chunk for x in c]))
        check(math.isclose(mean, runs[name]["printed_json"]["validation_loss"], rel_tol=1e-6),
              f"({name}) the chunks' losses average {mean}, evaluate printed "
              f"{runs[name]['printed_json']['validation_loss']}")
    cpu = CaptionerBundle(copy.deepcopy(f32.model).cpu(), f32.cap_cfg, f32.lm_cfg, f32.tokenizer,
                          vit_cfg=f32.vit_cfg, device="cpu")
    first = list(chunks[0])
    cpu_loss = V.CocoCaptionValidator.caption_losses(cpu, pixels[first], [gts[i] for i in first])
    err = assert_close(torch, torch.tensor(card_losses["f32"][0]), torch.tensor(cpu_loss),
                       *CARD_VS_CPU, "(g) first chunk's validation losses card vs CPU")
    # the bf16 tolerance, from the f32 logits' scale on the first chunk's first round
    enc = [f32.tokenizer.encode_text(g[0], add_bos=True, add_eos=True) for g in gts[:EVAL_CHUNK]]
    toks = torch.zeros(len(enc), max(len(t) for t in enc), dtype=torch.long)
    for j, t in enumerate(enc):
        toks[j, :len(t)] = torch.tensor(t)
    with torch.no_grad():
        scale = float(f32.forward(toks, f32.encode_image(torch.from_numpy(pixels[first])))
                      .abs().max())
    loss_tol = 2 * BF16_LOGIT_STEPS * 2.0 ** -8 * scale
    loss_diff = abs(runs["bf16"]["printed_json"]["validation_loss"]
                    - runs["f32"]["printed_json"]["validation_loss"])
    check(loss_diff <= loss_tol, f"(g) bf16 validation_loss is {loss_diff:.4g} from f32's, "
          f"beyond {loss_tol:.4g}")
    say(f"(g) validation loss: the first chunk's {len(cpu_loss)} losses on the card vs the CPU, max "
        f"abs err {err:.3e} (atol/rtol {CARD_VS_CPU[0]}); bf16 {loss_diff:.4g} from f32 (tolerance "
        f"2 x {BF16_LOGIT_STEPS} x 2^-8 x max|logit| {scale:.3f} = {loss_tol:.4g})")

    # CLIP-guided: the first chunk on the card, timed and profiled per dtype;
    # images 0-1 against the CPU in f32
    first_imgs, first_pix = [images[i] for i in first], pixels[first]
    timing = {}
    t_checks = time.perf_counter() - t_checks
    t_timing = time.perf_counter()
    for name, b in (("f32", f32), ("bf16", bf16)):  # warm from the evaluate runs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = clip_guided_tokens(torch, b, scoring, first_pix, first_imgs, "cuda")
        torch.cuda.synchronize()
        cg_s = time.perf_counter() - t0
        special = set(b.tokenizer.all_special_ids)
        texts = [b.tokenizer.decode_tokens([t for t in c if t not in special]) for c in toks]
        want = [e["sampling_results"][1]["captions"][0]["caption"]
                for e in runs[name]["results"]["captions"][:EVAL_CHUNK]]
        check(texts == want, f"({name}) the CLIP-guided chunk again gave other captions than "
              f"cli.evaluate")
        tree_chunks = math.ceil(max(len(c) for c in toks) / CG_LOOK)
        prof = profile_call(torch, f"(g) {name} clip-guided chunk", lambda: clip_guided_tokens(
            torch, b, scoring, first_pix, first_imgs, "cuda"), cg_s * 1e3)
        validator = eval_cli.build_validator(b, scoring, dataset, EVAL_TOP_P, CG_BRANCH, CG_LOOK)
        vprof = profile_call(torch, f"(g) {name} validator chunk",
                             lambda: validator.process(b, [items[i] for i in first]),
                             runs[name]["chunk_s"][0] * 1e3)
        timing[name] = dict(s_per_image=runs[name]["s_per_image"], evaluate_s=runs[name]["secs"],
                            clip_guided_chunk_s=cg_s, tree_chunks=tree_chunks,
                            clip_guided_launches=prof["launches"],
                            launches_per_tree_chunk=prof["launches"] / tree_chunks,
                            clip_guided_busy_share=prof["busy_ms"] / prof["wall_ms"],
                            validator_chunk_busy_share=vprof["busy_ms"] / vprof["wall_ms"],
                            validator_chunk_busy_ms=vprof["busy_ms"],
                            validation_loss=runs[name]["printed_json"]["validation_loss"])
        say(f"(g) {name} on {card}: CLIP-guided chunk ({EVAL_CHUNK} images, branching "
            f"{CG_BRANCH}, look-ahead {CG_LOOK}, {tree_chunks} tree chunks): {cg_s * 1e3:.1f} ms, "
            f"{prof['launches']} launches = {prof['launches'] / tree_chunks:.1f} per tree chunk; "
            f"validator chunk busy {vprof['busy_ms']:.1f} ms = "
            f"{100 * vprof['busy_ms'] / vprof['wall_ms']:.1f}% of its profiled wall")
        if name == "f32":
            card_toks = toks
    t_timing = time.perf_counter() - t_timing
    cpu_scoring = ClipScoring(copy.deepcopy(handles["visual"]).cpu(),
                              copy.deepcopy(handles["text"]).cpu(), scoring.tokenizer)
    t0 = time.perf_counter()
    cpu_toks, gaps = traced_clip_guided(torch, cpu, cpu_scoring, first_pix[:2], first_imgs[:2],
                                        "cpu")
    cpu_s = time.perf_counter() - t0
    flips = 0
    for i in range(2):
        if card_toks[i] == cpu_toks[i]:
            continue
        chunk = min(first_difference(card_toks[i], cpu_toks[i]) // CG_LOOK,
                    len(gaps["topk"]) - 1)
        gap = min(gaps["topk"][chunk][i], gaps["clip"][chunk][i])
        check(gap < FLIP_GAP, f"(g) CLIP-guided image {i} differs from the CPU in tree chunk "
              f"{chunk}, where the CPU's smallest top-k or CLIP gap is {gap:.3e} (>= {FLIP_GAP})")
        flips += 1
    say(f"(g) CLIP-guided images 0-1 ({EVAL_CHUNK}-image chunk on the card) against the port on "
        f"the CPU: near-tie flips {flips}; smallest CPU gap per tree chunk, top-k boundary "
        f"{min(g for row in gaps['topk'] for g in row):.3e}, best CLIP score to the next "
        f"lower one {min(g for row in gaps['clip'] for g in row):.3e}; CPU {cpu_s:.1f} s")
    del cpu, cpu_scoring

    # the main path's sampler call (c) on the bf16 model: 8 images x 9 top-p, 75 steps
    gen = torch.Generator(device="cuda").manual_seed(3)
    pix8 = normalize_on_device(torch.rand(8, 3, size, size, generator=gen, device="cuda"))
    sampler = NoBeamCaptionSampler(top_p_values=TOP_P_SWEEP, device="cuda")
    caps = sampler.sample_batch(bf16, pix8)  # warm
    check(len(caps) == 8 and all(len(c) == len(TOP_P_SWEEP) for c in caps),
          "(g) bf16 sample_batch returned the wrong number of captions")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.sample_batch(bf16, pix8)
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    prof = profile_call(torch, "(g) bf16 (c)", lambda: sampler.sample_batch(bf16, pix8), c_s * 1e3)
    timing["bf16_main_sampler"] = dict(wall_ms=c_s * 1e3, busy_ms=prof["busy_ms"],
                                       f32_busy_ms=c_prof["busy_ms"],
                                       captions_per_s=8 * len(TOP_P_SWEEP) / c_s)
    say(f"(g) main-path sampler call (c) on {card}, 8 images x {len(TOP_P_SWEEP)} top-p x 75 "
        f"steps: bf16 device busy {prof['busy_ms']:.1f} ms (wall {c_s * 1e3:.1f} ms = "
        f"{8 * len(TOP_P_SWEEP) / c_s:.2f} captions/s) beside f32 (c) {c_prof['busy_ms']:.1f} ms")
    say(f"evaluate phase (g): {time.perf_counter() - t_phase:.1f} s (the two evaluate runs "
        f"{runs['f32']['secs'] + runs['bf16']['secs']:.1f} s, the loss checks {t_checks:.1f} s, "
        f"the timed and profiled chunks {t_timing:.1f} s, the CPU's CLIP-guided {cpu_s:.1f} s)")
    return launches, timing


# --- 8. the training path -----------------------------------------------------------

TRAIN_BATCH, TRAIN_STEPS, RESUME_AT = 16, 12, 7  # `_latest` at step 7 only
SHARD_ROWS, SHARD_WIDTH, SHARD_TOKENS = (100, 120), 512, 40  # 220 rows: 13 batches of 16
PIXEL_STEPS, VISUAL_STEPS, VAL_IMAGES = 3, 2, 8
TIMED_STEPS, CPU_BATCH = 5, 4
# the next step's loss after a resume against the uninterrupted run's: the
# forward from bit-equal parameters is deterministic on the card
RESUME_RTOL = 1e-6


def write_shards(folder: Path, seed: int) -> None:
    """Seeded {prefixes,tokens}/*.npy shards in the preprocess tool's layout:
    SHARD_ROWS rows per file (a batch of 16 straddles the boundary), f32
    prefixes of CLIP ViT-B/32's width, GPT-2 ids padded with -1 after 8-40
    tokens."""
    import numpy as np

    from clipcap_tpu_torch.data.npy_reader import write_npy_shard

    rng = np.random.default_rng(seed)
    for i, n in enumerate(SHARD_ROWS):
        write_npy_shard(folder / "prefixes" / f"{i:03d}.npy",
                        rng.normal(size=(n, SHARD_WIDTH)).astype(np.float32))
        tokens = rng.integers(1, 50256, size=(n, SHARD_TOKENS)).astype(np.int64)
        lengths = rng.integers(8, SHARD_TOKENS + 1, size=n)
        tokens[np.arange(SHARD_TOKENS)[None] >= lengths[:, None]] = -1
        write_npy_shard(folder / "tokens" / f"{i:03d}.npy", tokens)


# a train state that the JAX package saved and consolidated
# (tests/fixtures/generate_jax_train_state.py: a tiny GPT-2 captioner, 2
# steps, bf16 compute, the CLI's AutoClip ring of 50,000 and weight decay
# 0.01), and the cli.train flags of its configuration (that script's
# CLI_ARGS); resumed, it takes steps 3 and 4
JAX_STATE = ROOT / "tests" / "fixtures" / "jax_train_state"
JAX_STATE_ARGS = ["--prefix_size", "8", "--prefix_length", "4", "--clip_prefix_length", "2",
                  "--num_layers", "1", "--num_attention_heads", "2", "--batch_size", "4",
                  "--epochs", "1", "--max_steps", "4", "--optimizer_lr", "1e-2",
                  "--scheduler_warmup_steps", "1"]


def resume_jax_state(torch, work: Path, card: str):
    """(h3) cli.train.main --resume_from the committed JAX train state, on
    the card and on the CPU, over the same seeded shards of 4 batches of 4
    (the first two skipped as consumed): steps 3 and 4 logged, finite, and
    the card's losses within CARD_VS_CPU of the CPU's. Returns the seconds
    and the figures."""
    import contextlib
    import math

    import numpy as np

    from clipcap_tpu_torch.cli import train as train_cli
    from clipcap_tpu_torch.data.npy_reader import write_npy_shard

    rng = np.random.default_rng(23)
    shards = work / "jax_state_shards"
    tokens = rng.integers(1, 64, size=(16, 9)).astype(np.int64)
    tokens[:, -2:] = -1
    write_npy_shard(shards / "prefixes" / "0.npy", rng.normal(size=(16, 8)).astype(np.float32))
    write_npy_shard(shards / "tokens" / "0.npy", tokens)
    t0 = time.perf_counter()

    def run(device):
        out = work / f"train_jax_state_{device}"
        with open(work / f"train_jax_state_{device}.log", "w") as log, \
                contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
            res = train_cli.main(JAX_STATE_ARGS + [
                "--resume_from", str(JAX_STATE), "--prefix_data_path", str(shards),
                "--lm_config_json", str(JAX_STATE / "lm_config.json"),
                "--tokenizer_vocab_dir", str(work / "vocab"), "--output_dir", str(out),
                "--log_every_n_steps", "1", "--save_every_epochs", "0",
                "--save_every_steps", "0", "--device", device])
        losses, _ = train_metrics(out)
        check(sorted(losses) == [3, 4] and int(res["state"].step) == 4
              and all(math.isfinite(v) for v in losses.values()),
              f"(h3) the resume from the JAX train state on {device} logged {losses}")
        shutil.rmtree(out)
        return [losses[3], losses[4]]

    card_l, cpu_l = run("cuda"), run("cpu")
    secs = time.perf_counter() - t0
    err = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    check(all(abs(a - b) <= CARD_VS_CPU[0] + CARD_VS_CPU[1] * abs(b)
              for a, b in zip(card_l, cpu_l)),
          f"(h3) the resumed JAX state's losses on the card {card_l} against the CPU {cpu_l}")
    say(f"(h3) cli.train.main --resume_from a JAX train state ({JAX_STATE.name}, step 2) on "
        f"{card}: steps 3-4, losses {card_l[0]!r}, {card_l[1]!r}; the CPU's {cpu_l[0]!r}, "
        f"{cpu_l[1]!r} (|diff| {err:.3e}, atol/rtol {CARD_VS_CPU[0]}); both runs {secs:.1f} s")
    return secs, dict(card_losses=card_l, cpu_losses=cpu_l, card_vs_cpu=err)


def train_metrics(out: Path):
    """metrics.jsonl of a cli.train run: the logged loss by step, and every line."""
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r["loss"] for r in lines if "loss" in r}, lines


def timed_train_step(torch, counters, label, step, state, batch):
    """s per step of `step` on `batch` (a warm-up of 2, then TIMED_STEPS
    steps between synchronizations), K1 launches per step, and a profile
    (device activity only) of one more step."""
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    before = counters()["fused_attention"]
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / TIMED_STEPS
    k1 = (counters()["fused_attention"] - before) / TIMED_STEPS
    check(bool(torch.isfinite(m["loss"])), f"({label}) non-finite loss")
    prof = profile_call(torch, f"(h) {label} train step", lambda: step(state, batch), s_step * 1e3)
    return state, dict(s_per_step=s_step, steps_per_s=1 / s_step, launches_per_step=prof["launches"],
                       busy_share=prof["busy_ms"] / (s_step * 1e3), busy_ms=prof["busy_ms"],
                       k1_per_step=k1)


def train_path(torch, counters, card: str, work: Path) -> tuple:
    """(h) training at full width through cli.train.main on the card: CLIP
    ViT-B/32 at 224 px, the CLI's default mapper (8 layers, 768 wide) with
    --prefix_size 512, GPT-2 124M, seeded weights, batch 16, the CLI's
    defaults (bf16 compute, remat, AutoClip, warmup 2000, AdamW with weight
    decay 0.01).
    (h1) seeded prefix shards in two files: 12 steps training mapper and LM
    (a `_latest` checkpoint at step 7 and the final one), a resume from
    step 7, and 12 prefix-only steps.
    (h2) (g)'s COCO folder with (f)'s OpenAI-layout CLIP ViT-B/32: 3 steps
    with one validation over 8 images scored by (f)'s CLIP, then 2 steps
    with --train_visual_encoder; the launch counters set to 0 just before
    these two runs and read just after.
    Then make_train_step on its own: s per step, launches and busy share
    per path, the encoder's gradients finite, and one f32 step (TF32 off)
    on the card against the port on the CPU, and the bf16 step's loss
    against f32's. Returns the (h2) launches and the measurements."""
    import contextlib
    import math

    import numpy as np

    from clipcap_tpu_torch.cli import train as train_cli
    from clipcap_tpu_torch.cli.loading import load_captioner_bundle, load_state_dict
    from clipcap_tpu_torch.core.config import TrainConfig, ViTConfig
    from clipcap_tpu_torch.data.coco import BatchLoader, CocoCaptionDataset
    from clipcap_tpu_torch.data.preprocessing import clip_preprocess
    from clipcap_tpu_torch.data.token_prefix import TokenPrefixDataset
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.tokenizers import create_tokenizer
    from clipcap_tpu_torch.tools import import_weights as W
    from clipcap_tpu_torch.train import train_step as TTS
    from clipcap_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    write_shards(work / "shards", seed=19)
    common = ["--tokenizer_vocab_dir", str(work / "vocab"), "--batch_size", str(TRAIN_BATCH),
              "--epochs", "1", "--log_every_n_steps", "1", "--save_every_epochs", "0",
              "--seed", "0", "--device", "cuda", "--prefix_size", str(SHARD_WIDTH)]
    shards = common + ["--prefix_data_path", str(work / "shards"), "--max_steps", str(TRAIN_STEPS)]
    coco = work / "coco"
    pixels = common + ["--input_dataset", str(coco / "captions.json"),
                       "--image_folder_path", str(coco / "images"),
                       "--visual_encoder_type", "CLIP", "--visual_encoder_model_variant",
                       "ViT-B/32", "--visual_checkpoint", str(work / "clip.pt"),
                       "--save_every_steps", "0"]
    secs = {}

    def run(name, args):
        out = work / f"train_{name}"
        t0 = time.perf_counter()
        with open(work / f"train_{name}.log", "w") as log, contextlib.redirect_stdout(log), \
                contextlib.redirect_stderr(log):
            res = train_cli.main(args + ["--output_dir", str(out)])
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        losses, lines = train_metrics(out)
        check(all(math.isfinite(v) for v in losses.values()), f"(h) {name}: a loss is not finite")
        return res, out, losses, lines

    def fresh(args):
        cap_cfg, lm_cfg, _ = train_cli.build_configs(train_cli.build_argparser().parse_args(args))
        return Captioner(cap_cfg, lm_cfg, device="cuda", seed=0)

    # (h1) 12 steps, mapper and LM trained: the logs, the final checkpoint, the resume
    res, full_dir, losses, lines = run("full", shards + ["--save_every_steps", str(RESUME_AT)])
    model = res["state"].model
    check(sorted(losses) == list(range(1, TRAIN_STEPS + 1)) and len(lines) == TRAIN_STEPS
          and all({"loss", "grad_norm_pre_clip", "grad_norm_post_clip", "autoclip_value",
                   "steps_per_sec", "epoch", "step"} <= set(r) for r in lines),
          f"(h1) metrics.jsonl holds {len(lines)} lines with steps {sorted(losses)}")
    init = fresh(shards)
    moved = {sub: any(not torch.equal(p.float(), q) for p, q in
                      zip(getattr(model, sub).parameters(), getattr(init, sub).parameters()))
             for sub in ("mapper", "lm")}
    check(all(moved.values()), f"(h1) parameters that did not move: {moved}")
    del init
    loaded = load_captioner_bundle(str(full_dir / "demo_model_final"), str(work / "vocab"),
                                   device="cuda")
    want = model.state_dict()
    for name, p in loaded.model.state_dict().items():
        check(p.dtype == want[name].dtype and torch.equal(p, want[name]),
              f"(h1) the final checkpoint's {name} differs from the trained parameter")
    del loaded, want
    res_r, resumed_dir, r_losses, _ = run("resumed", shards + [
        "--save_every_steps", "0", "--resume_from", str(full_dir / "demo_model_latest")])
    check(sorted(r_losses) == list(range(RESUME_AT + 1, TRAIN_STEPS + 1)),
          f"(h1) the resumed run logged steps {sorted(r_losses)}")
    nxt = RESUME_AT + 1
    resume_err = abs(r_losses[nxt] - losses[nxt])
    check(resume_err <= RESUME_RTOL * abs(losses[nxt]),
          f"(h1) step {nxt} after the resume has loss {r_losses[nxt]}, the uninterrupted run "
          f"{losses[nxt]}")
    later = max(abs(r_losses[i] - losses[i]) for i in r_losses)
    param_diff = max(float((p.detach().float() - q.detach().float()).abs().max()) for p, q in
                     zip(res_r["state"].model.parameters(), model.parameters()))
    say(f"(h1) cli.train.main, prefix shards ({'+'.join(map(str, SHARD_ROWS))} rows in two "
        f"files), {TRAIN_STEPS} steps of {TRAIN_BATCH}: {secs['full']:.1f} s (two checkpoints "
        f"included); losses {losses[1]:.4f} .. {losses[TRAIN_STEPS]:.4f}; mapper and LM moved; "
        f"the final checkpoint reads back bit for bit; resumed from step {RESUME_AT} "
        f"({secs['resumed']:.1f} s): step {nxt} loss {r_losses[nxt]!r} against {losses[nxt]!r} "
        f"(|diff| {resume_err:.3e}, allowed {RESUME_RTOL} relative), steps {nxt}-{TRAIN_STEPS} "
        f"within {later:.3e}, final parameters within {param_diff:.3e}")
    del res, res_r, model
    shutil.rmtree(full_dir), shutil.rmtree(resumed_dir)

    res, po_dir, po_losses, _ = run("prefix_only", shards + ["--prefix_only",
                                                             "--save_every_steps", "0"])
    model, init = res["state"].model, fresh(shards + ["--prefix_only"])
    for (name, p), q in zip(model.lm.named_parameters(), init.lm.parameters()):
        check(p.dtype == torch.bfloat16 and torch.equal(p, q.to(torch.bfloat16)),
              f"(h1) --prefix_only changed the LM's {name}")
    check(any(not torch.equal(p, q) for p, q in zip(model.mapper.parameters(),
                                                    init.mapper.parameters())),
          "(h1) --prefix_only: the mapper did not move")
    say(f"(h1) --prefix_only, {TRAIN_STEPS} steps: {secs['prefix_only']:.1f} s; losses "
        f"{po_losses[1]:.4f} .. {po_losses[TRAIN_STEPS]:.4f}; the LM (bf16) bit for bit as "
        f"initialised, the mapper moved")
    del res, model, init
    shutil.rmtree(po_dir)

    secs["jax_state"], jax_state = resume_jax_state(torch, work, card)

    # (h2) pixels: 3 steps and a validation, then 2 steps with the encoder trained
    real_make, per_step = trainer.make_train_step, []

    def counted_make(*a, **kw):
        step = real_make(*a, **kw)

        def counted(state, batch):
            before = counters()
            out = step(state, batch)
            torch.cuda.synchronize()
            after = counters()
            per_step.append({k: after[k] - before[k] for k in after})
            return out
        return counted

    vit_cfg = ViTConfig.clip_variant("ViT-B/32")
    clip_vit = {k: torch.from_numpy(np.asarray(v)) for k, v in W.clip_vit_from_openai_state_dict(
        load_state_dict(str(work / "clip.pt")), vit_cfg).items()}
    runs = {}
    torch.cuda.synchronize()
    counters(reset=True)
    trainer.make_train_step = counted_make
    try:
        for name, extra in (
                ("pixels", ["--max_steps", str(PIXEL_STEPS),
                            "--valid_json_path", str(coco / "captions.json"),
                            "--valid_image_folder_path", str(coco / "images"),
                            "--limit_val_batches", str(VAL_IMAGES),
                            "--val_clip_checkpoint", str(work / "clip.pt"),
                            "--clip_merges", str(work / "clip_merges.txt"),
                            "--validation_interval", str(PIXEL_STEPS)]),
                ("train_visual", ["--max_steps", str(VISUAL_STEPS), "--train_visual_encoder"])):
            per_step.clear()
            before = counters()
            res, out, r_losses, lines = run(name, pixels + extra)
            after = counters()
            visual = {n: p for n, p in res["state"].model.visual.named_parameters()}
            runs[name] = dict(steps=list(per_step), losses=r_losses, lines=lines,
                              rise={k: after[k] - before[k] for k in after},
                              moved=[n for n, p in visual.items() if not torch.equal(
                                  p.float().cpu(), clip_vit[n].to(p.dtype).float())],
                              finite=all(bool(torch.isfinite(p).all()) for p in visual.values()),
                              dtypes={str(p.dtype) for p in visual.values()})
            del res, visual
            shutil.rmtree(out)
    finally:
        trainer.make_train_step = real_make
    launches = counters()

    layers = vit_cfg.layers
    for name, r in runs.items():
        n_steps = PIXEL_STEPS if name == "pixels" else VISUAL_STEPS
        # remat recomputes each checkpointed block's forward in the backward
        want_k1 = layers * (2 if name == "train_visual" else 1)
        check(len(r["steps"]) == n_steps and sorted(r["losses"]) == list(range(1, n_steps + 1)),
              f"(h2) {name}: {len(r['steps'])} steps, losses at {sorted(r['losses'])}")
        check(all(st["fused_attention"] == want_k1 and st["fused_filter_sample"] == 0
                  for st in r["steps"]),
              f"(h2) {name}: K1/K2 launches per step {[(st['fused_attention'], st['fused_filter_sample']) for st in r['steps']]}, want ({want_k1}, 0)")
        r["validation"] = {k: r["rise"][k] - sum(st[k] for st in r["steps"]) for k in r["rise"]}
    val = [x for x in runs["pixels"]["lines"] if "val/validation_loss" in x]
    check(len(val) == 1 and math.isfinite(val[0]["val/validation_loss"])
          and math.isfinite(val[0]["val/clip_score"]),
          f"(h2) the validation logged {val}")
    check(runs["pixels"]["validation"]["fused_filter_sample"] == 75
          and runs["pixels"]["validation"]["fused_attention"] > 0,
          f"(h2) the validation launched {runs['pixels']['validation']}, want K2 75 (one no-beam "
          f"call of 75 steps) and K1")
    check(runs["train_visual"]["validation"]["fused_attention"] == 0,
          "(h2) K1 launched outside the steps of the run without validation")
    check(not runs["pixels"]["moved"] and runs["pixels"]["dtypes"] == {"torch.bfloat16"},
          f"(h2) the frozen encoder moved ({runs['pixels']['moved'][:3]}) or is not bf16")
    check(len(runs["train_visual"]["moved"]) > 0 and runs["train_visual"]["finite"]
          and runs["train_visual"]["dtypes"] == {"torch.float32"},
          "(h2) --train_visual_encoder: the encoder did not move, or is not finite f32")
    say(f"(h2) cli.train.main on (g)'s COCO folder with (f)'s CLIP ViT-B/32: {PIXEL_STEPS} steps "
        f"and one validation of {VAL_IMAGES} images in {secs['pixels']:.1f} s (validation_loss "
        f"{val[0]['val/validation_loss']:.4f}, clip_score {val[0]['val/clip_score']:.4f}); K1 "
        f"{layers} per step, the validation K1 +{runs['pixels']['validation']['fused_attention']} "
        f"K2 +{runs['pixels']['validation']['fused_filter_sample']}; the frozen encoder (bf16) "
        f"unchanged. --train_visual_encoder, {VISUAL_STEPS} steps in "
        f"{secs['train_visual']:.1f} s: K1 {2 * layers} per step ({layers} forward + {layers} "
        f"recomputed under remat), {len(runs['train_visual']['moved'])} of the encoder's "
        f"parameters moved, all finite")

    # make_train_step on its own: each path's step timed and profiled
    tokenizer = create_tokenizer("gpt2", str(work / "vocab"))
    tokens_np, prefix_np = next(iter(TokenPrefixDataset(str(work / "shards"), TRAIN_BATCH)))
    prefix_batch = {"tokens": torch.tensor(tokens_np, device="cuda"),
                    "prefix": torch.tensor(prefix_np, device="cuda")}
    loader = BatchLoader(CocoCaptionDataset(str(coco / "captions.json"), str(coco / "images"),
                                            tokenizer, lambda im: clip_preprocess(im, vit_cfg.image_size),
                                            max_token_length=96), TRAIN_BATCH, seed=0)
    item = next(iter(loader))
    pixel_batch = {"tokens": torch.tensor(item["tokens"], device="cuda"),
                   "pixels": torch.tensor(item["image_tensor"], device="cuda")}
    timing = {}
    for label, args, batch, vcfg in (
            ("prefix", shards, prefix_batch, None),
            ("pixels", pixels, pixel_batch, vit_cfg),
            ("train_visual", pixels + ["--train_visual_encoder"], pixel_batch, vit_cfg)):
        cap_cfg, lm_cfg, kw = train_cli.build_configs(train_cli.build_argparser().parse_args(args))
        train_cfg = TrainConfig(total_steps=1000, **kw)
        state, tx = TTS.create_train_state(0, cap_cfg, lm_cfg, train_cfg, vit_cfg=vcfg,
                                           device="cuda")
        step = TTS.make_train_step(cap_cfg, lm_cfg, train_cfg, tx, visual_cfg=vcfg)
        state, timing[label] = timed_train_step(torch, counters, label, step, state, batch)
        if label == "train_visual":
            _, grads, params = TTS.compute_grads(state.model, batch, tx.names, cap_cfg, train_cfg,
                                                 vcfg)
            vis = [g for n, g in zip(tx.names, grads) if n.startswith("visual.")]
            check(len(vis) == len(list(state.model.visual.parameters()))
                  and all(bool(torch.isfinite(g).all()) for g in vis)
                  and any(bool(g.abs().max() > 0) for g in vis),
                  "(h) --train_visual_encoder: the encoder's gradients are not finite and nonzero")
        t = timing[label]
        say(f"(h) {label} train step on {card}, batch {TRAIN_BATCH}: {t['s_per_step'] * 1e3:.1f} ms "
            f"= {t['steps_per_s']:.2f} steps/s; {t['launches_per_step']} launches per step, device "
            f"busy {t['busy_ms']:.1f} ms = {100 * t['busy_share']:.1f}% of the step; K1 "
            f"{t['k1_per_step']:.0f} per step")
        del state, tx, step

    # the card against the CPU: one f32 step (TF32 off) from the same weights; bf16's loss
    cap_cfg, lm_cfg, kw = train_cli.build_configs(train_cli.build_argparser().parse_args(shards))
    small = {k: v[:CPU_BATCH] for k, v in prefix_batch.items()}
    first = {}
    for name, bf16, device in (("f32", False, "cuda"), ("cpu", False, "cpu"),
                               ("bf16", True, "cuda")):
        train_cfg = TrainConfig(total_steps=1000, **{**kw, "bf16_compute": bf16})
        model = Captioner(cap_cfg, lm_cfg, device="cuda", seed=0).to(device)
        state, tx = TTS.create_train_state(0, cap_cfg, lm_cfg, train_cfg, model=model,
                                           device=device)
        t0 = time.perf_counter()
        _, m = TTS.make_train_step(cap_cfg, lm_cfg, train_cfg, tx)(
            state, {k: v.to(device) for k, v in small.items()})
        first[name] = {k: float(v) for k, v in m.items()}
        first[name]["s"] = time.perf_counter() - t0
        if name == "f32":
            with torch.no_grad():
                scale = float(model(small["tokens"].clamp(min=0), small["prefix"]).abs().max())
        del model, state, tx
    err = {k: abs(first["f32"][k] - first["cpu"][k]) for k in ("loss", "grad_norm_pre_clip")}
    for k, e in err.items():
        check(e <= CARD_VS_CPU[0] + CARD_VS_CPU[1] * abs(first["cpu"][k]),
              f"(h) the first f32 step's {k} on the card {first['f32'][k]} against the CPU "
              f"{first['cpu'][k]}")
    bf16_tol = 2 * BF16_LOGIT_STEPS * 2.0 ** -8 * scale
    bf16_diff = abs(first["bf16"]["loss"] - first["f32"]["loss"])
    check(bf16_diff <= bf16_tol, f"(h) the bf16 step's loss is {bf16_diff:.4g} from f32's, beyond "
          f"{bf16_tol:.4g}")
    say(f"(h) one f32 step (TF32 off, batch {CPU_BATCH}) on the card against the port on the "
        f"CPU: loss {first['f32']['loss']:.6f} vs {first['cpu']['loss']:.6f} (|diff| "
        f"{err['loss']:.3e}), pre-clip grad norm {first['f32']['grad_norm_pre_clip']:.6f} vs "
        f"{first['cpu']['grad_norm_pre_clip']:.6f} (|diff| {err['grad_norm_pre_clip']:.3e}; "
        f"atol/rtol {CARD_VS_CPU[0]}); bf16 loss {first['bf16']['loss']:.6f}, {bf16_diff:.3e} "
        f"from f32's (tolerance 2 x {BF16_LOGIT_STEPS} x 2^-8 x max|logit| {scale:.3f} = "
        f"{bf16_tol:.4g}); CPU step {first['cpu']['s']:.1f} s")
    say(f"training phase (h): {time.perf_counter() - t_phase:.1f} s (cli.train runs: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    return launches, dict(timing=timing, cli_s=secs, resume_loss_diff=resume_err,
                          jax_state=jax_state,
                          card_vs_cpu=err, bf16_loss_diff=bf16_diff,
                          validation_loss=val[0]["val/validation_loss"],
                          handles=dict(args=shards, losses={i: losses[i] for i in (1, 2, 3)}))


# --- 9. int8 decode at GPT2-XL width -------------------------------------------------

XL_D, XL_IMAGES, XL_BEAM_IMAGES = 1600, 8, 64
# GPT2-XL's depth in (i) by default: 4 of its 48 layers, cut when phases (j)
# and (m) joined the run (to 8) and when phase (o) joined (to 4) to keep the
# whole smoke well inside its time limit (the int8 path is per layer the same
# at any depth); --xl_layers 48 runs it whole
XL_LAYERS = 4
INT8_ROWS = (9, 16, 72, 320)  # the paths' rows: --no_beam, evaluate, the sweep, beam
# card against CPU for the int8 LM (bf16 activations): a logit within this
# many bf16 steps (2^-8) of the logits' scale; a greedy or beam choice may
# differ only where the reference's gap is below the same bound (an int8
# rounding of one activation moves its product by 1/127 of the row's scale)
INT8_LOGIT_STEPS = 16
INT8_SOLO = 4  # served int8 requests held against their solo runs


def int8_bound(scale: float) -> float:
    return INT8_LOGIT_STEPS * 2.0 ** -8 * scale


def timed_call(torch, fn, warm):
    """fn() after warm(), its wall seconds between two synchronizes."""
    warm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def per_step_profile(torch, label: str, run, short: int, long: int) -> dict:
    """Device ms and launches per decode step, from profiles of the same
    call at two step counts (their difference over the extra steps, so
    the encode and the prefill drop out), and the busy share of the
    longer one."""
    walls, profs = {}, {}
    for n in (short, long):
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        walls[n] = (time.perf_counter() - t0) * 1e3
        profs[n] = profile_call(torch, f"{label}, {n} steps", lambda: run(n), walls[n])
    return dict(device_ms_per_step=(profs[long]["busy_ms"] - profs[short]["busy_ms"])
                / (long - short),
                launches_per_step=(profs[long]["launches"] - profs[short]["launches"])
                / (long - short),
                busy_share=profs[long]["busy_ms"] / profs[long]["wall_ms"])


def check_int8_products(torch):
    """(i0) The int8 products on the card equal exact ones: int8_linear's
    int32 product (torch._int_mm, rows zero-padded) at each GPT2-XL linear
    shape and the paths' row counts, against the CPU's f64 product (exact:
    every partial sum is an integer far below 2^53), compared as int64; and
    the two f32 attention dots on int8 values at 320 rows and maxT 77
    against int64 sums on the CPU. Row 0 of every operand is all 127, the
    largest sums."""
    from clipcap_tpu_torch.models.gpt2 import _int_dot
    from clipcap_tpu_torch.ops.quant import int_mm

    gen = torch.Generator(device="cuda").manual_seed(21)

    def int8(*shape):
        t = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        t[0] = 127
        return t

    d, vocab_pad = XL_D, 50264
    shapes = {"c_attn": (d, 3 * d), "c_proj": (d, d), "c_fc": (d, 4 * d),
              "mlp_proj": (4 * d, d), "lm_head": (d, vocab_pad)}
    t0 = time.perf_counter()
    for name, (k, n) in shapes.items():
        w = int8(n, k)
        w64 = w.cpu().double()
        for m in INT8_ROWS:
            x = int8(m, k)
            got = int_mm(x, w)
            want = (x.cpu().double() @ w64.t()).long()
            check(got.dtype == torch.int32 and torch.equal(got.cpu().long(), want),
                  f"(i0) int8 product {name} {k}->{n} at {m} rows differs from the exact one")
    r, h, t, dh = 320, 25, 77, 64
    q, keys, p, vals = int8(r, h, dh), int8(r, h, t, dh), int8(r, h, t), int8(r, h, t, dh)
    scores = _int_dot(q[:, :, None], keys)[:, :, 0]
    pv = _int_dot(p[:, :, None], vals.transpose(-1, -2))[:, :, 0]
    want_s = (q.cpu().long()[:, :, None, :] * keys.cpu().long()).sum(-1)
    want_pv = (p.cpu().long()[..., None] * vals.cpu().long()).sum(2)
    for got, want, what in ((scores, want_s, "q.k"), (pv, want_pv, "p.v")):
        check(got.dtype == torch.float32 and bool((got == got.round()).all())
              and torch.equal(got.cpu().long(), want),
              f"(i0) the int8 attention dot {what} at 320 rows, maxT 77 is not exact")
    say(f"(i0) int8 products exact on the card: int8_linear's torch._int_mm at "
        f"{', '.join(f'{k}->{n}' for k, n in shapes.values())} x {INT8_ROWS} rows equal the "
        f"exact products; the attention dots q.k and p.v (f32 on int8 values, 320 rows x 25 "
        f"heads x maxT 77) equal int64 sums ({time.perf_counter() - t0:.1f} s)")


def check_int8_quantization(torch, lm, q8):
    """(i1) Every q and s of the int8 LM on the card equals the port's
    quantization of the same bf16 weights on the CPU; biases, wte, wpe and
    the LayerNorms are the bf16 weights themselves. Returns the bytes."""
    from clipcap_tpu_torch.models.gpt2 import INT8_LINEARS
    from clipcap_tpu_torch.ops.quant import pad_channels, quantize_weight

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())

    for i, (blk, qb) in enumerate(zip(lm.blocks, q8.blocks)):
        for name in INT8_LINEARS:
            lin, qlin = getattr(blk, name), getattr(qb, name)
            want = quantize_weight(lin.weight.cpu())
            check(same(qlin.q, want["q"]) and same(qlin.s, want["s"]) and same(qlin.bias, lin.bias),
                  f"(i1) block {i} {name}: q, s or bias differ from the CPU's quantization")
        for name in ("ln1", "ln2"):
            check(same(getattr(qb, name).weight, getattr(blk, name).weight),
                  f"(i1) block {i} {name} differs")
    head = quantize_weight(pad_channels(lm.wte.cpu().float()))
    check(same(q8.lm_head.q, head["q"]) and same(q8.lm_head.s, head["s"]),
          "(i1) lm_head differs from the CPU's quantization of wte")
    check(same(q8.wte, lm.wte) and same(q8.wpe, lm.wpe) and same(q8.ln_f.weight, lm.ln_f.weight),
          "(i1) wte, wpe or ln_f differ")
    blocks = sum(b.numel() * b.element_size() for blk in q8.blocks for b in blk.buffers())
    head_b = sum(b.numel() * b.element_size() for b in q8.lm_head.buffers())
    return blocks, head_b, q8.wte.numel() * q8.wte.element_size()


def int8_path(torch, counters, card: str, work: Path, handles: dict, main_bundle,
              xl_layers: int = XL_LAYERS) -> tuple:
    """(i) int8 decode. (i0) the int8 products exact; (i1) a GPT2-XL
    captioner (CLIP ViT-B/32, the mapper at width 1600, GPT2-XL at full
    width: 1600, 25 heads, vocab 50257, xl_layers of its 48 layers) seeded
    on the card in bf16, its LM quantized by
    bundle.enable_int8_decode() and held against the CPU (q and s equal,
    prefill logits of 2 rows within INT8_LOGIT_STEPS); (i2) the no-beam
    sweep (8 images x 9 top-p, 75 steps) on the bf16 LM, then on the int8
    one; (i3) int8 beam search, 64 images x beam 5 x 67 tokens through the
    shared-prefix cache, after its step held bit for bit against the
    replicated cache; (i4) int8 serving, 256 requests on 64 slots, greedy
    and "fused_step"; (i5) the int8 ViT-B/32 at B=64; (i6) cli.infer (beam
    and --no_beam), cli.serve and cli.evaluate with --int8_decode on (f)'s
    checkpoint. The launch counters are set to 0 just before (i2)'s int8
    sweep and read after (i6)."""
    import contextlib
    import dataclasses
    import io
    import math

    import numpy as np
    from PIL import Image

    from clipcap_tpu_torch.cli import evaluate as eval_cli
    from clipcap_tpu_torch.cli import infer as infer_cli
    from clipcap_tpu_torch.cli import serve as serve_cli
    from clipcap_tpu_torch.core.config import CaptionerConfig, GPT2Config, MapperConfig, ViTConfig
    from clipcap_tpu_torch.data.preprocessing import normalize_on_device
    from clipcap_tpu_torch.decode.beam import _expand_beams, _reorder_cache_tail
    from clipcap_tpu_torch.decode.beam import beam_search_batched
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.decode.serving import Request
    from clipcap_tpu_torch.eval.clip_scoring import ClipScoring
    from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.models.gpt2 import Int8KVCache
    from clipcap_tpu_torch.models.vit import quantize_params as quantize_vit

    t_phase = time.perf_counter()
    check_int8_products(torch)

    # (i1) the XL captioner in bf16, then its int8 LM
    t0 = time.perf_counter()
    cap_cfg = CaptionerConfig(lm_type="gpt2", visual_encoder_type="CLIP",
                              visual_encoder_variant="ViT-B/32",
                              mapper=MapperConfig(dim_embedding=XL_D))
    xl_cfg = dataclasses.replace(GPT2Config.variant("gpt2-xl"), n_layer=xl_layers)
    xl_name = f"XL ({xl_layers} of 48 layers)"
    xl = CaptionerBundle.create(cap_cfg, xl_cfg, IdTokenizer(),
                                ViTConfig.clip_variant("ViT-B/32"), seed=7, device="cuda",
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    gb = sum(p.numel() * p.element_size() for p in xl.model.parameters()) / 1e9
    lm_gb = sum(p.numel() * p.element_size() for p in xl.model.lm.parameters()) / 1e9
    c = xl.lm_cfg
    say(f"(i1) GPT2-XL captioner seeded on the card in bf16: {gb:.2f} GB ({lm_gb:.2f} GB of it "
        f"the LM; {c.n_layer} layers, width {c.n_embd}, {c.n_head} heads, vocab {c.vocab_size}) "
        f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(23)
    pixels = normalize_on_device(torch.rand(XL_BEAM_IMAGES, 3, 224, 224, generator=gen,
                                            device="cuda"))
    n_rows, n_steps = XL_IMAGES * len(TOP_P_SWEEP), 75  # NoBeamCaptionSampler's 75 steps

    def sweep(steps: int = n_steps):
        return NoBeamCaptionSampler(top_p_values=TOP_P_SWEEP, max_decode_length=steps,
                                    device="cuda").sample_batch(xl, pixels[:XL_IMAGES])

    # (i2), the bf16 LM first: the float module beside the int8 one
    t_sub = time.perf_counter()
    _, float_s = timed_call(torch, sweep, lambda: sweep(2))
    float_prof = per_step_profile(torch, f"(i2) bf16 {xl_name} sweep", sweep, 8, 16)
    say(f"(i2) bf16 {xl_name} sweep measured in {time.perf_counter() - t_sub:.1f} s")

    t0 = time.perf_counter()
    xl.enable_int8_decode()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    lm, q8 = xl.model.lm, xl.lm_decode
    t0 = time.perf_counter()
    blocks_b, head_b, wte_b = check_int8_quantization(torch, lm, q8)
    with torch.no_grad():
        prompt2 = xl.prefix_from_pixels(pixels[:2])
        card_logits, _ = q8.prefill(prompt2, q8.init_cache(2, prompt2.shape[1]), full_logits=True)
        cpu_q8 = copy.deepcopy(q8).cpu()
        cpu_logits, _ = cpu_q8.prefill(prompt2.cpu(), cpu_q8.init_cache(2, prompt2.shape[1]),
                                       full_logits=True)
    del cpu_q8
    scale = float(cpu_logits.abs().max())
    err_i1 = max_abs(card_logits.cpu(), cpu_logits)
    check(bool(torch.isfinite(card_logits).all()) and err_i1 <= int8_bound(scale),
          f"(i1) int8 prefill logits card vs CPU: max abs err {err_i1:.4g} > "
          f"{INT8_LOGIT_STEPS} x 2^-8 x max|logit| {scale:.3f} = {int8_bound(scale):.4g}")
    say(f"(i1) enable_int8_decode: {quant_s:.1f} s; int8 blocks {blocks_b / 1e9:.3f} GB, int8 "
        f"lm_head (50264 channels) {head_b / 1e6:.1f} MB, bf16 wte {wte_b / 1e6:.1f} MB; every "
        f"q and s equal to the CPU's quantization; prefill logits of 2 rows card vs CPU max abs "
        f"err {err_i1:.4g} (bound {int8_bound(scale):.4g}) ({time.perf_counter() - t0:.1f} s)")

    # the int8 path, its launches counted
    t_sub = time.perf_counter()
    torch.cuda.synchronize()
    counters(reset=True)
    caps, int8_s = timed_call(torch, sweep, lambda: sweep(2))
    rise = counters()["fused_filter_sample"]
    check(rise == 2 + n_steps, f"(i2) K2 launched {rise} times in the int8 warm-up and sweep, "
          f"want one per decode step ({2 + n_steps})")
    ids = [int(t) for c in caps for s_ in c for t in s_.split()]
    check(len(caps) == XL_IMAGES and all(len(c) == len(TOP_P_SWEEP) for c in caps)
          and all(0 <= t < 50257 for t in ids), "(i2) int8 sweep: wrong captions")
    int8_prof = per_step_profile(torch, f"(i2) int8 {xl_name} sweep", sweep, 8, 16)
    say(f"(i2) int8 {xl_name} sweep measured in {time.perf_counter() - t_sub:.1f} s")
    sweep_rates = {}
    for name, secs, prof in (("bf16", float_s, float_prof), ("int8", int8_s, int8_prof)):
        sweep_rates[name] = dict(captions_per_s=n_rows / secs, wall_ms=secs * 1e3, **prof)
        r = sweep_rates[name]
        say(f"(i2) {name} {xl_name} sweep, {XL_IMAGES} images x {len(TOP_P_SWEEP)} top-p "
            f"({n_rows} rows, {n_steps} steps) on {card}: {r['captions_per_s']:.2f} captions/s; device "
            f"{r['device_ms_per_step']:.3f} ms and {r['launches_per_step']:.1f} launches per step; "
            f"busy share {r['busy_share']:.3f} (per step: profiles at 8 and 16 steps, "
            f"differenced)")

    # (i3) the shared-prefix beam step bit for bit, then the beam call
    t_sub = time.perf_counter()
    p_len, beam, n_chk = prompt2.shape[1], BEAM, 4
    with torch.no_grad():
        prompt = xl.prefix_from_pixels(pixels)
        _, cache = q8.prefill(prompt[:n_chk], q8.init_cache(n_chk, p_len + 5))
        rep = _expand_beams(Int8KVCache(*(a.clone() for a in cache[:4]), index=p_len), beam)
        bc = q8.beam_prefix_cache(cache, beam, p_len)
        g = torch.Generator().manual_seed(29)
        for s_ in range(5):
            tok = torch.randint(0, 50257, (n_chk * beam,), generator=g).to("cuda")
            e = q8.embed_tokens(tok)[:, None]
            want, rep = q8.decode_step(e, rep)
            got, bc = q8.decode_step_beam(e, bc)
            check(torch.equal(got, want), f"(i3) shared-prefix beam step {s_}: logits differ "
                  f"from decode_step on the replicated int8 cache (max abs "
                  f"{max_abs(got, want):.3e})")
            src = torch.cat([i * beam + torch.randperm(beam, generator=g)
                             for i in range(n_chk)]).to("cuda")
            rep = _reorder_cache_tail(rep, src, p_len)
            bc = q8.reorder_beam_tail(bc, src)
    del rep, bc, cache

    def beam_call(steps: int = BEAM_NEW):
        return beam_search_batched(q8, prompt, beam_size=beam, max_new_tokens=steps,
                                   stop_token_id=STOP, device="cuda")

    out, beam_s = timed_call(torch, beam_call, lambda: beam_call(2))
    check(bool(torch.isfinite(out["scores"]).all()) and out["tokens"].shape == (
        XL_BEAM_IMAGES, beam, BEAM_NEW), "(i3) int8 beam: non-finite scores or wrong shape")
    beam_prof = profile_call(torch, f"(i3) int8 {xl_name} beam", beam_call, beam_s * 1e3)
    beam_rates = dict(captions_per_s=XL_BEAM_IMAGES / beam_s, wall_ms=beam_s * 1e3,
                      device_ms_per_step=beam_prof["busy_ms"] / BEAM_NEW,
                      launches_per_step=beam_prof["launches"] / BEAM_NEW,
                      busy_share=beam_prof["busy_ms"] / beam_prof["wall_ms"])
    say(f"(i3) int8 {xl_name} beam {XL_BEAM_IMAGES} images x beam {beam} x {BEAM_NEW} tokens "
        f"({XL_BEAM_IMAGES * beam} rows, shared-prefix cache) on {card}: "
        f"{beam_rates['captions_per_s']:.2f} captions/s; device "
        f"{beam_rates['device_ms_per_step']:.3f} ms and {beam_rates['launches_per_step']:.1f} "
        f"launches per step; busy share {beam_rates['busy_share']:.3f}; the shared-prefix step "
        f"equal bit for bit to the replicated cache's over {n_chk} images x 5 steps "
        f"({time.perf_counter() - t_sub:.1f} s)")
    t_sub = time.perf_counter()

    # (i4) int8 serving: 256 requests (caps 8-24) on 64 slots, greedy and "fused_step"
    pool = xl.project_prefix(torch.randn(SERVE_REQUESTS, 512, generator=gen, device="cuda"))
    serve_caps = np.random.default_rng(31).integers(8, 25, SERVE_REQUESTS).tolist()
    reqs = [Request(i, i, max_length=c) for i, c in enumerate(serve_caps)]
    base = GenerationSettings(max_new_tokens=SERVE_NEW, eos_token_id=EOS)
    greedy = dataclasses.replace(base, greedy=True)
    settings = {"greedy": greedy,
                "fused_step": dataclasses.replace(base, top_p=0.8, repetition_penalty=1.2,
                                                  min_length=5, filter_method="fused_step")}
    serve_rates, served = {}, {}
    for name, st in settings.items():
        eng = xl.make_serving_engine(st, slots=SERVE_SLOTS, steps_per_sync=SERVE_SYNC,
                                     pipeline_depth=2).warmup()
        check(eng.dtype == torch.bfloat16, "(i4) the int8 engine's activations are not bf16")
        k3 = counters()["fused_step_sample"]
        t0 = time.perf_counter()
        res = eng.serve(reqs, seed=7, prefix_pool=pool)
        wall = time.perf_counter() - t0
        k3 = counters()["fused_step_sample"] - k3
        stats = eng.last_stats
        want_k3 = stats["steps"] if name == "fused_step" else 0
        check(k3 == want_k3, f"(i4) {name}: K3 launched {k3} times over {stats['steps']} "
              f"dispatched steps, want {want_k3}")
        check(sorted(res) == list(range(SERVE_REQUESTS)) and all(
            0 < len(r["tokens"]) <= serve_caps[i] for i, r in res.items()),
              f"(i4) {name}: not every request answered within its cap")
        lat = np.asarray([r["latency_s"] for r in res.values()])
        served[name] = res
        serve_rates[name] = dict(captions_per_s=SERVE_REQUESTS / wall,
                                 p50_s=float(np.percentile(lat, 50)),
                                 p99_s=float(np.percentile(lat, 99)),
                                 occupancy=stats["occupancy"], steps=stats["steps"])
        say(f"(i4) int8 {xl_name} serve {SERVE_REQUESTS} requests ({name}; caps 8-24), "
            f"{SERVE_SLOTS} slots on {card}: {serve_rates[name]['captions_per_s']:.2f} captions/s; latency_s "
            f"p50 {serve_rates[name]['p50_s']:.4f}, p99 {serve_rates[name]['p99_s']:.4f}; "
            f"occupancy {stats['occupancy']}; {stats['steps']} steps; K3 +{k3}")
    flips = 0
    for i in range(INT8_SOLO):
        ref = generate(q8, pool[i:i + 1], dataclasses.replace(greedy, max_length=serve_caps[i]),
                       device="cuda")
        want = ref["tokens"][0, : int(ref["lengths"][0])].tolist()
        got = served["greedy"][i]["tokens"]
        if got != want:
            s_ = first_difference(got, want)
            _, gaps = greedy_with_gaps(torch, q8, pool[i:i + 1], SERVE_NEW)
            with torch.no_grad():
                sc = float(q8.prefill(pool[i:i + 1], q8.init_cache(1, p_len))[0].abs().max())
            gap = float(gaps[0, s_])
            check(gap < int8_bound(sc), f"(i4) request {i} differs from its solo int8 run at "
                  f"step {s_}, where the solo gap is {gap:.3e} (>= {int8_bound(sc):.3e})")
            flips += 1
    say(f"(i4) the first {INT8_SOLO} greedy requests against their solo int8 generate: "
        f"near-tie flips {flips} ({time.perf_counter() - t_sub:.1f} s)")
    t_sub = time.perf_counter()
    o2_handles = dict(xl=xl, pixels=pixels[:XL_IMAGES])  # phase (o2) goes on from these
    del sweep, beam_call, eng, xl, q8, lm, pool, out, prompt, prompt2, card_logits
    torch.cuda.empty_cache()

    # (i5) the int8 ViT-B/32 encoder at B=64 (f32 activations; attention on K1)
    visual = main_bundle.model.visual
    qvis = quantize_vit(visual)
    px = pixels.float()
    with torch.no_grad():
        want = visual(px, output="pooled")
        k1 = counters()["fused_attention"]
        got = qvis(px, output="pooled")
        k1 = counters()["fused_attention"] - k1
        vit_ms = time_ms(torch, lambda: qvis(px, output="pooled"), iters=5)
        f32_ms = time_ms(torch, lambda: visual(px, output="pooled"), iters=5)
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
    check(k1 == visual.cfg.layers, f"(i5) K1 launched {k1} times in one int8 encode, want "
          f"{visual.cfg.layers}")
    check(float(cos.min()) > 0.995, f"(i5) int8 ViT cosine to the float encode "
          f"{float(cos.min()):.5f} <= 0.995")
    vit_rates = dict(images_per_s=XL_BEAM_IMAGES / (vit_ms / 1e3),
                     f32_images_per_s=XL_BEAM_IMAGES / (f32_ms / 1e3),
                     min_cosine=float(cos.min()))
    say(f"(i5) int8 ViT-B/32 encode, B={XL_BEAM_IMAGES}, on {card}: "
        f"{vit_rates['images_per_s']:.1f} images/s (the f32 encoder in this call: "
        f"{vit_rates['f32_images_per_s']:.1f}); K1 +{k1}; cosine to the float encode "
        f">= {float(cos.min()):.5f}")
    del qvis, px, pixels

    # (i6) the CLIs with --int8_decode on (f)'s checkpoint
    t_sub = time.perf_counter()
    common = ["--checkpoint_path", str(work / "ckpt"), "--tokenizer_vocab_dir",
              str(work / "vocab"), "--device", "cuda"]
    clip = ["--clip_model", "ViT-B/32", "--clip_checkpoint", str(work / "clip.pt"),
            "--clip_merges", str(work / "clip_merges.txt")]
    cli_s = {}
    for name, extra, n_img in (("beam", [], INFER_IMAGES),
                               ("no_beam", ["--no_beam", "--total_samples", "2"], 2)):
        before = counters()
        t0 = time.perf_counter()
        with open(work / f"int8_{name}_stdout.txt", "w") as log, contextlib.redirect_stdout(log):
            data = infer_cli.main(common + clip + ["--folder_path", str(work / "images"),
                                                   "--out_filename_prefix",
                                                   str(work / f"int8_{name}"),
                                                   "--int8_decode"] + extra)
        cli_s[f"infer_{name}"] = time.perf_counter() - t0
        after = counters()
        check(len(data) == n_img and all(len(e["generated_captions"]) == 1 and all(
            math.isfinite(v) for v in e["scores"].values()) for e in data.values()),
              f"(i6) cli.infer {name} --int8_decode: not one caption and finite scores per image")
        want_k2 = 0 if name == "beam" else 75 * n_img
        check(after["fused_filter_sample"] - before["fused_filter_sample"] == want_k2
              and after["fused_attention"] > before["fused_attention"],
              f"(i6) cli.infer {name} --int8_decode: K2 rose by "
              f"{after['fused_filter_sample'] - before['fused_filter_sample']}, want {want_k2}")
    np.save(work / "int8_feats.npy",
            np.random.default_rng(37).normal(size=(64, 512)).astype(np.float32))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        n = serve_cli.main(common + ["--prefixes_npy", str(work / "int8_feats.npy"),
                                     "--out_jsonl", str(work / "int8_serve.jsonl"),
                                     "--slots", "16", "--max_new_tokens", "24",
                                     "--int8_decode"])
    cli_s["serve"] = time.perf_counter() - t0
    lines = [json.loads(x) for x in (work / "int8_serve.jsonl").read_text().splitlines()]
    check(n == 64 and len(lines) == 64 and all(0 < x["tokens"] <= 24 for x in lines),
          "(i6) cli.serve --int8_decode: wrong JSONL")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        eval_cli.main(common + clip + ["--valid_json_path", str(work / "coco" / "captions.json"),
                                       "--image_folder_path", str(work / "coco" / "images"),
                                       "--max_samples", str(EVAL_CHUNK), "--eval_batch_size",
                                       str(EVAL_CHUNK), "--int8_decode"])
    cli_s["evaluate"] = time.perf_counter() - t0
    text = printed.getvalue()
    scores = json.loads(text[text.index("{"):])
    check(math.isfinite(scores["validation_loss"]) and math.isfinite(scores["clip_score"])
          and sorted(scores["sampler_scores"]) == ["clip_guided", "nobeam"],
          "(i6) cli.evaluate --int8_decode: malformed scores")
    # the best beams of 2 images against the int8 LM on the CPU
    f32 = handles["bundle"]
    ib = CaptionerBundle(f32.model, f32.cap_cfg, f32.lm_cfg, f32.tokenizer, vit_cfg=f32.vit_cfg,
                         device="cuda").enable_int8_decode()
    scoring = ClipScoring(handles["visual"], handles["text"], None)
    img_px = []
    for f in sorted((work / "images").glob("*.jpg"))[:XL_BEAM_IMAGES]:
        with Image.open(f) as image:
            img_px.append(scoring.preprocess_image(image))
    with torch.no_grad():
        prompt = ib.prefix_from_pixels(torch.from_numpy(np.stack(img_px)))
        sc = float(ib.lm_decode.prefill(prompt[:2], ib.lm_decode.init_cache(2, prompt.shape[1]))[0]
                   .abs().max())
    traced, card_sel, _ = traced_beam(torch, ib.lm_decode, prompt, "cuda")
    t_sub = time.perf_counter()
    flips6, _ = check_beam_vs_cpu(torch, ib, prompt, traced, card_sel, gap_bound=int8_bound(sc),
                                  label="(i6)")
    launches = counters()
    cli_s["beam_check"] = time.perf_counter() - t_sub
    say(f"(i6) the CLIs with --int8_decode on (f)'s checkpoint: cli.infer beam {INFER_IMAGES} "
        f"images {cli_s['infer_beam']:.1f} s, --no_beam 2 images {cli_s['infer_no_beam']:.1f} s, "
        f"cli.serve 64 requests {cli_s['serve']:.1f} s, cli.evaluate {EVAL_CHUNK} images "
        f"{cli_s['evaluate']:.1f} s; well-formed outputs; validation loss "
        f"{scores['validation_loss']:.4f}; the beam check {cli_s['beam_check']:.1f} s")
    say(f"int8 phase (i): {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(xl_layers=xl_layers, sweep=sweep_rates, beam=beam_rates,
                          serving=serve_rates, vit=vit_rates, prefill_err=err_i1, cli_s=cli_s,
                          serve_flips=flips, beam_flips=flips6,
                          int8_bytes=dict(blocks=blocks_b, lm_head=head_b, wte=wte_b),
                          handles=o2_handles)


# --- 10. GPT-J-6B: the port's GPT-J captioner and speculative decoding ----------------

GPTJ_IMAGES, GPTJ_CUT = 8, 2  # the sweep's images; the CPU cut's and the checkpoint's layers
# GPT-J-6B's depth in (j), of its 28 layers: cut for the run's time since
# phases (k) and (m) came, to 2 when phase (o) came (the decode paths are
# per layer the same at any depth); --gptj_layers 28 runs it whole. (j6)'s
# frozen int8 LM is always whole.
GPTJ_LAYERS = 2
GPTJ_BEAM_IMAGES = {"bf16": 64, "int8": 32}  # int8 beam at half the images, for the run's time
GPTJ_SOLO = 2  # served requests held against their solo generate
SPEC_GAMMA, SPEC_NEW = 4, 67


def gptj_cut(lm, n_layer: int):
    """The first n_layer blocks of a GPTJ with its wte, ln_f and lm_head, as
    a GPTJ that shares the model's tensors (nothing is copied)."""
    import dataclasses

    from torch import nn

    cut = copy.copy(lm)
    cut._modules = dict(lm._modules)  # the copy's own module table
    cut.blocks = nn.ModuleList(list(lm.blocks)[:n_layer])
    cut.cfg = dataclasses.replace(lm.cfg, n_layer=n_layer)
    return cut


def check_gptj_cut(torch, cut, prompt) -> dict:
    """(j0) The card's GPT-J against the port on the CPU, on the first
    GPTJ_CUT layers at full width with wte, ln_f and lm_head (the same bf16
    tensors): prefill logits of 2 rows, a decode step and a ring step within
    INT8_LOGIT_STEPS bf16 steps of the logits' scale; the cut's int8
    quantization on the card equal to the CPU's (every q, s, bias and
    LayerNorm), and its int8 prefill and decode step within the same bound.
    Returns the errors and the logits' scale."""
    from clipcap_tpu_torch.models.gptj import quantize_params

    cpu = copy.deepcopy(cut).cpu()
    errs = {}

    def steps(lm, p, ring: bool):
        """Prefill (every position), a decode step on the argmax tokens and
        a ring step after them."""
        dev = p.device
        logits, cache = lm.prefill(p, lm.init_cache(p.shape[0], p.shape[1] + 2),
                                   full_logits=True)
        tok = torch.argmax(logits[:, -1].float(), dim=-1)
        step, cache = lm.decode_step(lm.embed_tokens(tok)[:, None].to(p.dtype), cache)
        out = [logits[:, -1].float(), step.float()]
        if ring:
            rc = lm.init_cache(p.shape[0], p.shape[1] + 3)
            _, rc = lm.prefill(p, rc)
            pos = torch.full((p.shape[0],), p.shape[1], dtype=torch.int64, device=dev)
            start = torch.zeros(p.shape[0], dtype=torch.int64, device=dev)
            r, _ = lm.decode_step_ring(lm.embed_tokens(tok)[:, None].to(p.dtype), rc, pos, start)
            out.append(r.float())
        return out, float(logits.float().abs().max())

    with torch.no_grad():
        card, scale = steps(cut, prompt, True)
        want, _ = steps(cpu, prompt.cpu(), True)
        for name, a, b in zip(("prefill", "decode", "ring"), card, want):
            errs[name] = max_abs(a.cpu(), b)
            check(bool(torch.isfinite(a).all()) and errs[name] <= int8_bound(scale),
                  f"(j0) bf16 {name} logits card vs CPU: max abs err {errs[name]:.4g} > "
                  f"{int8_bound(scale):.4g}")
        q_card, q_cpu = quantize_params(cut), quantize_params(cpu)
        sd_cpu = q_cpu.state_dict()
        for name, t in q_card.state_dict().items():
            check(t.dtype == sd_cpu[name].dtype and torch.equal(t.cpu(), sd_cpu[name]),
                  f"(j0) int8 {name} differs from the CPU's quantization")
        card8, _ = steps(q_card, prompt, False)
        want8, _ = steps(q_cpu, prompt.cpu(), False)
        for name, a, b in zip(("int8 prefill", "int8 decode"), card8, want8):
            errs[name] = max_abs(a.cpu(), b)
            check(bool(torch.isfinite(a).all()) and errs[name] <= int8_bound(scale),
                  f"(j0) {name} logits card vs CPU: max abs err {errs[name]:.4g} > "
                  f"{int8_bound(scale):.4g}")
    del cpu, q_card, q_cpu, sd_cpu
    return dict(errs=errs, scale=scale)


def gptj_path(torch, counters, FS, S, card: str, work: Path, gpt2_bundle,
              gptj_layers: int = GPTJ_LAYERS) -> tuple:
    """(j) GPT-J-6B captioning and speculative decoding at full width: CLIP
    ViT-B/32, the default mapper at width 4096 and GPT-J-6B (gptj_layers of
    its 28 layers, 4096 wide, 16 heads of 256, rotary 64, vocabulary
    50400), seeded on the card in bf16. (j-) K2/K3/K4 against their plain versions at GPT-J's
    vocabulary (check_sampler at GPTJ_SAMPLER_ROWS), the kernel's
    vocabulary limit and cluster sizes there; (j0) the build, and the
    2-layer cut against the CPU (check_gptj_cut); (j1) the no-beam sweep,
    GPTJ_IMAGES images x 9 top-p x 75 steps; (j2) beam search, 64 images x
    beam 5 x 67 tokens on float caches, the best beams of 2 images of the
    card's cut against the CPU's; (j3) serving, 256 requests on 64 slots,
    greedy and "fused_step"; (j4) speculative greedy at batch 1, gamma 4,
    67 tokens on the bf16 target: plain greedy, the target as its own draft,
    and (f)'s GPT-2 124M captioner as a cross-family draft; then (j1)-(j3)
    again on the int8 LM (bundle.enable_int8_decode(): beam on the
    replicated int8 cache, at 32 images to keep the run's time); (j5) the CLIs on a GPT-J checkpoint written at
    full width and 2 layers (a 1-layer mapper): cli.infer by beam,
    --no_beam and --speculative_draft_checkpoint with (f)'s checkpoint,
    cli.serve and cli.evaluate, each also with --int8_decode. The launch
    counters are set to 0 just before (j1) and read after (j5)."""
    import contextlib
    import dataclasses
    import io
    import math
    import types

    import numpy as np

    from clipcap_tpu_torch.cli import evaluate as eval_cli
    from clipcap_tpu_torch.cli import infer as infer_cli
    from clipcap_tpu_torch.cli import serve as serve_cli
    from clipcap_tpu_torch.cli.loading import load_captioner
    from clipcap_tpu_torch.core.config import (CaptionerConfig, GPTJConfig, MapperConfig,
                                               ViTConfig)
    from clipcap_tpu_torch.data.preprocessing import normalize_on_device
    from clipcap_tpu_torch.decode.beam import beam_search_batched
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.decode.serving import Request
    from clipcap_tpu_torch.decode.speculative import speculative_greedy
    from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.models.gptj import GPTJ, GPTJInt8
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # (j-) the sampler kernels at GPT-J's vocabulary; their launches here are
    # comparisons with the plain versions and are not counted on the path
    t0 = time.perf_counter()
    FS._check_vocab(GPTJ_VOCAB)
    k234, _ = check_sampler(torch, FS, S, vocab=GPTJ_VOCAB, sampler_rows=GPTJ_SAMPLER_ROWS,
                            timed_rows=GPTJ_SAMPLER_ROWS)
    clusters = {r: FS.cluster_size(r, GPTJ_VOCAB) for r in GPTJ_SAMPLER_ROWS}
    check(clusters[512] == 1, f"K2 at [512, {GPTJ_VOCAB}] uses a cluster of {clusters[512]}, "
          "want 1 (one block per row)")
    say(f"(j-) sampler kernels at V={GPTJ_VOCAB}: the kernel holds up to {FS._max_vocab} tokens "
        f"in a cluster; cluster sizes {clusters}; checked in {time.perf_counter() - t0:.1f} s")

    # (j0) the captioner in bf16
    t0 = time.perf_counter()
    lm_cfg = dataclasses.replace(GPTJConfig.variant("EleutherAI/gpt-j-6B"), n_layer=gptj_layers)
    cap_cfg = CaptionerConfig(lm_type="gptj", lm_variant="EleutherAI/gpt-j-6B",
                              visual_encoder_type="CLIP", visual_encoder_variant="ViT-B/32",
                              mapper=MapperConfig(dim_embedding=lm_cfg.n_embd))
    bj = CaptionerBundle.create(cap_cfg, lm_cfg, IdTokenizer(), ViTConfig.clip_variant("ViT-B/32"),
                                seed=17, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lm = bj.model.lm
    check(isinstance(lm, GPTJ) and lm.wte.dtype == torch.bfloat16, "(j0) not a bf16 GPTJ")
    lm_params = sum(p.numel() for p in lm.parameters())
    map_params = sum(p.numel() for p in bj.model.mapper.parameters())
    say(f"(j0) GPT-J-6B captioner seeded on the card in bf16 in {build_s:.1f} s: LM "
        f"{lm_params / 1e9:.3f} B params ({lm_params * 2 / 1e9:.2f} GB; {lm_cfg.n_layer} of 28 "
        f"layers, "
        f"width {lm_cfg.n_embd}, {lm_cfg.n_head} heads of {lm_cfg.n_embd // lm_cfg.n_head}, "
        f"rotary {lm_cfg.rotary_dim}, vocab {lm_cfg.vocab_size}), mapper {map_params / 1e9:.3f} B, "
        f"ViT-B/32 {sum(p.numel() for p in bj.model.visual.parameters()) / 1e6:.1f} M")
    gen = torch.Generator(device="cuda").manual_seed(41)
    pixels = normalize_on_device(torch.rand(GPTJ_BEAM_IMAGES["bf16"], 3, 224, 224,
                                            generator=gen, device="cuda"))
    with torch.no_grad():
        prompt = bj.prefix_from_pixels(pixels)  # [64, 10, 4096] bf16
    p_len = prompt.shape[1]
    t0 = time.perf_counter()
    cut = gptj_cut(lm, GPTJ_CUT)
    cut_check = check_gptj_cut(torch, cut, prompt[:2])
    scale = cut_check["scale"]
    say(f"(j0) the {GPTJ_CUT}-layer cut at full width card vs CPU (bf16 both), max abs err: "
        + ", ".join(f"{k} {v:.4g}" for k, v in cut_check["errs"].items())
        + f" (bound {int8_bound(scale):.4g}: {INT8_LOGIT_STEPS} bf16 steps of max|logit| "
        f"{scale:.3f}); the cut's int8 q, s, biases and LayerNorms equal the CPU's "
        f"({time.perf_counter() - t0:.1f} s)")

    n_rows, n_steps = GPTJ_IMAGES * len(TOP_P_SWEEP), 75

    def sweep(steps: int = n_steps):
        return NoBeamCaptionSampler(top_p_values=TOP_P_SWEEP, max_decode_length=steps,
                                    device="cuda").sample_batch(bj, pixels[:GPTJ_IMAGES])

    def beam_call(images: int, steps: int = BEAM_NEW):
        return beam_search_batched(bj.lm_decode, prompt[:images], beam_size=BEAM,
                                   max_new_tokens=steps, stop_token_id=STOP, device="cuda")

    pool = bj.project_prefix(torch.randn(SERVE_REQUESTS, 512, generator=gen, device="cuda"))
    serve_caps = np.random.default_rng(43).integers(8, 25, SERVE_REQUESTS).tolist()
    reqs = [Request(i, i, max_length=c) for i, c in enumerate(serve_caps)]
    base = GenerationSettings(max_new_tokens=SERVE_NEW, eos_token_id=EOS)
    greedy = dataclasses.replace(base, greedy=True)
    serve_settings = {"greedy": greedy,
                      "fused_step": dataclasses.replace(base, top_p=0.8, repetition_penalty=1.2,
                                                        min_length=5, filter_method="fused_step")}
    results = {}

    def decode_phases(dtype: str) -> None:
        """(j1)-(j3) on bj.lm_decode: the sweep, beam search and serving."""
        lmd = bj.lm_decode
        r = results.setdefault(dtype, {})
        # (j1) the sweep: K2 at [72, 50400] once a step
        t_sub = time.perf_counter()
        k2 = counters()["fused_filter_sample"]
        caps, secs = timed_call(torch, sweep, lambda: sweep(2))
        k2 = counters()["fused_filter_sample"] - k2
        check(k2 == 2 + n_steps, f"(j1) {dtype}: K2 launched {k2} times in the warm-up and the "
              f"sweep, want one per decode step ({2 + n_steps})")
        ids = [int(t) for c in caps for s_ in c for t in s_.split()]
        check(len(caps) == GPTJ_IMAGES and all(len(c) == len(TOP_P_SWEEP) for c in caps)
              and all(0 <= t < GPTJ_VOCAB for t in ids), f"(j1) {dtype} sweep: wrong captions")
        prof = per_step_profile(torch, f"(j1) {dtype} GPT-J sweep", sweep, 8, 16)
        r["sweep"] = dict(captions_per_s=n_rows / secs, wall_ms=secs * 1e3, **prof)
        say(f"(j1) {dtype} GPT-J sweep, {GPTJ_IMAGES} images x {len(TOP_P_SWEEP)} top-p "
            f"({n_rows} rows, {n_steps} steps) on {card}: {n_rows / secs:.2f} captions/s; device "
            f"{prof['device_ms_per_step']:.3f} ms and {prof['launches_per_step']:.1f} launches "
            f"per step; busy share {prof['busy_share']:.3f} ({time.perf_counter() - t_sub:.1f} s)")
        # (j2) beam search: 64 images (32 in int8) x beam 5 x 67 tokens
        t_sub = time.perf_counter()
        n_img = GPTJ_BEAM_IMAGES[dtype]
        out, secs = timed_call(torch, lambda: beam_call(n_img), lambda: beam_call(2, 2))
        check(bool(torch.isfinite(out["scores"]).all()) and out["tokens"].shape == (
            n_img, BEAM, BEAM_NEW) and int(out["tokens"].max()) < GPTJ_VOCAB,
              f"(j2) {dtype} beam: non-finite scores, a wrong shape or an id past the vocabulary")
        prof = profile_call(torch, f"(j2) {dtype} GPT-J beam", lambda: beam_call(n_img),
                            secs * 1e3)
        r["beam"] = dict(images=n_img, captions_per_s=n_img / secs, wall_ms=secs * 1e3,
                         device_ms_per_step=prof["busy_ms"] / BEAM_NEW,
                         launches_per_step=prof["launches"] / BEAM_NEW,
                         busy_share=prof["busy_ms"] / prof["wall_ms"],
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        say(f"(j2) {dtype} GPT-J beam {n_img} images x beam {BEAM} x {BEAM_NEW} "
            f"tokens ({n_img * BEAM} rows) on {card}: "
            f"{r['beam']['captions_per_s']:.2f} captions/s; device "
            f"{r['beam']['device_ms_per_step']:.3f} ms and {r['beam']['launches_per_step']:.1f} "
            f"launches per step; busy share {r['beam']['busy_share']:.3f} "
            f"({time.perf_counter() - t_sub:.1f} s)")
        del out
        # (j3) serving: 256 requests on 64 slots, greedy and "fused_step"
        t_sub = time.perf_counter()
        served = {}
        for name, st in serve_settings.items():
            eng = bj.make_serving_engine(st, slots=SERVE_SLOTS, steps_per_sync=SERVE_SYNC,
                                         pipeline_depth=2).warmup()
            check(eng.lm is lmd and eng.dtype == torch.bfloat16,
                  f"(j3) {dtype} {name}: the engine does not run the bf16 decode LM")
            k3 = counters()["fused_step_sample"]
            t0 = time.perf_counter()
            res = eng.serve(reqs, seed=7, prefix_pool=pool)
            wall = time.perf_counter() - t0
            k3 = counters()["fused_step_sample"] - k3
            stats = eng.last_stats
            want_k3 = stats["steps"] if name == "fused_step" else 0
            check(k3 == want_k3, f"(j3) {dtype} {name}: K3 launched {k3} times over "
                  f"{stats['steps']} dispatched steps, want {want_k3}")
            check(sorted(res) == list(range(SERVE_REQUESTS)) and all(
                0 < len(x["tokens"]) <= serve_caps[i] for i, x in res.items()),
                  f"(j3) {dtype} {name}: not every request answered within its cap")
            lat = np.asarray([x["latency_s"] for x in res.values()])
            served[name] = res
            r[f"serve_{name}"] = dict(captions_per_s=SERVE_REQUESTS / wall,
                                      p50_s=float(np.percentile(lat, 50)),
                                      p99_s=float(np.percentile(lat, 99)),
                                      occupancy=stats["occupancy"], steps=stats["steps"])
            say(f"(j3) {dtype} GPT-J serve {SERVE_REQUESTS} requests ({name}; caps 8-24), "
                f"{SERVE_SLOTS} slots on {card}: {SERVE_REQUESTS / wall:.2f} captions/s; "
                f"latency_s p50 {r[f'serve_{name}']['p50_s']:.4f}, p99 "
                f"{r[f'serve_{name}']['p99_s']:.4f}; occupancy {stats['occupancy']}; "
                f"{stats['steps']} steps; K3 +{k3}")
            del eng
        flips = 0
        for i in range(GPTJ_SOLO):
            ref = generate(lmd, pool[i:i + 1], dataclasses.replace(greedy, max_length=serve_caps[i]),
                           device="cuda")
            want = ref["tokens"][0, : int(ref["lengths"][0])].tolist()
            got = served["greedy"][i]["tokens"]
            if got != want:
                s_ = first_difference(got, want)
                _, gaps = greedy_with_gaps(torch, lmd, pool[i:i + 1], SERVE_NEW)
                gap = float(gaps[0, s_])
                check(gap < int8_bound(scale), f"(j3) {dtype} request {i} differs from its solo "
                      f"generate at step {s_}, where the solo gap is {gap:.3e}")
                flips += 1
        r["serve_flips"] = flips
        say(f"(j3) the first {GPTJ_SOLO} greedy requests against their solo generate: near-tie "
            f"flips {flips} ({time.perf_counter() - t_sub:.1f} s)")

    torch.cuda.synchronize()
    counters(reset=True)
    decode_phases("bf16")

    # (j2) the best beams of 2 images: the card's cut against the CPU's
    t0 = time.perf_counter()
    traced, card_sel, _ = traced_beam(torch, cut, prompt[:2], "cuda")
    beam_flips, _ = check_beam_vs_cpu(torch, types.SimpleNamespace(lm_decode=cut), prompt[:2],
                                      traced, card_sel, gap_bound=int8_bound(scale),
                                      label="(j2) the 2-layer cut's")
    results["bf16"]["beam_flips"] = beam_flips
    say(f"(j2) cut beam check: {time.perf_counter() - t0:.1f} s")
    del traced, card_sel

    # (j4) speculative greedy at batch 1 on the bf16 target
    t_sub = time.perf_counter()
    img = pixels[:1]
    t_prompt = prompt[:1]
    with torch.no_grad():
        d_prompt = gpt2_bundle.prefix_from_pixels(img.float())
        plain_toks, plain_gaps = greedy_with_gaps(torch, lm, t_prompt, SPEC_NEW)
    plain_toks = plain_toks[0].tolist()
    plain_gaps = plain_gaps[0].float().cpu()
    bound = int8_bound(scale)

    def plain_run(n: int = SPEC_NEW):
        return generate(lm, t_prompt, GenerationSettings(max_new_tokens=n, greedy=True),
                        device="cuda")

    def spec_run(draft, dprompt, n: int = SPEC_NEW):
        return speculative_greedy(lm, draft, t_prompt, dprompt, max_new_tokens=n,
                                  gamma=SPEC_GAMMA, device="cuda")

    spec = {}
    for name, run in (("plain", plain_run),
                      ("self_draft", lambda n=SPEC_NEW: spec_run(lm, t_prompt, n)),
                      ("gpt2_draft", lambda n=SPEC_NEW: spec_run(gpt2_bundle.lm, d_prompt, n))):
        out, secs = timed_call(torch, run, lambda: run(8))
        toks = out["tokens"][0].tolist()
        chunks = int(out["chunks"][0]) if "chunks" in out else SPEC_NEW
        n_tok = int(out["lengths"][0])
        diff = first_difference(toks, plain_toks) if toks != plain_toks else SPEC_NEW
        gap = float(plain_gaps[diff]) if diff < SPEC_NEW else None
        # equal to plain greedy up to its first choice that differs, where
        # plain greedy's top-2 gap must be under the bf16 bound
        check(n_tok == SPEC_NEW and (gap is None or gap < bound),
              f"(j4) {name}: {n_tok} tokens, first differs from plain greedy at {diff}, where "
              f"plain greedy's top-2 gap {gap} is not under the bf16 bound {bound:.4g}")
        spec[name] = dict(ms_per_token=secs * 1e3 / n_tok, chunks=chunks,
                          tokens_per_chunk=n_tok / chunks, first_difference=diff,
                          plain_gap_there=gap)
        say(f"(j4) {name} greedy, batch 1, {SPEC_NEW} tokens on {card}: "
            f"{spec[name]['ms_per_token']:.3f} ms/token; {chunks} target forwards, "
            f"{spec[name]['tokens_per_chunk']:.3f} tokens each; equal to plain greedy up to "
            f"token {diff}" + (f" (plain greedy's top-2 gap there {gap:.4g}, bound {bound:.4g})"
                               if gap is not None else ""))
    check(spec["self_draft"]["chunks"] <= -(-(SPEC_NEW - 1) // (SPEC_GAMMA + 1)) + 1,
          f"(j4) the self draft took {spec['self_draft']['chunks']} chunks: not full acceptance")
    results["speculative"] = spec
    say(f"(j4) speculative phase {time.perf_counter() - t_sub:.1f} s")

    # (j1)-(j3) on the int8 LM
    t0 = time.perf_counter()
    bj.enable_int8_decode()
    torch.cuda.synchronize()
    q8 = bj.lm_decode
    check(isinstance(q8, GPTJInt8) and not q8.chunked_forward
          and not hasattr(q8, "beam_prefix_cache"), "(j) the int8 LM is not GPTJInt8")
    int8_gb = sum(b.numel() * b.element_size() for b in q8.buffers()) / 1e9
    say(f"(j) enable_int8_decode: {time.perf_counter() - t0:.1f} s; int8 LM {int8_gb:.2f} GB of "
        f"buffers + bf16 wte {q8.wte.numel() * 2 / 1e9:.2f} GB")
    decode_phases("int8")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # (j5) the CLIs on a GPT-J checkpoint at full width, 2 layers
    t_sub = time.perf_counter()
    small = copy.copy(bj.model)
    small._modules = dict(bj.model._modules)
    small.lm = cut
    small.mapper = copy.copy(bj.model.mapper)
    small.mapper._modules = dict(bj.model.mapper._modules)
    small.mapper.layers = torch.nn.ModuleList(list(bj.model.mapper.layers)[:1])
    small_cap = dataclasses.replace(cap_cfg, mapper=dataclasses.replace(cap_cfg.mapper,
                                                                          num_layers=1))
    small.cfg, small.lm_cfg = small_cap, cut.cfg
    ckpt = work / "gptj_ckpt"
    save_checkpoint(str(ckpt), small, small_cap, cut.cfg)
    npz_gb = (ckpt / "consolidated.npz").stat().st_size / 1e9
    model, l_cap, l_lm, _ = load_captioner(str(ckpt), device="cuda")
    want = small.state_dict()
    for name, p in model.state_dict().items():
        check(p.is_cuda and p.dtype == want[name].dtype and torch.equal(p, want[name]),
              f"(j5) the GPT-J checkpoint's {name} differs from what was written")
    check(l_cap == small_cap and l_lm == cut.cfg and isinstance(model.lm, GPTJ),
          "(j5) the GPT-J checkpoint's configs differ")
    write_read_s = time.perf_counter() - t_sub
    # phase (o4) goes on from the float captioner and the sweep's prompts
    o4_handles = dict(model=bj.model, cap_cfg=cap_cfg, lm_cfg=lm_cfg, vit_cfg=bj.vit_cfg,
                      prompt=prompt[:8])
    del model, want, small, bj, lm, cut, q8, pool, prompt, pixels, img, t_prompt, d_prompt
    torch.cuda.empty_cache()
    say(f"(j5) GPT-J checkpoint ({npz_gb:.2f} GB .npz, full width, {GPTJ_CUT} layers, 1-layer "
        f"mapper) written and read back bit for bit in {write_read_s:.1f} s")
    common = ["--checkpoint_path", str(ckpt), "--tokenizer_vocab_dir", str(work / "vocab"),
              "--device", "cuda"]
    clip = ["--clip_model", "ViT-B/32", "--clip_checkpoint", str(work / "clip.pt"),
            "--clip_merges", str(work / "clip_merges.txt")]
    cli_s = {}
    for int8 in ("", "--int8_decode"):
        tag = "int8 " if int8 else ""
        extra8 = [int8] if int8 else []
        for name, extra, n_img, want_k2 in (
                ("beam", ["--total_samples", "8"], 8, 0),
                ("no_beam", ["--no_beam", "--total_samples", "2"], 2, 75 * 2),
                ("speculative", ["--speculative_draft_checkpoint", str(work / "ckpt"),
                                 "--total_samples", "1"], 1, 0)):
            before = counters()
            t0 = time.perf_counter()
            with open(work / f"gptj_{name}{int8}.txt", "w") as log, \
                    contextlib.redirect_stdout(log):
                data = infer_cli.main(common + clip + extra + extra8 + [
                    "--folder_path", str(work / "images"),
                    "--out_filename_prefix", str(work / f"gptj_{name}{int8}")])
            cli_s[f"{tag}infer_{name}"] = time.perf_counter() - t0
            after = counters()
            check(len(data) == n_img and all(len(e["generated_captions"]) == 1 and all(
                math.isfinite(v) for v in e["scores"].values()) for e in data.values()),
                  f"(j5) {tag}cli.infer {name}: not one caption and finite scores per image")
            k2 = after["fused_filter_sample"] - before["fused_filter_sample"]
            check(k2 == want_k2 and after["fused_attention"] > before["fused_attention"],
                  f"(j5) {tag}cli.infer {name}: K2 rose by {k2}, want {want_k2}, or K1 did not run")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            n = serve_cli.main(common + extra8 + [
                "--prefixes_npy", str(work / "int8_feats.npy"),
                "--out_jsonl", str(work / f"gptj_serve{int8}.jsonl"), "--slots", "16",
                "--max_new_tokens", "24"])
        cli_s[f"{tag}serve"] = time.perf_counter() - t0
        lines = [json.loads(x) for x in
                 (work / f"gptj_serve{int8}.jsonl").read_text().splitlines()]
        check(n == 64 and len(lines) == 64 and all(0 < x["tokens"] <= 24 for x in lines),
              f"(j5) {tag}cli.serve: wrong JSONL")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            eval_cli.main(common + clip + extra8 + [
                "--valid_json_path", str(work / "coco" / "captions.json"),
                "--image_folder_path", str(work / "coco" / "images"),
                "--max_samples", str(EVAL_CHUNK), "--eval_batch_size", str(EVAL_CHUNK)])
        cli_s[f"{tag}evaluate"] = time.perf_counter() - t0
        text = printed.getvalue()
        scores = json.loads(text[text.index("{"):])
        check(math.isfinite(scores["validation_loss"]) and math.isfinite(scores["clip_score"])
              and sorted(scores["sampler_scores"]) == ["clip_guided", "nobeam"],
              f"(j5) {tag}cli.evaluate: malformed scores")
    launches = counters()
    say(f"(j5) the CLIs on the GPT-J checkpoint, seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in cli_s.items())
        + f"; well-formed outputs ({time.perf_counter() - t_sub:.1f} s)")
    say(f"(j) peak device memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)")
    say(f"GPT-J phase (j): {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(gptj_layers=gptj_layers, build_s=build_s, cut=cut_check,
                          decode=results, cli_s=cli_s, peak_gb=peak_gb, npz_gb=npz_gb,
                          sampler_v50400={
                              name: dict(k234[name], cluster=clusters) for name in k234},
                          handles=o4_handles)


GPTJ_TRAIN_BATCH, GPTJ_TRAIN_STEPS, GPTJ_TRAIN_TOKENS = 16, 4, 24


def gptj_int8_train(torch, card: str) -> dict:
    """(j6) prefix-only training over GPT-J-6B frozen in int8 (BASELINE
    config #4, with the README's 2-layer transformer mapper at 4096):
    GPT-J-6B at all of its 28 layers seeded on the card in bf16 and
    quantized (models/gptj.quantize_params), then the port's
    make_train_step driving the LM's W8A16 forward through
    lm_apply=model.lm.apply_q8, at batch 16, bf16 compute, remat and
    AutoClip, on seeded CLIP-width prefixes and GPT-2-range token ids
    padded with -1 after 8-24 tokens (create_train_state stores the frozen
    scales and biases in bf16, as JAX's does). Checks: the int8 LM (q, s, biases,
    LayerNorms, wte) bit-identical after the steps; the mapper moved;
    finite losses; the loss of a 2-layer cut (the same mapper, the first
    two int8 blocks with wte, ln_f and the head) on the card against the
    port on the CPU within 16 bf16 steps of its value. Reports s per
    step, launches per step and the busy share."""
    import numpy as np

    from clipcap_tpu_torch.core.config import (CaptionerConfig, GPTJConfig, MapperConfig,
                                               TrainConfig)
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.models.gptj import GPTJ, quantize_params
    from clipcap_tpu_torch.train.train_step import (caption_loss, create_train_state,
                                                    forward_params, make_train_step)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    lm_cfg = GPTJConfig.variant("EleutherAI/gpt-j-6B")
    lm = GPTJ(lm_cfg, device="cuda", dtype=torch.bfloat16, seed=19)
    q8 = quantize_params(lm)
    del lm
    torch.cuda.empty_cache()
    cap = CaptionerConfig(lm_type="gptj", lm_variant="EleutherAI/gpt-j-6B", prefix_only=True,
                          visual_encoder_type="none",
                          mapper=MapperConfig(dim_embedding=lm_cfg.n_embd, num_layers=2))
    tc = TrainConfig(optimizer_lr=1e-4, scheduler_warmup_steps=1, total_steps=100,
                     bf16_compute=True, remat=True, gradient_clip_val=-1.0)
    model = Captioner(cap, lm_cfg, lm=q8, device="cuda", seed=23)
    state, tx = create_train_state(0, cap, lm_cfg, tc, model=model, device="cuda")
    check(all(n.startswith("mapper.") for n in tx.names),
          "(j6) the optimizer holds more than the mapper")
    lm_before = {k: v.clone() for k, v in q8.state_dict().items()}
    mapper_before = {k: v.clone() for k, v in model.mapper.state_dict().items()}
    rng = np.random.default_rng(29)
    tokens = rng.integers(1, 50256, size=(GPTJ_TRAIN_BATCH, GPTJ_TRAIN_TOKENS))
    lengths = rng.integers(8, GPTJ_TRAIN_TOKENS + 1, size=GPTJ_TRAIN_BATCH)
    tokens[np.arange(GPTJ_TRAIN_TOKENS)[None] >= lengths[:, None]] = -1
    batch = {"tokens": torch.from_numpy(tokens).cuda(),
             "prefix": torch.from_numpy(rng.normal(size=(GPTJ_TRAIN_BATCH, 512)).astype(
                 np.float32)).cuda()}
    step = make_train_step(cap, lm_cfg, tc, tx, lm_apply=model.lm.apply_q8)
    state, m = step(state, batch)  # warm-up (lr 0 at step 0)
    torch.cuda.synchronize()
    t_step = time.perf_counter()
    losses = []
    for _ in range(GPTJ_TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t_step) / GPTJ_TRAIN_STEPS
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"(j6) non-finite losses {losses}")
    prof = profile_call(torch, "(j6) int8 GPT-J prefix step", lambda: step(state, batch),
                        s_step * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k, v in q8.state_dict().items():
        check(v.dtype == lm_before[k].dtype and torch.equal(v, lm_before[k]),
              f"(j6) the frozen int8 LM's {k} changed in training")
    moved = sum(float((v.float() - mapper_before[k].float()).abs().sum())
                for k, v in model.mapper.state_dict().items())
    check(moved > 0, "(j6) the mapper did not move")
    del lm_before, mapper_before
    # the 2-layer cut's loss, card against the port on the CPU
    small = copy.copy(model)
    small._modules = dict(model._modules)
    small.lm = gptj_cut(q8, GPTJ_CUT)
    mask = small.trainable_filter()

    def cut_loss(mod, b):
        with torch.no_grad():
            fwd = forward_params(mod, mask, True)
            return float(caption_loss(mod, fwd, b, cap, tc, lm_apply=mod.lm.apply_q8))

    card_loss = cut_loss(small, batch)
    cpu = copy.deepcopy(small).cpu()
    cpu_loss = cut_loss(cpu, {k: v.cpu() for k, v in batch.items()})
    del cpu
    err, lim = abs(card_loss - cpu_loss), int8_bound(abs(cpu_loss))
    check(np.isfinite(card_loss) and err <= lim,
          f"(j6) the {GPTJ_CUT}-layer cut's loss {card_loss:.6f} against the CPU's {cpu_loss:.6f}: "
          f"{err:.3e} > {lim:.3e}")
    out = dict(s_per_step=s_step, launches_per_step=prof["launches"],
               busy_share=prof["busy_ms"] / (s_step * 1e3), busy_ms=prof["busy_ms"],
               losses=losses, peak_gb=peak_gb, cut_loss_err=err, cut_loss_bound=lim)
    figure_line(card, f"(j6) int8 GPT-J-6B prefix train step, batch {GPTJ_TRAIN_BATCH}", out)
    say(f"(j6) int8 GPT-J-6B prefix training ({lm_cfg.n_layer} int8 layers frozen, 2-layer "
        f"mapper at {lm_cfg.n_embd}, batch {GPTJ_TRAIN_BATCH}, bf16, remat, AutoClip) on "
        f"{card}: {s_step:.4f} s per step, {prof['launches']} launches per step, busy share "
        f"{out['busy_share']:.3f}; losses {[round(x, 4) for x in losses]}; the int8 LM "
        f"bit-identical, the mapper moved; the {GPTJ_CUT}-layer cut's loss {card_loss:.6f} "
        f"against the CPU's {cpu_loss:.6f} (err {err:.3e}, bound {lim:.3e}); peak device memory "
        f"{peak_gb:.2f} GB ({time.perf_counter() - t0:.1f} s)")
    del state, model, small, q8
    return out


# --- 11. T5/T0: the port's T0-11B captioner -------------------------------------------

T0_VOCAB, T0_SAMPLER_ROWS = 32128, [9, 16, 64, 72, 512]
T0_IMAGES, T0_BATCH, T0_CUT, T0_GREEDY_NEW = 8, 64, 2, 67  # sweep images, greedy rows, CPU cut
T0_BEAM_IMAGES = {"bf16": 64, "int8": 32}  # int8 beam at half the images, for the run's time
T0_EOS, T0_STOP = 1, 5  # T5's </s>; a fixed id standing for "."
T0_WORDS = 32100  # the tokenizer.json's vocabulary, T0's (its 28 padding rows decode to nothing)
T0_CUT_SOLO = 8  # the cut's served requests held against their solo runs
# T0-11B's depth in (k), of its 24 + 24 layers: cut to 8 + 8 for the run's
# time when phase (m) came, to 6 + 6 when phase (n) came, to 2 + 2 when
# phase (o) came (the decode paths are per layer the same at any depth);
# --t0_layers 24 runs it whole
T0_LAYERS = 2


class T5IdTokenizer:
    """T5's special ids without a tokenizer file (the HF tokenizer.json of
    T0 does not ship with the repository): pad 0 (the decoder's start),
    eos 1, unk 2, and a fixed id for "."; captions print as token ids."""

    bos_token_id, pad_token_id, eos_token_id = 0, 0, T0_EOS
    all_special_ids = [0, 1, 2]

    def encode_text(self, text: str):
        if text != ".":
            raise SmokeError(f"T5IdTokenizer knows only '.', not {text!r}")
        return [T0_STOP]

    def decode_tokens(self, ids):
        return " ".join(str(int(i)) for i in ids)


def write_t5_tokenizer(folder: Path) -> None:
    """A T5-style tokenizer.json of T0's 32100 entries, built with the
    `tokenizers` package: T5's specials <pad> 0, </s> 1, <unk> 2, "." at 3,
    words w0.. after, whitespace pre-tokenization, and T5's post-processor
    appending </s>."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    specials = ["<pad>", "</s>", "<unk>"]
    vocab = {t: i for i, t in enumerate(specials + ["."]
                                         + [f"w{i}" for i in range(T0_WORDS - 4)])}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.add_special_tokens(specials)
    tk.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                      special_tokens=[("</s>", 1)])
    folder.mkdir(parents=True, exist_ok=True)
    tk.save(str(folder / "tokenizer.json"))


def t5_cut(lm, n_layer: int):
    """The first n_layer blocks of each stack of a T5 (or T5Int8) with its
    shared table, relative-bias tables, norms and head, as a module that
    shares the model's tensors (nothing is copied)."""
    import dataclasses

    from torch import nn

    cut = copy.copy(lm)
    cut._modules = dict(lm._modules)
    for name in ("encoder", "decoder"):
        stack = copy.copy(getattr(lm, name))
        stack._modules = dict(stack._modules)
        stack.blocks = nn.ModuleList(list(stack.blocks)[:n_layer])
        setattr(cut, name, stack)
    cut.cfg = dataclasses.replace(lm.cfg, num_layers=n_layer, num_decoder_layers=n_layer)
    return cut


def check_t5_cut(torch, cut, prompts) -> dict:
    """(k1) The card's T0 against the port on the CPU, on the first T0_CUT
    layers of each stack at full width (the same bf16 tensors), on the
    first 2 of `prompts`: the
    relative-position buckets over distances -300..300 equal; prefill
    logits of 2 rows (every position), a decode step and a ring step
    within INT8_LOGIT_STEPS bf16 steps of the logits' scale; the cut's int8
    quantization on the card equal to the CPU's (every q, s and dense
    leaf), its int8 prefill and decode step within the same bound; 16
    greedy tokens in bf16 and in int8, which may differ from the CPU's only
    where the CPU's top-2 gap is under the bound; and the batch invariance
    on the card: row 0's prefill logits among all of `prompts` against the
    same prompt alone, within the same bound. Returns the errors, the
    logits' scale, the batch invariance and the CPU's smallest gaps."""
    from clipcap_tpu_torch.models.t5 import quantize_params, relative_position_bucket

    prompt = prompts[:2]

    rel = torch.arange(-300, 301, device="cuda")
    for bidir in (True, False):
        for nb, md in ((32, 128), (8, 32)):
            check(torch.equal(relative_position_bucket(rel, bidir, nb, md).cpu(),
                              relative_position_bucket(rel.cpu(), bidir, nb, md)),
                  f"(k1) buckets (bidirectional {bidir}, {nb}, {md}) differ from the CPU's")
    cpu = copy.deepcopy(cut).cpu()
    errs, n = {}, 16

    def steps(lm, p, ring: bool):
        dev = p.device
        logits, cache = lm.prefill(p, lm.init_cache(p.shape[0], p.shape[1] + 2),
                                   full_logits=True)
        tok = torch.argmax(logits[:, -1].float(), dim=-1)
        step, cache = lm.decode_step(lm.embed_tokens(tok)[:, None].to(p.dtype), cache)
        out = [logits.float(), step.float()]
        if ring:
            rc = lm.init_cache(p.shape[0], p.shape[1] + 3)
            _, rc = lm.prefill(p, rc)
            pos = torch.full((p.shape[0],), p.shape[1], dtype=torch.int64, device=dev)
            start = torch.zeros(p.shape[0], dtype=torch.int64, device=dev)
            r, _ = lm.decode_step_ring(lm.embed_tokens(tok)[:, None].to(p.dtype), rc, pos, start)
            out.append(r.float())
        return out, float(logits.float().abs().max())

    def greedy(card_lm, cpu_lm, label):
        card_toks, _ = greedy_with_gaps(torch, card_lm, prompt, n)
        cpu_toks, cpu_gaps = greedy_with_gaps(torch, cpu_lm, prompt.cpu(), n)
        for r in range(prompt.shape[0]):
            diff = (card_toks[r].cpu() != cpu_toks[r]).nonzero()
            if diff.numel():
                s_ = int(diff[0])
                check(float(cpu_gaps[r, s_]) < bound, f"(k1) {label} greedy row {r} differs "
                      f"from the CPU at step {s_}, where the CPU's gap is "
                      f"{float(cpu_gaps[r, s_]):.4g} (bound {bound:.4g})")
        return float(cpu_gaps.min())

    with torch.no_grad():
        card, scale = steps(cut, prompt, True)
        want, _ = steps(cpu, prompt.cpu(), True)
        bound = int8_bound(scale)
        for name, a, b in zip(("prefill", "decode", "ring"), card, want):
            errs[name] = max_abs(a.cpu(), b)
            check(bool(torch.isfinite(a).all()) and errs[name] <= bound,
                  f"(k1) bf16 {name} logits card vs CPU: max abs err {errs[name]:.4g} > "
                  f"{bound:.4g}")
        gaps = {"bf16": greedy(cut, cpu, "bf16")}
        q_card, q_cpu = quantize_params(cut), quantize_params(cpu)
        sd_cpu = q_cpu.state_dict()
        for name, t in q_card.state_dict().items():
            check(t.dtype == sd_cpu[name].dtype and torch.equal(t.cpu(), sd_cpu[name]),
                  f"(k1) int8 {name} differs from the CPU's quantization")
        card8, _ = steps(q_card, prompt, False)
        want8, _ = steps(q_cpu, prompt.cpu(), False)
        for name, a, b in zip(("int8 prefill", "int8 decode"), card8, want8):
            errs[name] = max_abs(a.cpu(), b)
            check(bool(torch.isfinite(a).all()) and errs[name] <= bound,
                  f"(k1) {name} logits card vs CPU: max abs err {errs[name]:.4g} > {bound:.4g}")
        gaps["int8"] = greedy(q_card, q_cpu, "int8")
        lb, _ = cut.prefill(prompts, cut.init_cache(prompts.shape[0], prompts.shape[1] + 1))
        l1, _ = cut.prefill(prompts[:1], cut.init_cache(1, prompts.shape[1] + 1))
        inv = max_abs(lb[0], l1[0])
        check(inv <= bound, f"(k1) the cut's row 0 in a {prompts.shape[0]}-row batch and alone: "
              f"max abs err {inv:.4g} > {bound:.4g}")
    del cpu, q_card, q_cpu, sd_cpu
    return dict(errs=errs, scale=scale, batch_invariance=inv, min_cpu_gap=gaps)


def t5_path(torch, counters, FS, S, card: str, work: Path,
            t0_layers: int = T0_LAYERS) -> tuple:
    """(k) T0-11B captioning at full width: CLIP ViT-B/32, the default
    mapper at width 4096 and T5Config.variant("t0-11b") at t0_layers of
    each stack (bigscience/T0: 24 + 24 layers, 4096 wide, 64 heads of 64, d_ff 10240,
    gated-gelu, an untied lm_head, vocabulary 32128), seeded on the card in
    bf16 and driven by token ids (T5IdTokenizer). (k-) K2/K3/K4 against
    their plain versions at T0's vocabulary (check_sampler at
    T0_SAMPLER_ROWS) and the cluster sizes there; (k0) the build, the
    encoder's K1 in bf16 and in f32 (the ViT cast); (k1) the 2 + 2-layer
    cut against the CPU (check_t5_cut); then on the bf16 LM and, after
    bundle.enable_int8_decode(), on the int8 one (T5Int8, float cache):
    (k2) greedy decode of 64 images x 67 tokens; (k3) the no-beam sweep,
    8 images x 9 top-p x 75 steps (K2 at [72, 32128]); (k4) beam search,
    64 images x beam 5 x 67 tokens (320 rows; 32 images in int8, for the
    run's time; cross-attention K/V
    recomputed from the encoder output every step), the best beams of 2
    images of the card's cut against the CPU's; (k5) serving, 256 requests
    on 64 slots, greedy and "fused_step" (K3 at [64, 32128]), the first
    greedy requests against their solo runs; (k6) cli.infer (beam, and
    --no_beam with --int8_decode) and cli.serve (float and --int8_decode)
    on a T0-width checkpoint of 2 + 2 layers and a 1-layer mapper, with a
    tokenizer.json written by `tokenizers`. The launch counters are set to
    0 just before (k0)'s encodes and read after (k6)."""
    import contextlib
    import dataclasses
    import io
    import math
    import types

    import numpy as np

    from clipcap_tpu_torch.cli import infer as infer_cli
    from clipcap_tpu_torch.cli import serve as serve_cli
    from clipcap_tpu_torch.cli.loading import load_captioner
    from clipcap_tpu_torch.core.config import CaptionerConfig, MapperConfig, T5Config, ViTConfig
    from clipcap_tpu_torch.data.preprocessing import normalize_on_device
    from clipcap_tpu_torch.decode.beam import beam_search_batched
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.decode.serving import Request, ServingEngine
    from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
    from clipcap_tpu_torch.models.bundle import CaptionerBundle
    from clipcap_tpu_torch.models.t5 import T5, T5Int8
    from clipcap_tpu_torch.train.checkpoints import save_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # (k-) the sampler kernels at T0's vocabulary; comparisons, not counted on the path
    t0 = time.perf_counter()
    FS._check_vocab(T0_VOCAB)
    k234, _ = check_sampler(torch, FS, S, vocab=T0_VOCAB, sampler_rows=T0_SAMPLER_ROWS,
                            timed_rows=T0_SAMPLER_ROWS, eos=T0_EOS)
    clusters = {r: FS.cluster_size(r, T0_VOCAB) for r in T0_SAMPLER_ROWS}
    say(f"(k-) sampler kernels at V={T0_VOCAB}: cluster sizes {clusters}; checked in "
        f"{time.perf_counter() - t0:.1f} s")

    # (k0) the captioner in bf16
    t0 = time.perf_counter()
    lm_cfg = dataclasses.replace(T5Config.variant("t0-11b"), num_layers=t0_layers,
                                 num_decoder_layers=t0_layers)
    cap_cfg = CaptionerConfig(lm_type="t0", lm_variant="t0-11b", visual_encoder_type="CLIP",
                              visual_encoder_variant="ViT-B/32",
                              mapper=MapperConfig(dim_embedding=lm_cfg.d_model))
    bt = CaptionerBundle.create(cap_cfg, lm_cfg, T5IdTokenizer(),
                                ViTConfig.clip_variant("ViT-B/32"), seed=31, device="cuda",
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lm = bt.model.lm
    check(isinstance(lm, T5) and lm.shared.dtype == torch.bfloat16 and lm.lm_head is not None,
          "(k0) not a bf16 T5 with an untied head")
    lm_params = sum(p.numel() for p in lm.parameters())
    say(f"(k0) T0-11B captioner seeded on the card in bf16 in {build_s:.1f} s: LM "
        f"{lm_params / 1e9:.3f} B params ({lm_params * 2 / 1e9:.2f} GB; {lm_cfg.num_layers} + "
        f"{lm_cfg.num_decoder_layers} layers, width {lm_cfg.d_model}, {lm_cfg.num_heads} heads "
        f"of {lm_cfg.d_kv}, d_ff {lm_cfg.d_ff}, {lm_cfg.feed_forward_proj}, vocab "
        f"{lm_cfg.vocab_size}), mapper "
        f"{sum(p.numel() for p in bt.model.mapper.parameters()) / 1e9:.3f} B")
    gen = torch.Generator(device="cuda").manual_seed(43)
    pixels = normalize_on_device(torch.rand(T0_BEAM_IMAGES["bf16"], 3, 224, 224,
                                            generator=gen, device="cuda"))
    torch.cuda.synchronize()
    counters(reset=True)
    with torch.no_grad():
        feats = bt.encode_image(pixels)  # K1 in bf16
        prompt = bt.project_prefix(feats)  # [64, 10, 4096] bf16
        vit32 = copy.deepcopy(bt.model.visual).float()
        feats32 = vit32(pixels, output="pooled")  # K1 in f32
        cos = float(torch.nn.functional.cosine_similarity(feats.float(), feats32, dim=-1).min())
    del vit32
    p_len = prompt.shape[1]
    k1 = counters()["fused_attention"]
    check(k1 == 24 and cos > 0.99, f"(k0) K1 launched {k1} times in a bf16 and an f32 encode "
          f"(want 24), or the two encodes disagree (min cosine {cos:.4f})")
    say(f"(k0) ViT-B/32 encode of {pixels.shape[0]} images in bf16 and in f32: K1 {k1} launches, "
        f"min cosine {cos:.5f}")

    t0 = time.perf_counter()
    cut = t5_cut(lm, T0_CUT)
    cut_check = check_t5_cut(torch, cut, prompt[:T0_BATCH])
    scale = cut_check["scale"]
    bound = int8_bound(scale)
    say(f"(k1) the {T0_CUT} + {T0_CUT}-layer cut at full width card vs CPU (bf16 both), max abs "
        "err: " + ", ".join(f"{k} {v:.4g}" for k, v in cut_check["errs"].items())
        + f" (bound {bound:.4g}: {INT8_LOGIT_STEPS} bf16 steps of max|logit| {scale:.3f}); "
        f"row 0 in a {T0_BATCH}-row batch and alone {cut_check['batch_invariance']:.4g}; "
        f"buckets equal; the cut's int8 q, s and dense leaves equal the CPU's; greedy tokens "
        f"differ only at near-ties (the CPU's smallest top-2 gaps {cut_check['min_cpu_gap']}) "
        f"({time.perf_counter() - t0:.1f} s)")

    n_rows, n_steps = T0_IMAGES * len(TOP_P_SWEEP), 75

    def sweep(steps: int = n_steps):
        return NoBeamCaptionSampler(top_p_values=TOP_P_SWEEP, max_decode_length=steps,
                                    device="cuda").sample_batch(bt, pixels[:T0_IMAGES])

    def greedy_call(steps: int = T0_GREEDY_NEW):
        return generate(bt.lm_decode, prompt[:T0_BATCH],
                        GenerationSettings(max_new_tokens=steps, greedy=True), device="cuda")

    def beam_call(images: int, steps: int = BEAM_NEW):
        return beam_search_batched(bt.lm_decode, prompt[:images], beam_size=BEAM,
                                   max_new_tokens=steps, stop_token_id=T0_STOP, device="cuda")

    pool = bt.project_prefix(torch.randn(SERVE_REQUESTS, 512, generator=gen, device="cuda"))
    serve_caps = np.random.default_rng(47).integers(8, 25, SERVE_REQUESTS).tolist()
    reqs = [Request(i, i, max_length=c) for i, c in enumerate(serve_caps)]
    base = GenerationSettings(max_new_tokens=SERVE_NEW, eos_token_id=T0_EOS)
    greedy = dataclasses.replace(base, greedy=True)
    serve_settings = {"greedy": greedy,
                      "fused_step": dataclasses.replace(base, top_p=0.8, repetition_penalty=1.2,
                                                        min_length=5, filter_method="fused_step")}
    results = {}

    def decode_phases(dtype: str) -> None:
        """(k2)-(k5) on bt.lm_decode: greedy, the sweep, beam search and serving."""
        lmd = bt.lm_decode
        r = results.setdefault(dtype, {})
        # (k2) greedy decode at batch 64 (the README's T0 configuration)
        t_sub = time.perf_counter()
        out, secs = timed_call(torch, greedy_call, lambda: greedy_call(2))
        check(out["tokens"].shape == (T0_BATCH, T0_GREEDY_NEW)
              and int(out["tokens"].max()) < T0_VOCAB, f"(k2) {dtype} greedy: wrong tokens")
        prof = per_step_profile(torch, f"(k2) {dtype} T0 greedy", greedy_call, 8, 16)
        # batch invariance at full depth: row 0's prefill logits in the
        # 64-row batch against the same prompt alone
        with torch.no_grad():
            l64, _ = lmd.prefill(prompt[:T0_BATCH], lmd.init_cache(T0_BATCH, p_len + 1))
            l1, _ = lmd.prefill(prompt[:1], lmd.init_cache(1, p_len + 1))
        inv = dict(max_abs_diff=max_abs(l64[0], l1[0]), scale=float(l1.float().abs().max()),
                   top1_equal=bool(torch.equal(l64[0].argmax(-1), l1[0].argmax(-1))))
        del l64, l1
        r["greedy"] = dict(captions_per_s=T0_BATCH / secs, wall_ms=secs * 1e3, **prof,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                           batch_invariance=inv)
        figure_line(card, f"(k2) T0-11B {dtype} greedy, batch {T0_BATCH}", r["greedy"])
        say(f"(k2) {dtype} T0-11B greedy, batch {T0_BATCH} x {T0_GREEDY_NEW} tokens on {card}: "
            f"{T0_BATCH / secs:.2f} captions/s; device {prof['device_ms_per_step']:.3f} ms and "
            f"{prof['launches_per_step']:.1f} launches per step; busy share "
            f"{prof['busy_share']:.3f}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"row 0's prefill logits in the {T0_BATCH}-row batch and alone differ by "
            f"{inv['max_abs_diff']:.4g} at scale {inv['scale']:.4g} "
            f"({time.perf_counter() - t_sub:.1f} s)")
        # (k3) the sweep: K2 at [72, 32128] once a step
        t_sub = time.perf_counter()
        k2 = counters()["fused_filter_sample"]
        caps, secs = timed_call(torch, sweep, lambda: sweep(2))
        k2 = counters()["fused_filter_sample"] - k2
        check(k2 == 2 + n_steps, f"(k3) {dtype}: K2 launched {k2} times in the warm-up and the "
              f"sweep, want one per decode step ({2 + n_steps})")
        ids = [int(t) for c in caps for s_ in c for t in s_.split()]
        check(len(caps) == T0_IMAGES and all(len(c) == len(TOP_P_SWEEP) for c in caps)
              and all(0 <= t < T0_VOCAB for t in ids), f"(k3) {dtype} sweep: wrong captions")
        prof = per_step_profile(torch, f"(k3) {dtype} T0 sweep", sweep, 8, 16)
        r["sweep"] = dict(captions_per_s=n_rows / secs, wall_ms=secs * 1e3, **prof)
        figure_line(card, f"(k3) T0-11B {dtype} sweep, {n_rows} rows", r["sweep"])
        say(f"(k3) {dtype} T0-11B sweep, {T0_IMAGES} images x {len(TOP_P_SWEEP)} top-p "
            f"({n_rows} rows, {n_steps} steps) on {card}: {n_rows / secs:.2f} captions/s; device "
            f"{prof['device_ms_per_step']:.3f} ms and {prof['launches_per_step']:.1f} launches "
            f"per step; busy share {prof['busy_share']:.3f} ({time.perf_counter() - t_sub:.1f} s)")
        # (k4) beam search: 64 images x beam 5 x 67 tokens
        t_sub = time.perf_counter()
        n_img = T0_BEAM_IMAGES[dtype]
        out, secs = timed_call(torch, lambda: beam_call(n_img), lambda: beam_call(2, 2))
        check(bool(torch.isfinite(out["scores"]).all()) and out["tokens"].shape == (
            n_img, BEAM, BEAM_NEW) and int(out["tokens"].max()) < T0_VOCAB,
              f"(k4) {dtype} beam: non-finite scores, a wrong shape or an id past the vocabulary")
        del out
        prof = profile_call(torch, f"(k4) {dtype} T0 beam", lambda: beam_call(n_img),
                            secs * 1e3)
        r["beam"] = dict(images=n_img, captions_per_s=n_img / secs, wall_ms=secs * 1e3,
                         device_ms_per_step=prof["busy_ms"] / BEAM_NEW,
                         launches_per_step=prof["launches"] / BEAM_NEW,
                         busy_share=prof["busy_ms"] / prof["wall_ms"],
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        figure_line(card, f"(k4) T0-11B {dtype} beam, {n_img * BEAM} rows", r["beam"])
        say(f"(k4) {dtype} T0-11B beam {n_img} images x beam {BEAM} x {BEAM_NEW} tokens "
            f"({n_img * BEAM} rows) on {card}: {r['beam']['captions_per_s']:.2f} captions/s; "
            f"device {r['beam']['device_ms_per_step']:.3f} ms and "
            f"{r['beam']['launches_per_step']:.1f} launches per step; busy share "
            f"{r['beam']['busy_share']:.3f}; peak {r['beam']['peak_gb']:.2f} GB "
            f"({time.perf_counter() - t_sub:.1f} s)")
        # (k5) serving: 256 requests on 64 slots, greedy and "fused_step"
        t_sub = time.perf_counter()
        served = {}
        for name, st in serve_settings.items():
            eng = bt.make_serving_engine(st, slots=SERVE_SLOTS, steps_per_sync=SERVE_SYNC,
                                         pipeline_depth=2).warmup()
            check(eng.lm is lmd and eng.dtype == torch.bfloat16,
                  f"(k5) {dtype} {name}: the engine does not run the bf16 decode LM")
            k3 = counters()["fused_step_sample"]
            t0 = time.perf_counter()
            res = eng.serve(reqs, seed=7, prefix_pool=pool)
            wall = time.perf_counter() - t0
            k3 = counters()["fused_step_sample"] - k3
            stats = eng.last_stats
            want_k3 = stats["steps"] if name == "fused_step" else 0
            check(k3 == want_k3, f"(k5) {dtype} {name}: K3 launched {k3} times over "
                  f"{stats['steps']} dispatched steps, want {want_k3}")
            check(sorted(res) == list(range(SERVE_REQUESTS)) and all(
                0 < len(x["tokens"]) <= serve_caps[i] for i, x in res.items()),
                  f"(k5) {dtype} {name}: not every request answered within its cap")
            lat = np.asarray([x["latency_s"] for x in res.values()])
            served[name] = res
            r[f"serve_{name}"] = dict(captions_per_s=SERVE_REQUESTS / wall,
                                      p50_s=float(np.percentile(lat, 50)),
                                      p99_s=float(np.percentile(lat, 99)),
                                      occupancy=stats["occupancy"], steps=stats["steps"])
            figure_line(card, f"(k5) T0-11B {dtype} serve {name}, {SERVE_REQUESTS} requests on "
                        f"{SERVE_SLOTS} slots", r[f"serve_{name}"])
            say(f"(k5) {dtype} T0-11B serve {SERVE_REQUESTS} requests ({name}; caps 8-24), "
                f"{SERVE_SLOTS} slots on {card}: {SERVE_REQUESTS / wall:.2f} captions/s; "
                f"latency_s p50 {r[f'serve_{name}']['p50_s']:.4f}, p99 "
                f"{r[f'serve_{name}']['p99_s']:.4f}; occupancy {stats['occupancy']}; "
                f"{stats['steps']} steps; K3 +{k3}")
            del eng
        # a served request against its solo run: the two batch it with
        # different rows, so their bf16 roundings differ, and 24 + 24 layers
        # of random weights amplify that noise (k2's batch invariance at
        # full depth against k1's at 2 + 2 layers): a flip is allowed where
        # the solo's top-2 gap is under the noise this model shows between
        # two batchings of one prompt. The cut's serving below holds the
        # strict bound.
        noise = r["greedy"]["batch_invariance"]["max_abs_diff"]
        flips = 0
        for i in range(GPTJ_SOLO):
            ref = generate(lmd, pool[i:i + 1],
                           dataclasses.replace(greedy, max_length=serve_caps[i]), device="cuda")
            want = ref["tokens"][0, : int(ref["lengths"][0])].tolist()
            got = served["greedy"][i]["tokens"]
            if got != want:
                s_ = first_difference(got, want)
                with torch.no_grad():
                    _, gaps = greedy_with_gaps(torch, lmd, pool[i:i + 1], SERVE_NEW)
                    solo, _ = lmd.prefill(pool[i:i + 1], lmd.init_cache(1, pool.shape[1] + 1))
                lim = max(bound, int8_bound(float(solo.float().abs().max())), noise)
                gap = float(gaps[0, s_])
                check(gap < lim, f"(k5) {dtype} request {i} differs from its solo generate "
                      f"at step {s_}, where the solo gap is {gap:.3e} (bound {lim:.3e})")
                flips += 1
        r["serve_flips"] = flips
        say(f"(k5) the first {GPTJ_SOLO} greedy requests against their solo generate: near-tie "
            f"flips {flips} ({time.perf_counter() - t_sub:.1f} s)")

    decode_phases("bf16")
    # (k5) serving on the 2 + 2-layer cut, where the batch noise is small:
    # 64 requests on 16 slots, each of the first T0_CUT_SOLO against its
    # solo run within the cut's strict bound
    t0 = time.perf_counter()
    eng = ServingEngine(cut, cut.cfg, prefix_len=p_len, settings=greedy, slots=16,
                        steps_per_sync=SERVE_SYNC, pipeline_depth=2, device="cuda",
                        dtype=torch.bfloat16)
    cut_res = eng.serve(reqs[:64], seed=7, prefix_pool=pool)
    cut_flips = 0
    for i in range(T0_CUT_SOLO):
        ref = generate(cut, pool[i:i + 1], dataclasses.replace(greedy, max_length=serve_caps[i]),
                       device="cuda")
        want = ref["tokens"][0, : int(ref["lengths"][0])].tolist()
        got = cut_res[i]["tokens"]
        if got != want:
            s_ = first_difference(got, want)
            with torch.no_grad():
                _, gaps = greedy_with_gaps(torch, cut, pool[i:i + 1], SERVE_NEW)
            gap = float(gaps[0, s_])
            check(gap < bound, f"(k5) the cut's request {i} differs from its solo generate at "
                  f"step {s_}, where the solo gap is {gap:.3e} (bound {bound:.3e})")
            cut_flips += 1
    results["bf16"]["cut_serve_flips"] = cut_flips
    del eng, cut_res
    say(f"(k5) the {T0_CUT} + {T0_CUT}-layer cut served 64 requests on 16 slots; the first "
        f"{T0_CUT_SOLO} against their solo generate: near-tie flips {cut_flips} (bound {bound:.4g}) "
        f"({time.perf_counter() - t0:.1f} s)")
    # (k4) the best beams of 2 images: the card's cut against the CPU's
    t0 = time.perf_counter()
    traced, card_sel, _ = traced_beam(torch, cut, prompt[:2], "cuda", T0_STOP)
    results["bf16"]["beam_flips"], _ = check_beam_vs_cpu(
        torch, types.SimpleNamespace(lm_decode=cut), prompt[:2], traced, card_sel,
        gap_bound=bound, label="(k4) the 2 + 2-layer cut's", stop=T0_STOP)
    say(f"(k4) cut beam check: {time.perf_counter() - t0:.1f} s")
    del traced, card_sel

    t0 = time.perf_counter()
    bt.enable_int8_decode()
    torch.cuda.synchronize()
    q8 = bt.lm_decode
    check(isinstance(q8, T5Int8) and not hasattr(q8, "chunked_forward"),
          "(k) the int8 LM is not T5Int8")
    int8_gb = sum(b.numel() * b.element_size() for b in q8.buffers()) / 1e9
    dense_gb = sum(p.numel() * p.element_size() for p in q8.parameters()) / 1e9
    say(f"(k) enable_int8_decode: {time.perf_counter() - t0:.1f} s; int8 LM {int8_gb:.2f} GB of "
        f"int8 weights and scales + {dense_gb:.2f} GB of bf16 tables and norms")
    decode_phases("int8")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # (k6) the CLIs on a T0-width checkpoint of 2 + 2 layers and a 1-layer mapper
    t_sub = time.perf_counter()
    small = copy.copy(bt.model)
    small._modules = dict(bt.model._modules)
    small.lm = cut
    small.mapper = copy.copy(bt.model.mapper)
    small.mapper._modules = dict(bt.model.mapper._modules)
    small.mapper.layers = torch.nn.ModuleList(list(bt.model.mapper.layers)[:1])
    small_cap = dataclasses.replace(cap_cfg, mapper=dataclasses.replace(cap_cfg.mapper,
                                                                          num_layers=1))
    small.cfg, small.lm_cfg = small_cap, cut.cfg
    ckpt = work / "t0_ckpt"
    save_checkpoint(str(ckpt), small, small_cap, cut.cfg)
    npz_gb = (ckpt / "consolidated.npz").stat().st_size / 1e9
    model, l_cap, l_lm, _ = load_captioner(str(ckpt), device="cuda")
    want = small.state_dict()
    for name, p in model.state_dict().items():
        check(p.is_cuda and p.dtype == want[name].dtype and torch.equal(p, want[name]),
              f"(k6) the T0 checkpoint's {name} differs from what was written")
    check(l_cap == small_cap and l_lm == cut.cfg and isinstance(model.lm, T5),
          "(k6) the T0 checkpoint's configs differ")
    write_t5_tokenizer(work / "t5_vocab")
    write_read_s = time.perf_counter() - t_sub
    del model, want, small, bt, lm, cut, q8, pool, prompt, pixels, feats, feats32
    torch.cuda.empty_cache()
    say(f"(k6) T0 checkpoint ({npz_gb:.2f} GB .npz, full width, {T0_CUT} + {T0_CUT} layers, "
        f"1-layer mapper) written and read back bit for bit, tokenizer.json of {T0_WORDS} "
        f"entries written by tokenizers, in {write_read_s:.1f} s")
    common = ["--checkpoint_path", str(ckpt), "--tokenizer_vocab_dir", str(work / "t5_vocab"),
              "--device", "cuda"]
    clip = ["--clip_model", "ViT-B/32", "--clip_checkpoint", str(work / "clip.pt"),
            "--clip_merges", str(work / "clip_merges.txt")]
    cli_s = {}
    for name, extra, n_img, want_k2 in (
            ("beam", ["--total_samples", "8"], 8, 0),
            ("int8_no_beam", ["--no_beam", "--int8_decode", "--total_samples", "2"], 2, 75 * 2)):
        before = counters()
        t0 = time.perf_counter()
        with open(work / f"t0_{name}.txt", "w") as log, contextlib.redirect_stdout(log):
            data = infer_cli.main(common + clip + extra + [
                "--folder_path", str(work / "images"),
                "--out_filename_prefix", str(work / f"t0_{name}")])
        cli_s[f"infer_{name}"] = time.perf_counter() - t0
        after = counters()
        check(len(data) == n_img and all(len(e["generated_captions"]) == 1 and all(
            math.isfinite(v) for v in e["scores"].values()) for e in data.values()),
              f"(k6) cli.infer {name}: not one caption and finite scores per image")
        k2 = after["fused_filter_sample"] - before["fused_filter_sample"]
        check(k2 == want_k2 and after["fused_attention"] > before["fused_attention"],
              f"(k6) cli.infer {name}: K2 rose by {k2}, want {want_k2}, or K1 did not run")
    for int8 in ("", "--int8_decode"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            n = serve_cli.main(common + ([int8] if int8 else []) + [
                "--prefixes_npy", str(work / "int8_feats.npy"),
                "--out_jsonl", str(work / f"t0_serve{int8}.jsonl"), "--slots", "16",
                "--max_new_tokens", "24", "--eos_token_id", str(T0_EOS)])
        cli_s[f"serve{int8 and '_int8'}"] = time.perf_counter() - t0
        lines = [json.loads(x) for x in
                 (work / f"t0_serve{int8}.jsonl").read_text().splitlines()]
        check(n == 64 and len(lines) == 64 and all(0 < x["tokens"] <= 24 for x in lines),
              f"(k6) cli.serve {int8}: wrong JSONL")
    launches = counters()
    say(f"(k6) the CLIs on the T0 checkpoint, seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in cli_s.items())
        + f"; well-formed outputs ({time.perf_counter() - t_sub:.1f} s)")
    figure_line(card, "(k) T0-11B peak device memory", dict(peak_gb=peak_gb, int8_gb=int8_gb))
    say(f"(k) peak device memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)")
    say(f"T0 phase (k): {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(t0_layers=t0_layers, build_s=build_s, cut=cut_check, decode=results,
                          cli_s=cli_s, peak_gb=peak_gb, npz_gb=npz_gb, int8_gb=int8_gb,
                          sampler_v32128={name: dict(k234[name], cluster=clusters)
                                          for name in k234})


# --- 12. the preprocessing path (phase (l)) ------------------------------------------

PREP_IMAGES, PREP_L14_IMAGES, PREP_CPU_IMAGES = 2048, 512, 64
PREP_BATCHES = (256, 1024)  # BASELINE config #5 runs 1024, the CLI's default is 256
PREP_SHARD = 1000  # shard_size: two shards of 2048 images at either batch
INT8_MIN_COSINE = 0.995  # (i5)'s bound: the int8 encoder against the float one
# the attention shapes [B, T, H, dh] the encoders hand K1 in phase (l)
K1_PREP_SHAPES = [(1024, 50, 12, 64), (256, 50, 12, 64), (256, 257, 16, 64)]


def prep_sample(seed: int, i: int) -> tuple:
    """Sample i of a seeded webdataset: a JPEG of sides 200-640 px at quality
    90 (a smooth colour field with noise, which compresses as photos do) and
    a 5-30-word caption."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng((seed, i))
    w, h = (int(v) for v in rng.integers(200, 641, size=2))
    small = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(small).resize((w, h), Image.Resampling.BICUBIC), np.int16)
    img = np.clip(base + rng.integers(-12, 13, (h, w, 3), dtype=np.int16), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG", quality=90)
    words = rng.choice(CAPTION_WORDS, size=int(rng.integers(5, 31)))
    return buf.getvalue(), " ".join(words) + "."


def write_tar(path: Path, samples, start: int = 0) -> None:
    """A webdataset tar: members {key}.jpg and {key}.txt per sample."""
    import io
    import tarfile

    path.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i, (jpg, txt) in enumerate(samples, start):
            for ext, data in (("jpg", jpg), ("txt", txt.encode())):
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def check_attention_preprocess(torch, FA, shapes=K1_PREP_SHAPES,
                               label: str = "phase (l)'s encoders") -> list:
    """K1 against its plain version at the shapes of a phase's encoders
    (phase (l)'s by default; f32 views of one packed qkv projection), with
    the device times of the kernel, the plain version and SDPA beside the
    bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(12)
    out = []
    for b, t, h, dh in shapes:
        q, k, v = packed_qkv(torch, gen, b, t, h, dh, torch.float32)
        got = FA.fused_attention(q, k, v)
        torch.cuda.synchronize()
        err = assert_close(torch, got, FA.fused_attention_plain(
            q.contiguous(), k.contiguous(), v.contiguous()), *K1_TOL["float32"],
            f"K1 packed qkv B={b} T={t} H={h} dh={dh} float32")

        def sdpa():
            return F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)))

        # SDPA's error against the plain version, beside the kernel's: its f32
        # path may run on TF32 tensor cores, where K1 runs 3xTF32
        library_err = max_abs(sdpa().transpose(1, 2), FA.fused_attention_plain(q, k, v))
        del got
        # the kernel's device time per launch (the profiler's events of its
        # name), and CUDA events over many calls for it, the plain version and
        # SDPA: a summed profile of a call here once held one call's kernels of
        # five (SDPA's sum was a fifth of its CUDA-event time)
        ms = device_ms(torch, lambda: FA.fused_attention(q, k, v), kernel="attn_kernel")
        wall_ms = time_ms(torch, lambda: FA.fused_attention(q, k, v), 10)
        plain_ms = time_ms(torch, lambda: FA.fused_attention_plain(q, k, v), 3)
        library_ms = time_ms(torch, sdpa, 10)
        bound_ms, bound_by = attention_bound(b, t, h, dh, "f32")
        say(f"K1 B={b} T={t} H={h} dh={dh} f32 packed qkv ({label}): max abs err "
            f"{err:.3e} (atol {K1_TOL['float32'][0]}, rtol {K1_TOL['float32'][1]}; SDPA's "
            f"{library_err:.3e}); kernel {ms:.4f} device ms ({wall_ms:.4f} by CUDA events); "
            f"by CUDA events: plain {plain_ms:.4f}, SDPA {library_ms:.4f}; bound "
            f"{bound_ms:.4f} ({bound_by})")
        out.append(dict(shape=[b, t, h, dh], max_abs_err=err, ms=ms, wall_ms=wall_ms,
                        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_max_abs_err=library_err))
        del q, k, v
        torch.cuda.empty_cache()
    return out


def preprocess_path(torch, counters, FA, card: str, work: Path) -> tuple:
    """Phase (l): dataset preprocessing (tools/preprocess.py) at full width.
    Writes PREP_IMAGES seeded JPEGs with captions in two webdataset tars, a
    GPT-2 vocabulary and OpenAI-layout ViT-B/32 and ViT-L/14 state dicts;
    (l1) times the host decode alone, (l2) the encoders alone on pixels
    already on the card, (l3) runs the CLI end to end from the tars (ViT-B/32
    f32 at batch 256 and 1024, int8 at 1024, ViT-L/14 at 256 over
    PREP_L14_IMAGES images) with the launch counters set to 0 just before
    each run and read just after, and checks the shards: both readers give
    equal batches, the first PREP_CPU_IMAGES token rows equal a CPU run's and
    their prefixes lie within CARD_VS_CPU of it, and the int8 prefixes lie
    within INT8_MIN_COSINE of the f32 ones. K1 is held against its plain
    version at the encoders' shapes."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from clipcap_tpu_torch.core.config import ViTConfig
    from clipcap_tpu_torch.data import native_jpeg
    from clipcap_tpu_torch.data.native_loader import NativeTokenPrefixDataset
    from clipcap_tpu_torch.data.pipeline import device_prefetch
    from clipcap_tpu_torch.data.preprocessing import clip_preprocess_u8
    from clipcap_tpu_torch.data.token_prefix import TokenPrefixDataset
    from clipcap_tpu_torch.tokenizers import create_tokenizer
    from clipcap_tpu_torch.tools import preprocess as prep

    t_phase = time.perf_counter()
    root = work / "prep"
    cores = os.cpu_count()
    with ThreadPoolExecutor(cores) as pool:
        samples = list(pool.map(lambda i: prep_sample(12, i), range(PREP_IMAGES)))
    half = PREP_IMAGES // 2
    write_tar(root / "wds" / "000.tar", samples[:half])
    write_tar(root / "wds" / "001.tar", samples[half:], half)
    write_tar(root / "l14" / "000.tar", samples[:PREP_L14_IMAGES])
    write_tar(root / "cpu" / "000.tar", samples[:PREP_CPU_IMAGES])
    write_gpt2_vocab(root / "vocab")
    cfgs = {name: ViTConfig.clip_variant(name) for name in ("ViT-B/32", "ViT-L/14")}
    sd_paths = {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        sd_paths[name] = root / f"clip_{cfg.layers}.pt"
        torch.save({k: v for k, v in clip_openai_state_dict(torch, cfg, 30 + i).items()
                    if k.startswith("visual.")}, sd_paths[name])
    jpg_mb = sum(len(j) for j, _ in samples) / 2**20
    say(f"(l) inputs: {PREP_IMAGES} JPEGs ({jpg_mb:.1f} MB, quality 90, sides 200-640 px) with "
        f"5-30-word captions in two tars, ViT-B/32 and ViT-L/14 state dicts "
        f"({time.perf_counter() - t_phase:.1f} s); {cores} host cores "
        f"({len(os.sched_getaffinity(0))} usable)")

    # (l1) the host's decode alone: JPEG -> 224x224 CHW uint8, CLIP geometry
    datas = [j for j, _ in samples]
    try:
        native_jpeg.decode_batch_u8(datas[:1], 224)
        native = True
    except ImportError as err:  # no g++ or no libjpeg on this machine
        lines = str(err).splitlines()
        native, why = False, " ".join(x.strip() for x in lines if "error" in x) or lines[0]
    decode_rates = {}
    if native:
        decoder = "native libjpeg"
        for threads, n in ((1, min(512, PREP_IMAGES)), (cores, PREP_IMAGES)):
            t0 = time.perf_counter()
            px, status = native_jpeg.decode_batch_u8(datas[:n], 224, n_threads=threads)
            dt = time.perf_counter() - t0
            check(bool((status == native_jpeg.OK).all()), f"(l1) native decode failed on "
                  f"{int((status != native_jpeg.OK).sum())} of {n} images")
            decode_rates[f"native_{threads}_threads"] = n / dt
    else:
        decoder = "PIL"
        say(f"(l1) the native JPEG decoder does not build on this machine ({why}); phase (l) "
            f"decodes with PIL")

    def pil_decode(data):
        return clip_preprocess_u8(prep._decode_image(data), 224)

    for threads, n in ((1, min(128, PREP_IMAGES)),
                       (cores, min(512, PREP_IMAGES) if native else PREP_IMAGES)):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            pil_px = np.stack(list(pool.map(pil_decode, datas[:n])))
        decode_rates[f"pil_{threads}_threads"] = n / (time.perf_counter() - t0)
    if not native:
        px = pil_px
    figure_line(card, "(l1) host decode alone, images/s", dict(cores=cores, **decode_rates))
    say(f"(l1) host decode alone (JPEG -> 224 px CHW uint8), images/s on {cores} cores: "
        + ", ".join(f"{k.replace('_', ' ')} {v:.1f}" for k, v in decode_rates.items())
        + f"; the path decodes with {decoder}")
    # the decoded pixels staged on the card by data/pipeline.device_prefetch
    # (pinned copies on a side stream, an event the consumer's stream waits on)
    small, big = PREP_BATCHES
    pixels = torch.cat(list(device_prefetch((px[i:i + small] for i in range(0, len(px), small)),
                                            device="cuda")))
    check(torch.equal(pixels.cpu(), torch.from_numpy(px)),
          "(l1) device_prefetch staged other pixels than the decoder's")
    del pil_px, px

    # (l2) the encoders alone, uint8 pixels already on the card (the /255 and
    # the normalization included), K1 once a layer per encode
    enc_rates = {}
    for name, int8, batch in (("ViT-B/32", False, small), ("ViT-B/32", False, big),
                              ("ViT-B/32", True, small), ("ViT-B/32", True, big),
                              ("ViT-L/14", False, small)):
        encode, cfg = prep.make_clip_encoder(name, str(sd_paths[name]), pooled=True,
                                             quantize_int8=int8, device="cuda")
        label = f"{name} {'int8' if int8 else 'f32'} B={batch}"
        x = pixels[:batch]
        counters(reset=True)
        feats = encode(x)
        torch.cuda.synchronize()
        k1 = counters()["fused_attention"]
        check(k1 == cfg.layers and feats.shape == (batch, cfg.output_dim)
              and bool(torch.isfinite(feats).all()),
              f"(l2) {label}: K1 launched {k1} times (want {cfg.layers}), features "
              f"{tuple(feats.shape)}")
        wall_ms = time_ms(torch, lambda: encode(x), iters=3)
        dev_ms = device_ms(torch, lambda: encode(x), iters=3)
        enc_rates[label] = dict(images_per_s=batch / (wall_ms / 1e3), device_ms=dev_ms,
                                wall_ms=wall_ms, k1_per_encode=k1)
        say(f"(l2) encoder alone, {label}: {batch / (wall_ms / 1e3):.1f} images/s, "
            f"{wall_ms:.2f} ms a batch (CUDA events), device {dev_ms:.2f} ms a batch; K1 {k1}")
        del encode, feats
        torch.cuda.empty_cache()
    figure_line(card, "(l2) encoders alone", enc_rates)
    del pixels

    # (l3) the CLI end to end, from the tars to the shards
    common = ["--tokenizer_vocab_dir", str(root / "vocab"), "--shard_size", str(PREP_SHARD),
              "--num_prepro_workers", str(cores)] + ([] if native else ["--no_native_jpeg"])
    e2e, launches = {}, 0
    tokenizer = create_tokenizer("gpt2", str(root / "vocab"))
    runs = (("b32_f32_small", "ViT-B/32", False, small, "wds/{000..001}.tar", PREP_IMAGES),
            ("b32_f32_big", "ViT-B/32", False, big, "wds/{000..001}.tar", PREP_IMAGES),
            ("b32_int8_big", "ViT-B/32", True, big, "wds/{000..001}.tar", PREP_IMAGES),
            ("l14_f32_small", "ViT-L/14", False, small, "l14/000.tar", PREP_L14_IMAGES))
    for label, name, int8, batch, tars, n in runs:
        cfg = cfgs[name]
        label = label.replace("small", str(small)).replace("big", str(big))
        argv = ["--input_dataset", str(root / tars), "--clip_model", name,
                "--clip_checkpoint", str(sd_paths[name]), "--batch_size", str(batch),
                "--device", "cuda", *common, *(["--quantize_int8"] if int8 else [])]
        counters(reset=True)
        stats = prep.main(argv + ["--output_folder", str(root / "out" / label)])
        torch.cuda.synchronize()
        k1 = counters()["fused_attention"]
        launches += k1
        batches = -(-n // batch)
        shards = -(-n // (-(-PREP_SHARD // batch) * batch))
        check(stats["samples"] == n and stats["shards"] == shards and k1 == cfg.layers * batches,
              f"(l3) {label}: {stats['samples']} samples in {stats['shards']} shards, K1 {k1} "
              f"(want {n}, {shards}, {cfg.layers * batches})")
        # the device's busy share of the preprocessing loop: the same run under
        # the profiler, with the encoder and tokenizer built before it
        encode, _ = prep.make_clip_encoder(name, str(sd_paths[name]), pooled=True,
                                           quantize_int8=int8, device="cuda")
        prof = profile_call(torch, f"(l3) {label}", lambda: prep.preprocess_dataset(
            str(root / tars), str(root / "out_profiled" / label), tokenizer=tokenizer,
            encode_fn=encode, image_size=cfg.image_size, batch_size=batch,
            shard_size=PREP_SHARD, num_prepro_workers=cores, use_native_jpeg=native,
            device="cuda"), 1e3 * n / stats["ips"])
        del encode
        e2e[label] = dict(images_per_s=stats["ips"], samples=n, shards=stats["shards"],
                          k1=k1, busy_share=prof["busy_ms"] / prof["wall_ms"],
                          busy_ms=prof["busy_ms"], decoder=decoder)
        say(f"(l3) {label} end to end ({decoder} decode on {cores} threads): "
            f"{stats['ips']:.1f} images/s, {stats['shards']} shards, K1 {k1}, device busy "
            f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f}% (profiled rerun)")
        torch.cuda.empty_cache()
    figure_line(card, "(l3) preprocessing end to end", e2e)

    def shards(label):
        out = root / "out" / label
        names = sorted(p.name for p in (out / "prefixes").glob("*.npy"))
        return (np.concatenate([np.load(out / "prefixes" / f) for f in names]),
                np.concatenate([np.load(out / "tokens" / f) for f in names]))

    # the shards read back through both readers as the same batches
    f32_dir = str(root / "out" / f"b32_f32_{big}")
    py, nat = iter(TokenPrefixDataset(f32_dir, batch_size=256)), None
    try:
        nat = NativeTokenPrefixDataset(f32_dir, batch_size=256)
        nat_it = iter(nat)
        for i in range(10):  # past the end of the 2048 rows: the wrap too
            (pt, pp), (nt, npf) = next(py), next(nat_it)
            check(np.array_equal(pt, nt) and np.array_equal(pp, npf),
                  f"(l3) batch {i}: TokenPrefixDataset and NativeTokenPrefixDataset differ")
    finally:
        if nat is not None:
            nat.close()
    # the card's shards against the same CLI on the CPU, on the first images
    f32_p, f32_t = shards(f"b32_f32_{big}")
    check(f32_t.shape == (PREP_IMAGES, 128) and (f32_t[:, 0] == 50256).all(),
          f"(l3) token shards {f32_t.shape}, not bos-first rows of 128")
    p, t = shards(f"b32_f32_{small}")
    check(np.array_equal(t, f32_t) and np.allclose(p, f32_p, rtol=CARD_VS_CPU[1],
                                                   atol=CARD_VS_CPU[0]),
          f"(l3) the shards at batch {small} differ from those at {big}")
    t0 = time.perf_counter()
    prep.main(["--input_dataset", str(root / "cpu" / "000.tar"), "--clip_model", "ViT-B/32",
               "--clip_checkpoint", str(sd_paths["ViT-B/32"]), "--batch_size",
               str(PREP_CPU_IMAGES), "--output_folder", str(root / "out" / "cpu"),
               "--device", "cpu", *common])
    cpu_s = time.perf_counter() - t0
    cpu_p, cpu_t = shards("cpu")
    check(np.array_equal(cpu_t, f32_t[:PREP_CPU_IMAGES]),
          f"(l3) the card's first {PREP_CPU_IMAGES} token rows differ from the CPU run's")
    cpu_err = float(np.abs(cpu_p - f32_p[:PREP_CPU_IMAGES]).max())
    check(np.allclose(f32_p[:PREP_CPU_IMAGES], cpu_p, rtol=CARD_VS_CPU[1], atol=CARD_VS_CPU[0]),
          f"(l3) the card's prefixes lie {cpu_err:.3e} from the CPU run's (bound atol "
          f"{CARD_VS_CPU[0]}, rtol {CARD_VS_CPU[1]})")
    q_p, q_t = shards(f"b32_int8_{big}")
    cos = (q_p * f32_p).sum(-1) / (np.linalg.norm(q_p, axis=-1) * np.linalg.norm(f32_p, axis=-1))
    check(np.array_equal(q_t, f32_t) and float(cos.min()) > INT8_MIN_COSINE,
          f"(l3) int8 prefixes: min cosine to f32 {float(cos.min()):.5f} <= {INT8_MIN_COSINE}")
    l14_p, l14_t = shards(f"l14_f32_{small}")
    check(l14_p.shape == (PREP_L14_IMAGES, cfgs["ViT-L/14"].output_dim)
          and bool(np.isfinite(l14_p).all()) and np.array_equal(l14_t, f32_t[:PREP_L14_IMAGES]),
          f"(l3) ViT-L/14 shards {l14_p.shape}")
    say(f"(l3) checks: both readers' batches equal; tokens of the first {PREP_CPU_IMAGES} images "
        f"equal the CPU run's ({cpu_s:.1f} s), prefixes {cpu_err:.3e} from it (bound "
        f"{CARD_VS_CPU[0]}); int8 prefixes min cosine {float(cos.min()):.5f} to f32 (bound "
        f"{INT8_MIN_COSINE}); ViT-L/14 {l14_p.shape} finite")

    k1_shapes = check_attention_preprocess(torch, FA)
    say(f"preprocessing phase (l): {time.perf_counter() - t_phase:.1f} s")
    return {"fused_attention": launches}, dict(decode=decode_rates, encoder=enc_rates,
                                               end_to_end=e2e, cpu_max_abs_err=cpu_err,
                                               int8_min_cosine=float(cos.min()),
                                               k1_shapes=k1_shapes, decoder=decoder)


# --- 13. Gen B: BLIP caption synthesis and its rankers (phase (m)) --------------------

GENB_VOCAB, GENB_EOS, GENB_CANDIDATES = 30524, 102, 40  # BERT + [DEC]/[ENC]; [SEP]
GENB_CUT, GENB_NOISE_STEPS = 2, 8  # the text decoder's cut held against the CPU
# the attention shapes [B, T, H, dh] phase (m)'s encoders hand K1: BLIP ViT-L/16
# and ViT-B/16 at 384 px, CLIP ViT-L/14 at 224 px, one image each
K1_GENB_SHAPES = [(1, 577, 16, 64), (1, 577, 12, 64), (1, 257, 16, 64)]
# the rankers' OpenAI text towers: ViT-L/14's and RN50x64's
L14_TEXT = dict(vocab_size=49408, context_length=77, width=768, layers=12, output_dim=768)
RN50X64_TEXT = dict(vocab_size=49408, context_length=77, width=1024, layers=12,
                    output_dim=1024)
GENB_MODES = ("CLIP-ViT-L", "CLIP-RN50x64", "CLIP-ViT-L+RN50x64", "ITM", "ITC")
RANK_ATOL = 1e-3  # a ranker's scores on the card against the port on the CPU


def write_bert_vocab(path: Path) -> None:
    """A WordPiece vocab.txt of BLIP's size (30524) in BERT's layout: [PAD]
    0, [unused0-98], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, whole
    words (the Gen-B prompt's among them), '##' pieces, and BLIP's [DEC]
    30522 and [ENC] 30523 last."""
    toks = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "picture"] + list(CAPTION_WORDS))
    toks = list(dict.fromkeys(toks))
    n_words = (GENB_VOCAB - 2 - len(toks)) // 2
    toks += [f"w{i}" for i in range(n_words)]
    toks += [f"##p{i}" for i in range(GENB_VOCAB - 2 - len(toks))] + ["[DEC]", "[ENC]"]
    check(len(toks) == GENB_VOCAB and toks[GENB_EOS] == "[SEP]", "BERT vocabulary malformed")
    path.write_text("\n".join(toks) + "\n")


def _draw(torch, seed: int, dtype):
    """w(*shape, s): N(0, s^2) drawn on the card from a seeded generator,
    returned on the host in `dtype`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape, s=0.02):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype).cpu()
    return w


def blip_vision_hf(w, prefix: str, vit_cfg) -> dict:
    """HF BlipVisionModel's keys and shapes under `prefix`."""
    d, p, h = vit_cfg.width, vit_cfg.patch_size, int(vit_cfg.width * vit_cfg.mlp_ratio)
    sd = {prefix + "embeddings.class_embedding": w(1, 1, d),
          prefix + "embeddings.position_embedding": w(1, vit_cfg.seq_len, d),
          prefix + "embeddings.patch_embedding.weight": w(d, 3, p, p),
          prefix + "embeddings.patch_embedding.bias": w(d),
          prefix + "post_layernorm.weight": 1 + w(d), prefix + "post_layernorm.bias": w(d)}
    for i in range(vit_cfg.layers):
        s = f"{prefix}encoder.layers.{i}."
        sd.update({s + "self_attn.qkv.weight": w(3 * d, d), s + "self_attn.qkv.bias": w(3 * d),
                   s + "self_attn.projection.weight": w(d, d),
                   s + "self_attn.projection.bias": w(d),
                   s + "layer_norm1.weight": 1 + w(d), s + "layer_norm1.bias": w(d),
                   s + "layer_norm2.weight": 1 + w(d), s + "layer_norm2.bias": w(d),
                   s + "mlp.fc1.weight": w(h, d), s + "mlp.fc1.bias": w(h),
                   s + "mlp.fc2.weight": w(d, h), s + "mlp.fc2.bias": w(d)})
    return sd


def bert_hf(w, prefix: str, cfg, lm_head: bool) -> dict:
    """HF BlipTextLMHeadModel's keys ("bert."-rooted, with the MLM head)
    or BlipTextModel's (bare) under `prefix`, cross-attention included."""
    d, f, ew, v = cfg.hidden_size, cfg.intermediate_size, cfg.encoder_width, cfg.vocab_size
    b = prefix + "bert." if lm_head else prefix
    sd = {b + "embeddings.word_embeddings.weight": w(v, d),
          b + "embeddings.position_embeddings.weight": w(cfg.max_position_embeddings, d),
          b + "embeddings.LayerNorm.weight": 1 + w(d), b + "embeddings.LayerNorm.bias": w(d)}
    for i in range(cfg.num_layers):
        s = f"{b}encoder.layer.{i}."
        for kind, kv in (("attention", d), ("crossattention", ew)):
            for name, width in (("query", d), ("key", kv), ("value", kv)):
                sd[f"{s}{kind}.self.{name}.weight"] = w(d, width)
                sd[f"{s}{kind}.self.{name}.bias"] = w(d)
            sd.update({f"{s}{kind}.output.dense.weight": w(d, d),
                       f"{s}{kind}.output.dense.bias": w(d),
                       f"{s}{kind}.output.LayerNorm.weight": 1 + w(d),
                       f"{s}{kind}.output.LayerNorm.bias": w(d)})
        sd.update({s + "intermediate.dense.weight": w(f, d), s + "intermediate.dense.bias": w(f),
                   s + "output.dense.weight": w(d, f), s + "output.dense.bias": w(d),
                   s + "output.LayerNorm.weight": 1 + w(d), s + "output.LayerNorm.bias": w(d)})
    if lm_head:
        c = prefix + "cls.predictions."
        sd.update({c + "transform.dense.weight": w(d, d), c + "transform.dense.bias": w(d),
                   c + "transform.LayerNorm.weight": 1 + w(d),
                   c + "transform.LayerNorm.bias": w(d), c + "decoder.weight": w(v, d),
                   c + "bias": w(v)})
    return sd


def clip_resnet_openai_state_dict(torch, rn_cfg, seed: int) -> dict:
    """A seeded OpenAI-layout CLIP ResNet state dict in fp16 (as OpenAI
    ships its checkpoints): the `visual.*` tower of `rn_cfg` (BatchNorm
    statistics off identity) and RN50X64_TEXT's text tower."""
    w = _draw(torch, seed, torch.float16)

    def bn(p, c):
        return {f"{p}.weight": 1 + w(c, s=0.05), f"{p}.bias": w(c),
                f"{p}.running_mean": w(c), f"{p}.running_var": 1 + w(c).abs(),
                f"{p}.num_batches_tracked": torch.tensor(0)}

    def conv(cout, cin, k):
        return w(cout, cin, k, k, s=(cin * k * k) ** -0.5)

    width = rn_cfg.width
    sd = {"visual.conv1.weight": conv(width // 2, 3, 3), **bn("visual.bn1", width // 2),
          "visual.conv2.weight": conv(width // 2, width // 2, 3), **bn("visual.bn2", width // 2),
          "visual.conv3.weight": conv(width, width // 2, 3), **bn("visual.bn3", width)}
    inplanes = width
    for stage, blocks in enumerate(rn_cfg.layers):
        planes = width * 2**stage
        for j in range(blocks):
            p = f"visual.layer{stage + 1}.{j}"
            sd.update({f"{p}.conv1.weight": conv(planes, inplanes, 1), **bn(f"{p}.bn1", planes),
                       f"{p}.conv2.weight": conv(planes, planes, 3), **bn(f"{p}.bn2", planes),
                       f"{p}.conv3.weight": conv(planes * 4, planes, 1),
                       **bn(f"{p}.bn3", planes * 4)})
            if j == 0:
                sd.update({f"{p}.downsample.0.weight": conv(planes * 4, inplanes, 1),
                           **bn(f"{p}.downsample.1", planes * 4)})
            inplanes = planes * 4
    spacial = rn_cfg.image_size // 32
    sd["visual.attnpool.positional_embedding"] = w(spacial**2 + 1, inplanes, s=inplanes**-0.5)
    for name, out in (("q", inplanes), ("k", inplanes), ("v", inplanes),
                      ("c", rn_cfg.output_dim)):
        sd[f"visual.attnpool.{name}_proj.weight"] = w(out, inplanes, s=inplanes**-0.5)
        sd[f"visual.attnpool.{name}_proj.bias"] = w(out)
    text = {k: v for k, v in clip_openai_state_dict(torch, None, seed + 1, RN50X64_TEXT,
                                                    torch.float16).items()
            if not k.startswith("visual.")}
    return {**sd, **text}


def check_sampler_genb(torch, FS, S, rows: int = GENB_CANDIDATES, top_k: float = 2500.0,
                       top_p=None, label: str = "(m1)") -> dict:
    """K2 at a synthesis step's shape, [rows, 30524] ((m1): the default
    40-slot grid; (n4): each sweep trial's batch size, top-k and top-p):
    seeded logits after a 1.3 repetition penalty over a 12-token history,
    top-k `top_k` and the per-row top-p (the default grid's, or `top_p` on
    every row; each moved to mid-gap, as check_sampler does), injected
    noise: next and alt exact, alt_prob within
    SAMPLER_RTOL of the plain version; the per-row numpy vectors that
    hetero.sample hands the engine give the same draws as tensors; Philox
    draws inside the plain filter's kept set; then the device times of the
    kernel at Gen B's flags (top-k and top-p, no alt_prob), the plain
    version and the bound, and the cluster size the launcher picks."""
    import numpy as np

    from clipcap_tpu_torch.cli.synthesis import default_grids

    vocab = GENB_VOCAB
    FS._check_vocab(vocab)
    gen = torch.Generator(device="cuda").manual_seed(41)
    raw = torch.randn(rows, vocab, generator=gen, device="cuda") * 3
    hist = torch.randint(0, vocab, (rows, 12), generator=gen, device="cuda")
    x = S.repetition_penalty(raw, hist, 1.3).contiguous()
    grid = torch.tensor(default_grids(n=rows)[0] if top_p is None
                        else np.full(rows, top_p, np.float32), device="cuda")
    kk = FS.resolve_top_k(top_k, rows, vocab, "cuda")
    pp, gap = mid_gap_top_p(torch, FS, x, kk, grid)
    noise = S.gumbel_like(x, gen)
    got = FS.fused_filter_sample(x, top_k, pp, 7, gumbel_noise=noise)
    want = FS.sampler_plain(x, kk, pp, 7, do_topk=True, do_topp=True, want_alt_prob=True,
                            gumbel_noise=noise)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label} K2 [{rows}, {vocab}]: next or alt differs from the plain version")
    err = assert_close(torch, got[2], want[2], 1e-7, SAMPLER_RTOL, f"{label} K2 alt_prob")
    as_np = FS.fused_filter_sample(x, np.full(rows, top_k, np.float32),
                                   pp.cpu().numpy(), 7, gumbel_noise=noise)
    check(all(torch.equal(a, b) for a, b in zip(as_np, got)),
          f"{label} K2 with hetero's numpy per-row vectors differs from tensors")
    kept = torch.isfinite(FS.fused_filter_plain(x, kk, pp))
    for seed in (11, 12, 13):
        nxt, _, _ = FS.fused_filter_sample(x, top_k, pp, seed)
        check(bool(kept[torch.arange(rows, device="cuda"), nxt.long()].all()),
              f"{label} K2 [{rows}, {vocab}] with Philox sampled a filtered token")
    cluster = FS.cluster_size(rows, vocab)

    def k2():
        return FS.fused_filter_sample(x, top_k, grid, 5, want_alt_prob=False)

    ms = device_ms(torch, k2, kernel="sampler_kernel")
    wall_ms = time_ms(torch, k2)
    plain_ms = device_ms(torch, lambda: FS.sampler_plain(x, kk, grid, 5, do_topk=True,
                                                         do_topp=True, want_alt_prob=False), 5)
    bound_ms, bound_by = sampler_bound(rows, vocab, prologue=False, topk=True)
    what = "the grid's top-p per row" if top_p is None else f"top-p {top_p:.4f} on every row"
    say(f"{label} K2 [{rows}, {vocab}] (top-k {top_k:g}, {what}, after a 1.3 "
        f"repetition penalty), cluster of {cluster} blocks per row: next/alt exact with injected "
        f"noise, alt_prob max abs err {err:.3e} (rtol {SAMPLER_RTOL}), numpy per-row vectors "
        f"taken unchanged, Philox inside the kept set (top-p moved to mid-gap: nearest cumulative "
        f"mass {gap:.2e} relative away); device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, "
        f"bound {bound_ms:.4f} ({bound_by}); wrapper wall {wall_ms:.4f}")
    return dict(shape=[rows, vocab], top_k=top_k, top_p=top_p, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                cluster=cluster, wall_ms=wall_ms)


def blip_text_cut(text, n_layer: int):
    """The first n_layer blocks of a BlipText with its embeddings and head,
    sharing the model's tensors (nothing is copied)."""
    import dataclasses

    from torch import nn

    cut = copy.copy(text)
    cut._modules = dict(text._modules)  # the copy's own module table
    cut.blocks = nn.ModuleList(list(text.blocks)[:n_layer])
    cut.cfg = dataclasses.replace(text.cfg, num_layers=n_layer)
    return cut


def check_genb_cut(torch, cut, feats, tok) -> dict:
    """(m2a) The card's BLIP text decoder against the port on the CPU, on
    its first GENB_CUT layers at full width (the same f32 tensors) over
    the card's image features: prefill logits (every position) and the
    first step's logits within CARD_VS_CPU; then GENB_NOISE_STEPS steps of
    the engine's sampled step (engine.sample_step: the raw eos logprob,
    min-length suppression, the 1.3 penalty, top-k 2500, the grid's top-p;
    K2 on the card, the plain threshold path on the CPU) with the same
    injected noise, both fed the CPU's tokens: a card token may differ from
    the CPU's only where the CPU's top-2 gap of the filtered, perturbed
    logits lies below 2 x CARD_VS_CPU's atol. Returns the errors, the
    CPU's smallest gap and the flips."""
    from clipcap_tpu_torch.cli.synthesis import default_grids
    from clipcap_tpu_torch.decode import engine as E
    from clipcap_tpu_torch.models.blip_text import decoder_lm
    from clipcap_tpu_torch.ops import sampling as S
    from clipcap_tpu_torch.ops.kernels import fused_sampler as FS

    rows, n = GENB_CANDIDATES, GENB_NOISE_STEPS
    top_p, min_len, _ = default_grids(n=rows)
    ids = tok.encode("a picture of ")
    prompt = torch.tensor([[tok.bos_token_id] + ids[1:-1]] * rows, device="cuda")
    settings = E.GenerationSettings(max_new_tokens=n, top_k=2500.0, top_p=top_p,
                                    repetition_penalty=1.3, eos_token_id=GENB_EOS,
                                    min_length=min_len)
    cpu = copy.deepcopy(cut).cpu()
    sides = {"card": (cut, feats, "cuda"), "cpu": (cpu, feats.cpu(), "cpu")}
    gen = torch.Generator().manual_seed(44)
    noise = [S.gumbel_like(torch.zeros(rows, GENB_VOCAB), gen) for _ in range(n)]
    state, errs, gaps, flips = {}, {}, [], 0
    with torch.no_grad():
        for side, (text, img, dev) in sides.items():
            lm = decoder_lm(text, img, torch.ones(img.shape[:-1], dtype=torch.int32, device=dev),
                            repeat=rows)
            p = prompt.to(dev)
            logits, cache = lm.prefill(p, lm.init_cache(rows, p.shape[1] + n + 1),
                                       full_logits=True)
            hist = torch.zeros(rows, p.shape[1] + n, dtype=torch.int64, device=dev)
            hist[:, :p.shape[1]] = p
            valid = torch.zeros(hist.shape, dtype=torch.bool, device=dev)
            valid[:, :p.shape[1]] = True
            state[side] = dict(lm=lm, cache=cache, logits=logits, hist=hist, valid=valid,
                               rows=[S.per_row(v, rows, dev) for v in (2500.0, top_p, 0.0)],
                               min_len=S.per_row(min_len, rows, dev, torch.int64),
                               rand=E.StepRandomness(0, dev))
        errs["prefill"] = assert_close(torch, state["card"]["logits"].cpu(),
                                       state["cpu"]["logits"], *CARD_VS_CPU,
                                       "(m2a) prefill logits card vs CPU")
        p_len = prompt.shape[1]
        for step in range(n):
            nxt = {}
            for side, st in state.items():
                last = st["logits"][:, -1].float()
                if step == 1:
                    st["first_step"] = last
                nxt[side], _, _, _ = E.sample_step(
                    settings, last, *st["rows"], st["rand"], use_fused_step=False, counter=step,
                    min_len=st["min_len"], hist=st["hist"], hist_valid=st["valid"],
                    gumbel_noise=noise[step].to(last.device))
            cs = state["cpu"]
            x = cs["logits"][:, -1].float().clone()
            x[:, GENB_EOS] = torch.where(step < cs["min_len"], float("-inf"), x[:, GENB_EOS])
            x = S.repetition_penalty(x, cs["hist"], 1.3, tokens_valid=cs["valid"])
            kk = FS.resolve_top_k(2500.0, rows, GENB_VOCAB, "cpu")
            y = FS.fused_filter_plain(x, kk, cs["rows"][1]) + noise[step]
            top2 = y.topk(2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            gaps.append(float(gap.min()))
            differ = nxt["card"].cpu() != nxt["cpu"]
            flips += int(differ.sum())
            check(bool((gap[differ] < 2 * CARD_VS_CPU[0]).all()),
                  f"(m2a) a sampled token differs from the CPU's at step {step}, where the "
                  f"CPU's gap is {float(gap[differ].min()) if differ.any() else 0:.4g}")
            for side, st in state.items():
                tok_in = nxt["cpu"].to(st["hist"].device)
                st["hist"][:, p_len + step] = tok_in
                st["valid"][:, p_len + step] = True
                st["logits"], st["cache"] = st["lm"].decode_step(tok_in[:, None], st["cache"])
                st["logits"] = st["logits"][:, None]
        errs["first_step"] = assert_close(torch, state["card"]["first_step"].cpu(),
                                          state["cpu"]["first_step"], *CARD_VS_CPU,
                                          "(m2a) first step logits card vs CPU")
    del cpu, state
    return dict(errs=errs, min_cpu_gap=min(gaps), flips=flips)


def _rank_scores(torch, engine, image, captions, mode):
    """Every caption's score under `mode` (the two-stage mode: its top 3)."""
    from clipcap_tpu_torch.cli.synthesis import ranker_preprocess

    if "+" in mode:
        return engine.rank(image, captions, mode, top_n=3)
    if mode.startswith("CLIP"):
        name = "ViT-L/14" if mode == "CLIP-ViT-L" else "RN50x64"
        px = torch.from_numpy(ranker_preprocess(engine, name, image))[None]
        return list(zip(captions, engine.clip_rankers[name].rank(px, captions)))
    px = torch.from_numpy(ranker_preprocess(engine, "blip", image))[None]
    return list(zip(captions, engine.blip_ranker.rank(px, captions, mode=mode.lower())))


def check_ranking_vs_cpu(torch, card_scores: dict, cpu_scores: dict) -> dict:
    """(m4) Each single-stage mode's scores of every caption on the card
    within RANK_ATOL of the CPU's, and their order equal to the CPU's
    wherever two of the CPU's scores lie further apart than twice the
    largest error; the two-stage mode's top 3 equal to two_stage_rank over
    the card's own ViT-L/14 and RN50x64 scores, each within RANK_ATOL of
    the CPU's RN50x64 score of that caption."""
    import numpy as np

    from clipcap_tpu_torch.rank.cascade import two_stage_rank

    out = {}
    for mode, card in card_scores.items():
        if "+" in mode:
            table = {m: dict(card_scores[m]) for m in ("CLIP-ViT-L", "CLIP-RN50x64")}
            want = two_stage_rank([c for c, _ in card_scores["CLIP-ViT-L"]],
                                  lambda cs: [table["CLIP-ViT-L"][c] for c in cs],
                                  lambda cs: [table["CLIP-RN50x64"][c] for c in cs], 5, 3)
            check([c for c, _ in card] == [c for c, _ in want],
                  f"(m4) {mode}: the card's top 3 is not the cascade of its own scores")
            cpu = dict(cpu_scores["CLIP-RN50x64"])
        else:
            cpu = dict(cpu_scores[mode])
        caps = [c for c, _ in card]
        a = np.array([s for _, s in card])
        b = np.array([cpu[c] for c in caps])
        err = float(np.abs(a - b).max())
        check(bool(np.isfinite(a).all()) and err <= RANK_ATOL,
              f"(m4) {mode}: scores card vs CPU max abs err {err:.3e} > {RANK_ATOL}")
        if "+" not in mode:
            order_a, order_b = np.argsort(-a, kind="stable"), np.argsort(-b, kind="stable")
            for i in np.nonzero(order_a != order_b)[0]:
                check(abs(b[order_a[i]] - b[order_b[i]]) <= 2 * err,
                      f"(m4) {mode}: the order differs from the CPU's at rank {i} beyond a "
                      f"near-tie")
        out[mode] = err
    return out


def genb_path(torch, counters, FA, FS, S, card: str, work: Path) -> tuple:
    """Phase (m): Gen-B caption synthesis at full width through the
    entry points `cli.caption_me` drives. Writes seeded weights in their
    published layouts: a BLIP captioner in HF BlipForConditionalGeneration's
    (ViT-L/16 at 384 px; the text decoder at bert-base width, 12 layers,
    vocabulary 30524, cross-attending the ViT's 1024), a BLIP retrieval
    model in HF BlipForImageTextRetrieval's (ViT-B/16 at 384 px, the text
    encoder, the ITM and ITC heads), OpenAI-layout CLIP ViT-L/14 and
    RN50x64 (448 px) state dicts in fp16, a 30524-line vocab.txt and a
    JPEG; loads them through cli.loading. (m1) K1 at the encoders' shapes
    and K2 at [40, 30524] against their plain versions; (m2a) the text
    decoder's cut against the CPU; (m2) SynthesisEngine.synthesize of 40
    candidates with the default grids in f32 and (m4) SynthesisEngine.rank
    in all five modes, with the launch counters set to 0 just before the
    synthesis and read after the ranking; the rankers' scores against the
    port on the CPU; (m3) enable_int8_decode: q and s equal the CPU's, the
    int8 logits near f32's, an int8 synthesis; (m5) `python -m
    clipcap_tpu_torch.cli.caption_me` from the files on disk. Returns the
    launches, the rates and the handles phase (n) goes on from: the
    files' folder, the f32 decoder, the encoder, the tokenizer and the
    retrieval model."""
    import math

    import numpy as np
    from PIL import Image

    from clipcap_tpu_torch import convert
    from clipcap_tpu_torch.cli.loading import (load_blip_captioner, load_clip_ranker,
                                               load_state_dict)
    from clipcap_tpu_torch.cli.synthesis import SynthesisEngine, default_grids
    from clipcap_tpu_torch.core.config import BlipTextConfig, ViTConfig
    from clipcap_tpu_torch.data.preprocessing import blip_preprocess
    from clipcap_tpu_torch.decode import hetero
    from clipcap_tpu_torch.models.blip_retrieval import BlipRetrieval
    from clipcap_tpu_torch.models.blip_text import decoder_lm, quantize_params
    from clipcap_tpu_torch.models.clip_resnet import ResNetConfig
    from clipcap_tpu_torch.rank.rankers import BLIPRanker, CLIPRanker
    from clipcap_tpu_torch.tools.import_weights import blip_retrieval_from_hf_state_dict

    t_phase = time.perf_counter()
    rates = {}
    # (m1) the kernels at the slice's shapes; comparisons, not counted on the path
    rates["k1_shapes"] = check_attention_preprocess(torch, FA, K1_GENB_SHAPES,
                                                    "phase (m)'s encoders")
    rates["k2"] = check_sampler_genb(torch, FS, S)

    # (m0) the weights, in their published layouts, on disk
    t0 = time.perf_counter()
    root = work / "genb"
    root.mkdir(parents=True, exist_ok=True)
    vit_l = ViTConfig.blip_variant("ViT-L")
    text_cfg = BlipTextConfig(encoder_width=vit_l.width)
    vit_b = ViTConfig.blip_variant("ViT-B")
    ret_text = BlipTextConfig(encoder_width=vit_b.width)
    w = _draw(torch, 51, torch.float32)
    torch.save({**blip_vision_hf(w, "vision_model.", vit_l),
                **bert_hf(w, "text_decoder.", text_cfg, lm_head=True)}, root / "blip.pth")
    w = _draw(torch, 52, torch.float32)
    torch.save({**blip_vision_hf(w, "vision_model.", vit_b),
                **bert_hf(w, "text_encoder.", ret_text, lm_head=False),
                "vision_proj.weight": w(ret_text.embed_dim, vit_b.width),
                "vision_proj.bias": w(ret_text.embed_dim),
                "text_proj.weight": w(ret_text.embed_dim, ret_text.hidden_size),
                "text_proj.bias": w(ret_text.embed_dim),
                "itm_head.weight": w(2, ret_text.hidden_size), "itm_head.bias": w(2)},
               root / "blip_retrieval.pth")
    torch.save(clip_openai_state_dict(torch, ViTConfig.clip_variant("ViT-L/14"), 53, L14_TEXT,
                                      torch.float16), root / "vit_l14.pt")
    torch.save(clip_resnet_openai_state_dict(torch, ResNetConfig.variant("RN50x64"), 54),
               root / "rn50x64.pt")
    write_bert_vocab(root / "vocab.txt")
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in CLIP_MERGES) + "\n")
    write_jpegs(root / "img", 1, 55)
    image_path = root / "img" / "img000.jpg"
    sizes = {f.name: f.stat().st_size / 1e9 for f in root.glob("*.p*")}
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    blip_params, vit_cfg, blip_text_cfg, tok = load_blip_captioner(
        str(root / "blip.pth"), str(root / "vocab.txt"), device="cuda")
    rankers = {name: load_clip_ranker(name, str(root / f), str(root / "merges.txt"),
                                      device="cuda")
               for name, f in (("ViT-L/14", "vit_l14.pt"), ("RN50x64", "rn50x64.pt"))}
    retrieval = convert.load(BlipRetrieval(vit_b, ret_text, device="cuda"),
                             blip_retrieval_from_hf_state_dict(
                                 load_state_dict(str(root / "blip_retrieval.pth")), vit_b,
                                 ret_text))
    engine = SynthesisEngine(blip_params, vit_cfg, blip_text_cfg, tok, clip_rankers=rankers,
                             blip_ranker=BLIPRanker(retrieval, vit_b, ret_text, tok))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    text = blip_params["text"]
    check(tok.vocab_size == GENB_VOCAB and tok.bos_token_id == 30522
          and tok.sep_token_id == GENB_EOS and tok.enc_token_id == 30523,
          "(m0) the WordPiece tokenizer's special ids")
    n_params = {k: sum(p.numel() for p in m.parameters()) / 1e6
                for k, m in (("blip_vit_l", blip_params["visual"]), ("blip_text", text),
                             ("retrieval", retrieval),
                             ("clip_vit_l14", rankers["ViT-L/14"].visual),
                             ("rn50x64", rankers["RN50x64"].visual))}
    say(f"(m0) weights written in {write_s:.1f} s ({', '.join(f'{k} {v:.2f} GB' for k, v in sizes.items())}) "
        f"and loaded onto the card through cli.loading in {load_s:.1f} s; M params: "
        + ", ".join(f"{k} {v:.1f}" for k, v in n_params.items())
        + f"; RN50x64 config from the checkpoint {rankers['RN50x64'].vit_cfg}")
    rates["weights_write_s"], rates["weights_load_s"] = write_s, load_s

    image = Image.open(image_path).convert("RGB")
    pixels = torch.from_numpy(blip_preprocess(image, vit_cfg.image_size))[None]
    feats = engine.encode_image(pixels)
    check(tuple(feats.shape) == (1, vit_cfg.seq_len, vit_cfg.width)
          and bool(torch.isfinite(feats).all()), f"(m2) BLIP ViT-L features {tuple(feats.shape)}")

    # (m2a) the text decoder's 2-layer cut against the CPU
    t0 = time.perf_counter()
    cut = check_genb_cut(torch, blip_text_cut(text, GENB_CUT), feats, tok)
    say(f"(m2a) the text decoder's {GENB_CUT}-layer cut at full width card vs CPU (f32): prefill "
        f"{cut['errs']['prefill']:.3e}, first step {cut['errs']['first_step']:.3e} (bound "
        f"{CARD_VS_CPU[0]}); {GENB_NOISE_STEPS} sampled steps with injected noise: {cut['flips']} "
        f"tokens differ from the CPU's (the CPU's smallest top-2 gap {cut['min_cpu_gap']:.3e}) "
        f"({time.perf_counter() - t0:.1f} s)")
    rates["cut"] = cut

    # (m2) synthesis and (m4) ranking: the counted run, after one warm-up
    top_p, min_len, max_len = default_grids(n=GENB_CANDIDATES)
    steps = int(max_len.max()) + 1
    engine.synthesize(pixels, sample_count=GENB_CANDIDATES, seed=1)
    for mode in GENB_MODES:
        _rank_scores(torch, engine, image, ["a picture of a cat"], mode)
    torch.cuda.synchronize()
    counters(reset=True)
    t0 = time.perf_counter()
    captions, params, stats = engine.synthesize(pixels, sample_count=GENB_CANDIDATES, seed=42)
    torch.cuda.synchronize()
    synth_ms = (time.perf_counter() - t0) * 1e3
    after_synth = counters()
    card_scores, rank_ms = {}, {}
    for mode in GENB_MODES:
        t3 = time.perf_counter()
        card_scores[mode] = _rank_scores(torch, engine, image, captions, mode)
        torch.cuda.synchronize()
        rank_ms[mode] = (time.perf_counter() - t3) * 1e3
    launches = counters()
    # the encode alone, after the counted run: the rest of a synthesis is the decode loop
    encode_ms = time_ms(torch, lambda: engine.encode_image(pixels), 5)
    decode_ms = synth_ms - encode_ms
    enc = engine.encode_image(pixels)
    k1_want = vit_cfg.layers + 2 * rankers["ViT-L/14"].vit_cfg.layers + 2 * vit_b.layers
    check(after_synth["fused_attention"] == vit_cfg.layers
          and after_synth["fused_filter_sample"] == steps,
          f"(m2) synthesis launched K1 {after_synth['fused_attention']} (want {vit_cfg.layers}) "
          f"and K2 {after_synth['fused_filter_sample']} times (want {steps}, one a step)")
    check(launches["fused_attention"] == k1_want
          and launches["fused_filter_sample"] == steps and launches["fused_step_sample"] == 0,
          f"(m) launches {launches}: want K1 {k1_want}, K2 {steps}, K3 0")
    check(len(captions) == len(params) == len(stats) and len(captions) >= 2
          and all(isinstance(c, str) and c for c in captions)
          and all(np.isfinite(s["eos_prob"]).all() and len(s["tokens"]) <= steps
                  for s in stats), f"(m2) {len(captions)} candidates malformed")
    say(f"(m2) SynthesisEngine.synthesize of {GENB_CANDIDATES} candidates for one image (f32, "
        f"default grids, top-k 2500, force-eos 0.9, {steps} steps): {len(captions)} distinct; "
        f"{synth_ms:.1f} ms an image: the encode {encode_ms:.1f} ms (alone, CUDA events), the "
        f"decode loop {decode_ms:.1f} ms; K1 {after_synth['fused_attention']}, K2 {after_synth['fused_filter_sample']} "
        f"launches (cluster {FS.cluster_size(GENB_CANDIDATES, GENB_VOCAB)}); first: "
        f"{captions[0][:60]!r}")
    say(f"(m4) ranking the {len(captions)} candidates on the card, ms a mode: "
        + ", ".join(f"{m} {v:.1f}" for m, v in rank_ms.items())
        + f"; launches on the path (synthesis + ranking): {launches}")
    prof = per_step_profile(torch, "(m2) synthesis, f32", lambda n: hetero.sample(
        enc, text, tok, sample_count=GENB_CANDIDATES, top_p=top_p, top_k=2500,
        min_len=np.minimum(min_len, n - 1), max_len=np.full(GENB_CANDIDATES, n - 1),
        force_eos_log_prob=math.log(0.9), seed=42), 11, steps)
    rates["synthesis_f32"] = dict(candidates=len(captions), steps=steps, encode_ms=encode_ms,
                                  decode_ms=decode_ms, ms_per_image=synth_ms,
                                  k1=after_synth["fused_attention"],
                                  k2=after_synth["fused_filter_sample"], **prof)
    figure_line(card, "genb_synthesis_f32", rates["synthesis_f32"])

    # (m4) the rankers against the port on the CPU
    t0 = time.perf_counter()
    cpu_engine = SynthesisEngine(
        {}, vit_cfg, blip_text_cfg, tok,
        clip_rankers={n: CLIPRanker(copy.deepcopy(r.visual).cpu(), copy.deepcopy(r.text).cpu(),
                                    r.tokenizer) for n, r in rankers.items()},
        blip_ranker=BLIPRanker(copy.deepcopy(retrieval).cpu(), vit_b, ret_text, tok))
    cpu_scores = {mode: _rank_scores(torch, cpu_engine, image, captions, mode)
                  for mode in GENB_MODES}
    rank_err = check_ranking_vs_cpu(torch, card_scores, cpu_scores)
    del cpu_engine
    say(f"(m4) every mode's scores within {RANK_ATOL} of the CPU's and in its order (near-ties "
        f"aside); max abs err " + ", ".join(f"{m} {e:.2e}" for m, e in rank_err.items())
        + f"; top of CLIP-ViT-L+RN50x64: {card_scores['CLIP-ViT-L+RN50x64'][0][0][:60]!r} "
        f"({time.perf_counter() - t0:.1f} s)")
    rates["rank_ms"], rates["rank_max_abs_err"] = rank_ms, rank_err
    figure_line(card, "genb_rank_ms", rank_ms)

    # (m3) the int8 decoder
    t0 = time.perf_counter()
    q_cpu = quantize_params(copy.deepcopy(text).cpu()).state_dict()
    engine.enable_int8_decode()
    q8 = engine.blip_params["text"]
    for name, t in q8.state_dict().items():
        check(t.dtype == q_cpu[name].dtype and torch.equal(t.cpu(), q_cpu[name]),
              f"(m3) int8 {name} differs from the CPU's quantization")
    del q_cpu
    ids = tok.encode("a picture of ")
    prompt = torch.tensor([[tok.bos_token_id] + ids[1:-1]] * GENB_CANDIDATES, device="cuda")
    with torch.no_grad():
        logits = {}
        for key, mod in (("f32", text), ("int8", q8)):
            lm = decoder_lm(mod, enc, repeat=GENB_CANDIDATES)
            logits[key], _ = lm.prefill(prompt, lm.init_cache(GENB_CANDIDATES, prompt.shape[1]),
                                        full_logits=True)
    scale = float(logits["f32"].abs().max())
    err8 = max_abs(logits["int8"], logits["f32"])
    check(bool(torch.isfinite(logits["int8"]).all()) and err8 <= int8_bound(scale),
          f"(m3) int8 prefill logits vs f32: max abs err {err8:.4g} > {int8_bound(scale):.4g}")
    engine.synthesize(pixels, sample_count=GENB_CANDIDATES, seed=1)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    caps8, _, _ = engine.synthesize(pixels, sample_count=GENB_CANDIDATES, seed=42)
    torch.cuda.synchronize()
    synth8_ms = (time.perf_counter() - t1) * 1e3
    prof8 = per_step_profile(torch, "(m3) synthesis, int8", lambda n: hetero.sample(
        enc, q8, tok, sample_count=GENB_CANDIDATES, top_p=top_p, top_k=2500,
        min_len=np.minimum(min_len, n - 1), max_len=np.full(GENB_CANDIDATES, n - 1),
        force_eos_log_prob=math.log(0.9), seed=42), 11, steps)
    say(f"(m3) int8 decoder: every q and s equal the CPU's quantization; prefill logits "
        f"{err8:.4g} from f32's (bound {int8_bound(scale):.4g}: {INT8_LOGIT_STEPS} bf16 steps of "
        f"max|logit| {scale:.3f}); int8 synthesis {len(caps8)} distinct, {synth8_ms:.1f} ms an "
        f"image, the decode loop {synth8_ms - encode_ms:.1f} ms ({time.perf_counter() - t0:.1f} s)")
    rates["synthesis_int8"] = dict(candidates=len(caps8), steps=steps, encode_ms=encode_ms,
                                   decode_ms=synth8_ms - encode_ms, ms_per_image=synth8_ms,
                                   logits_max_abs_err=err8, logits_scale=scale, **prof8)
    figure_line(card, "genb_synthesis_int8", rates["synthesis_int8"])
    # phase (n) goes on from the f32 decoder, the retrieval model and the files
    handles = dict(root=root, text=text, visual=blip_params["visual"], vit_cfg=vit_cfg, tok=tok,
                   retrieval=retrieval, ret_text=ret_text, image_path=image_path)
    del engine, blip_params, text, q8, rankers, retrieval, feats, enc, logits
    torch.cuda.empty_cache()

    # (m5) the CLI end to end from the files on disk
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "clipcap_tpu_torch.cli.caption_me", str(image_path),
         "--blip_checkpoint", str(root / "blip.pth"), "--blip_vocab", str(root / "vocab.txt"),
         "--clip_vit_l_checkpoint", str(root / "vit_l14.pt"), "--clip_merges",
         str(root / "merges.txt"), "--mode", "CLIP-ViT-L"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and len(lines) >= 4 and "distinct candidates; top 3:" in lines[-4]
          and all(x.startswith(f"{i:02d} [") for i, x in enumerate(lines[-3:])),
          f"(m5) caption_me exited {out.returncode}: {out.stdout[-500:]} {out.stderr[-2000:]}")
    say(f"(m5) python -m clipcap_tpu_torch.cli.caption_me --mode CLIP-ViT-L from the files on "
        f"disk: exit 0 in {cli_s:.1f} s; " + " | ".join(x[:80] for x in lines[-4:]))
    rates["cli_s"] = cli_s
    say(f"Gen-B phase (m): {time.perf_counter() - t_phase:.1f} s")
    return launches, rates, handles


# --- 14. the rest of Gen B: BLIP served, BLIP beam, the sweep, human eval, Gumbel -------

GENB_SLOTS, GENB_REQUESTS, GENB_IMAGES, GENB_SYNC = 64, 128, 16, 8
GENB_SOLO = 8  # greedy requests held against their solo decoder_lm runs on the card
GENB_TOP_K, GENB_TOP_P, GENB_PENALTY, GENB_MIN_LEN = 2500.0, 0.5, 1.3, 5
GENB_BEAM_IMAGES, GENB_BEAM, GENB_BEAM_NEW = 8, 3, 30
GENB_OP_STEPS = 2  # ring steps whose device time is split by op and shape
SWEEP_TRIALS, SWEEP_N, SWEEP_IMAGES, HUMAN_EVAL_N = 2, 4, 8, 4
GUMBEL_LEN, GUMBEL_STEPS, GUMBEL_LR = 12, 50, 0.1


def check_sampler_genb_serving(torch, FS, S) -> dict:
    """(n1) K3 and K2 at BLIP serving's step shape, [64, 30524]: seeded
    logits, top-k 2500 and top-p 0.5 (each row's moved to mid-gap, as
    check_sampler does), K3's prologue with a 1.3 penalty over a 24-token
    history, the min-length eos gate on half the rows and eos = [SEP],
    injected noise: next and alt exact, alt_prob and eos_lp within
    SAMPLER_RTOL of the plain version, Philox inside the kept set; then the
    device times of each kernel at serving's flags (scalar top-k and top-p,
    no alt_prob), the plain version and the bound, and the cluster size."""
    rows, vocab, eos = GENB_SLOTS, GENB_VOCAB, GENB_EOS
    FS._check_vocab(vocab)
    gen = torch.Generator(device="cuda").manual_seed(61)
    x = torch.randn(rows, vocab, generator=gen, device="cuda") * 3
    hist = torch.randint(0, vocab, (rows, 24), generator=gen, device="cuda")
    appears = S.token_occurrence_mask(hist, vocab)
    suppress = torch.arange(rows, device="cuda") % 2 == 0
    noise = S.gumbel_like(x, gen)
    kk = FS.resolve_top_k(GENB_TOP_K, rows, vocab, "cuda")
    p = torch.full((rows,), GENB_TOP_P, device="cuda")
    pp3, gap3 = mid_gap_top_p(torch, FS, prologue_plain(torch, x, appears, suppress,
                                                        GENB_PENALTY, 1.0, eos), kk, p)
    pp2, gap2 = mid_gap_top_p(torch, FS, x, kk, p)
    step = dict(appears=appears, penalty=GENB_PENALTY, temperature=1.0, eos_token_id=eos,
                suppress_eos=suppress, want_eos_lp=True)
    plain_step = dict(appears=appears.view(torch.int8), penalty=GENB_PENALTY, temperature=1.0,
                      eos_token_id=eos, suppress_eos=suppress.float(), want_eos_lp=True)
    got = FS.fused_step_sample(x, GENB_TOP_K, pp3, 9, gumbel_noise=noise, **step)
    want = FS.sampler_plain(x, kk, pp3, 9, do_topk=True, do_topp=True, want_alt_prob=True,
                            gumbel_noise=noise, **plain_step)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"(n1) K3 [{rows}, {vocab}]: next or alt differs from the plain version")
    err3 = max(assert_close(torch, got[2], want[2], 1e-7, SAMPLER_RTOL, "(n1) K3 alt_prob"),
               assert_close(torch, got[3], want[3], 1e-6, SAMPLER_RTOL, "(n1) K3 eos_lp"))
    got = FS.fused_filter_sample(x, GENB_TOP_K, pp2, 7, gumbel_noise=noise)
    want = FS.sampler_plain(x, kk, pp2, 7, do_topk=True, do_topp=True, want_alt_prob=True,
                            gumbel_noise=noise)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"(n1) K2 [{rows}, {vocab}]: next or alt differs from the plain version")
    err2 = assert_close(torch, got[2], want[2], 1e-7, SAMPLER_RTOL, "(n1) K2 alt_prob")
    kept = torch.isfinite(FS.fused_filter_plain(x, kk, pp2))
    for seed in (11, 12):
        nxt, _, _ = FS.fused_filter_sample(x, GENB_TOP_K, pp2, seed)
        check(bool(kept[torch.arange(rows, device="cuda"), nxt.long()].all()),
              f"(n1) K2 [{rows}, {vocab}] with Philox sampled a filtered token")
    cluster = FS.cluster_size(rows, vocab)
    timed = {
        "fused_step_sample": (
            lambda: FS.fused_step_sample(x, GENB_TOP_K, GENB_TOP_P, 5, want_alt_prob=False,
                                         **step),
            lambda: FS.sampler_plain(x, kk, p, 5, do_topk=True, do_topp=True,
                                     want_alt_prob=False, **plain_step), True, err3),
        "fused_filter_sample": (
            lambda: FS.fused_filter_sample(x, GENB_TOP_K, GENB_TOP_P, 5, want_alt_prob=False),
            lambda: FS.sampler_plain(x, kk, p, 5, do_topk=True, do_topp=True,
                                     want_alt_prob=False), False, err2)}
    out = {}
    for name, (fn, plain, prologue, err) in timed.items():
        ms = device_ms(torch, fn, kernel="sampler_kernel")
        wall_ms = time_ms(torch, fn)
        plain_ms = device_ms(torch, plain, 5)
        bound_ms, bound_by = sampler_bound(rows, vocab, prologue=prologue, topk=True)
        out[name] = dict(shape=[rows, vocab], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None, cluster=cluster,
                         wall_ms=wall_ms)
    k3, k2 = out["fused_step_sample"], out["fused_filter_sample"]
    say(f"(n1) K3 and K2 [{rows}, {vocab}] (top-k {GENB_TOP_K:g}, top-p {GENB_TOP_P}; K3's "
        f"penalty {GENB_PENALTY}, min-length gate on half the rows, eos [SEP]), cluster of "
        f"{cluster} blocks per row: next/alt exact with injected noise, alt_prob/eos_lp max abs "
        f"err K3 {err3:.3e}, K2 {err2:.3e} (rtol {SAMPLER_RTOL}), Philox inside the kept set "
        f"(top-p moved to mid-gap: nearest cumulative mass {min(gap2, gap3):.2e} relative away); "
        f"device ms: K3 {k3['ms']:.4f} (plain {k3['plain_ms']:.4f}, bound {k3['bound_ms']:.4f} "
        f"{k3['bound_by']}), K2 {k2['ms']:.4f} (plain {k2['plain_ms']:.4f}, bound "
        f"{k2['bound_ms']:.4f} {k2['bound_by']}); wrapper wall K3 {k3['wall_ms']:.4f}, K2 "
        f"{k2['wall_ms']:.4f}")
    return out


def check_blip_ring_cut(torch, cut, feats, prompt_ids) -> float:
    """(n2) The decoder's GENB_CUT-layer cut behind serving_decoder_lm on
    the card against the port on the CPU (f32, the same tensors): four
    requests prefilled into a ring of prompt + 6 + 1 positions, ring steps
    at per-row positions, a one-row refill at slot 2 and steps until the
    global index has wrapped the ring, every step's logits within
    CARD_VS_CPU. Returns the largest error."""
    from clipcap_tpu_torch.models.blip_text import serving_decoder_lm

    tv, p = feats.shape[1], len(prompt_ids)
    ring = p + 6 + 1
    cpu = copy.deepcopy(cut).cpu()
    sides = {"card": (serving_decoder_lm(cut, prompt_ids, tv, device="cuda"), "cuda"),
             "cpu": (serving_decoder_lm(cpu, prompt_ids, tv, device="cpu"), "cpu")}
    state = {}
    with torch.no_grad():
        for side, (lm, dev) in sides.items():
            logits, cache = lm.prefill(feats[:4].to(dev), lm.init_cache(4, ring))
            state[side] = [lm, cache, logits[:, -1], dev]
        worst = assert_close(torch, state["card"][2].cpu(), state["cpu"][2], *CARD_VS_CPU,
                             "(n2) ring cut prefill logits card vs CPU")
        pos, start = torch.full((4,), p), torch.zeros(4, dtype=torch.int64)
        ids = torch.randint(0, GENB_VOCAB, (12, 4), generator=torch.Generator().manual_seed(62))
        for step in range(12):
            if step == 3:
                for lm, cache, _, dev in state.values():
                    _, small = lm.prefill(feats[4:5].to(dev), lm.init_cache(1, p))
                    lm.scatter_refill(cache, small, 2)
                pos[2], start[2] = p, state["cpu"][1].index - p
            for st in state.values():
                lm, cache, _, dev = st
                st[2], st[1] = lm.decode_step_ring(ids[step][:, None].to(dev), cache,
                                                   pos.to(dev), start.to(dev))
            worst = max(worst, assert_close(torch, state["card"][2].cpu(), state["cpu"][2],
                                            *CARD_VS_CPU, f"(n2) ring cut step {step} card vs CPU"))
            pos += 1
        check(state["cpu"][1].index > ring, "(n2) the ring cut's index did not wrap the ring")
    del cpu, state
    return worst


def genb_serving_path(torch, counters, card: str, handles: dict) -> tuple:
    """(n2) the BLIP captioner behind ServingEngine (serving_decoder_lm,
    token-id mode) at full width: 128 requests from a pool of 16 images'
    ViT-L/16 features (encoded on the card, K1 at [16, 577, 16, 64]),
    per-request caps from the default grid's (20-45), 64 slots, 8 steps a
    sync: greedy, top-k 2500 / top-p 0.5 "fused" (K2) and "fused_step" (K3)
    with Gen B's knobs (penalty 1.3, min length 5, force-eos 0.9). The
    launch counters are set to 0 before the encode and read after the three
    serves. Checks: every request answered within its cap; K2 or K3 once a
    dispatched step; the first 8 greedy requests against their solo
    decoder_lm + generate runs on the card (near-tie flips by (e1)'s gap
    rule); a "fused_step" serve of 64 requests on 64 slots (no refill)
    against generate(seed) with "fused_step", token for token; the ring
    step of the 2-layer cut against the CPU. (n3) beam search of 8 images x
    beam 3 x 30 tokens through decoder_lm, the best beams of the cut against
    the CPU's."""
    import dataclasses
    import math

    import numpy as np

    from clipcap_tpu_torch.cli.synthesis import default_grids
    from clipcap_tpu_torch.data.preprocessing import normalize_on_device
    from clipcap_tpu_torch.decode.beam import beam_search_batched
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.decode.serving import Request, ServingEngine
    from clipcap_tpu_torch.models.blip_text import decoder_lm, serving_decoder_lm

    text, visual, vit_cfg, tok = (handles[k] for k in ("text", "visual", "vit_cfg", "tok"))
    ids = tok.encode("a picture of ")
    prompt_ids = [tok.bos_token_id] + ids[1:-1]  # hetero.sample's prompt
    tv = vit_cfg.seq_len
    gen = torch.Generator(device="cuda").manual_seed(63)
    pixels = normalize_on_device(torch.rand(GENB_IMAGES, 3, vit_cfg.image_size,
                                            vit_cfg.image_size, generator=gen, device="cuda"))
    caps = default_grids(n=GENB_REQUESTS)[2].astype(int).tolist()
    n_new = max(caps) + 1
    reqs = [Request(i, i % GENB_IMAGES, max_length=c) for i, c in enumerate(caps)]
    base = GenerationSettings(max_new_tokens=n_new, eos_token_id=GENB_EOS)
    sampled = dict(top_k=GENB_TOP_K, top_p=GENB_TOP_P)
    runs = {"n2a": ("greedy", dataclasses.replace(base, greedy=True), None),
            "n2b": (f'top-k {GENB_TOP_K:g}, top-p {GENB_TOP_P}, "fused"',
                    dataclasses.replace(base, **sampled), "fused_filter_sample"),
            "n2c": (f'top-k {GENB_TOP_K:g}, top-p {GENB_TOP_P}, "fused_step", penalty '
                    f'{GENB_PENALTY}, min length {GENB_MIN_LEN}, force-eos 0.9',
                    dataclasses.replace(base, **sampled, repetition_penalty=GENB_PENALTY,
                                        min_length=GENB_MIN_LEN,
                                        force_eos_log_prob=math.log(0.9),
                                        filter_method="fused_step"), "fused_step_sample")}
    lm = serving_decoder_lm(text, prompt_ids, tv, device="cuda")
    engines = {name: ServingEngine(lm, text.cfg, prefix_len=tv, prompt_len=len(prompt_ids),
                                   settings=s, slots=GENB_SLOTS, steps_per_sync=GENB_SYNC,
                                   pipeline_depth=2, device="cuda").warmup()
               for name, (_, s, _) in runs.items()}
    with torch.no_grad():
        visual(pixels[:2], output="tokens")  # the encoder's warm-up, at another batch
    torch.cuda.synchronize()

    counters(reset=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        pool = visual(pixels, output="tokens")
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    k1_encode = counters()["fused_attention"]
    served = {}
    for name in runs:
        before = counters()
        t0 = time.perf_counter()
        res = engines[name].serve(reqs, seed=7, prefix_pool=pool)
        wall = time.perf_counter() - t0
        after = counters()
        served[name] = (res, wall, {k: after[k] - before[k] for k in after},
                        engines[name].last_stats)
    launches = counters()
    check(tuple(pool.shape) == (GENB_IMAGES, tv, vit_cfg.width) and k1_encode == vit_cfg.layers,
          f"(n2) encode: features {tuple(pool.shape)}, K1 {k1_encode} launches (want "
          f"{vit_cfg.layers})")

    rates = {"encode_ms": encode_ms}
    for name, (desc, settings, kernel) in runs.items():
        res, wall, rise, stats = served[name]
        check(sorted(res) == list(range(GENB_REQUESTS)), f"({name}) not every request answered")
        for i, r in res.items():
            check(0 < len(r["tokens"]) <= caps[i] and r["length"] == len(r["tokens"])
                  and all(0 <= t < GENB_VOCAB for t in r["tokens"]),
                  f"({name}) request {i}: {len(r['tokens'])} tokens, cap {caps[i]}")
        for k in ("fused_filter_sample", "fused_step_sample"):
            want = stats["steps"] if k == kernel else 0
            check(rise[k] == want, f"({name}) {k} launched {rise[k]} times over "
                  f"{stats['steps']} dispatched steps, want {want}")
        lat = np.asarray([r["latency_s"] for r in res.values()])
        rates[name] = dict(captions_per_s=GENB_REQUESTS / wall, wall_s=wall,
                           p50_s=float(np.percentile(lat, 50)),
                           p99_s=float(np.percentile(lat, 99)), occupancy=stats["occupancy"],
                           steps=stats["steps"], refills=sum(stats["refills"].values()),
                           ms_per_step=wall * 1e3 / stats["steps"])
        say(f"({name}) serve {GENB_REQUESTS} BLIP requests ({desc}; caps {min(caps)}-{max(caps)}, "
            f"prompt of {len(prompt_ids)} ids, {tv} image tokens), {GENB_SLOTS} slots, "
            f"steps_per_sync {GENB_SYNC}, pipeline_depth 2: {rates[name]['captions_per_s']:.2f} "
            f"captions/s; latency_s p50 {rates[name]['p50_s']:.4f}, p99 "
            f"{rates[name]['p99_s']:.4f}; occupancy {stats['occupancy']}; {stats['steps']} "
            f"steps ({rates[name]['ms_per_step']:.2f} ms a step); {rates[name]['refills']} "
            f"refills; host: chunk dispatch {stats['dispatch_s']:.3f} s, refill dispatch "
            f"{stats['refill_dispatch_s']:.3f} s, harvest wait {stats['harvest_wait_s']:.3f} s; "
            f"K2 +{rise['fused_filter_sample']}, K3 +{rise['fused_step_sample']}")
    check(all(GENB_EOS not in r["tokens"][:GENB_MIN_LEN] for r in served["n2c"][0].values()),
          "(n2c) eos emitted before min length")

    # the first greedy requests against their solo runs on the card
    t0 = time.perf_counter()
    flips = 0
    greedy = runs["n2a"][1]
    prompt = torch.tensor([prompt_ids], device="cuda")
    for i in range(GENB_SOLO):
        solo = decoder_lm(text, pool[i % GENB_IMAGES: i % GENB_IMAGES + 1])
        ref = generate(solo, prompt, dataclasses.replace(greedy, max_length=caps[i]),
                       device="cuda")
        want = ref["tokens"][0, : int(ref["lengths"][0])].tolist()
        got = served["n2a"][0][i]["tokens"]
        if got != want:
            s = first_difference(got, want)
            _, gaps = greedy_with_gaps(torch, solo, prompt, n_new)
            gap = float(gaps[0, s])
            check(gap < FLIP_GAP, f"(n2a) request {i} differs from its solo run at step {s} "
                  f"where the solo top-2 gap is {gap:.3e} (>= {FLIP_GAP})")
            flips += 1
    # no refill: 64 requests on 64 slots against generate(seed) with "fused_step"
    first = reqs[:GENB_SLOTS]
    got = engines["n2c"].serve(first, seed=11, prefix_pool=pool)
    check(not engines["n2c"].last_stats["refills"], "(n2c) the 64-request serve refilled")
    rows = torch.tensor([r.prefix_embeds for r in first], device="cuda")
    ref = generate(decoder_lm(text, pool[rows]),
                   torch.tensor([prompt_ids] * GENB_SLOTS, device="cuda"),
                   dataclasses.replace(runs["n2c"][1],
                                       max_length=np.asarray(caps[:GENB_SLOTS], np.int64)),
                   seed=11, device="cuda")
    lengths = ref["lengths"].tolist()
    differ = [i for i in range(GENB_SLOTS)
              if got[i]["tokens"] != ref["tokens"][i, : lengths[i]].tolist()
              or got[i]["stopped"] != bool(ref["stopped"][i])]
    check(not differ, f"(n2c) the no-refill serve differs from generate(seed) with "
          f"\"fused_step\" for requests {differ[:8]}")
    cut_err = check_blip_ring_cut(torch, blip_text_cut(text, GENB_CUT), pool, prompt_ids)
    say(f"(n2) checks: the first {GENB_SOLO} greedy requests equal their solo decoder_lm runs "
        f"(near-tie flips: {flips}); {GENB_SLOTS} requests on {GENB_SLOTS} slots with "
        f"\"fused_step\" equal generate(seed) token for token; K2/K3 once a dispatched step; "
        f"the {GENB_CUT}-layer cut's ring steps (a refill, a wrap) within {cut_err:.3e} of the "
        f"CPU (bound {CARD_VS_CPU[0]}); no eos before min length "
        f"({time.perf_counter() - t0:.1f} s)")
    prof = profile_call(torch, "(n2c)", lambda: engines["n2c"].serve(reqs, seed=7,
                                                                     prefix_pool=pool),
                        served["n2c"][1] * 1e3)
    steps = served["n2c"][3]["steps"]
    rates["n2c"].update(device_ms_per_step=prof["busy_ms"] / steps,
                        launches_per_step=prof["launches"] / steps,
                        busy_share=prof["busy_ms"] / prof["wall_ms"])
    # which host ops own a step's device time: ring steps of the 64 slots
    # through the adapter alone, with their input shapes
    ring = lm.init_cache(GENB_SLOTS, len(prompt_ids) + n_new + 1)
    _, ring = lm.prefill(pool[torch.arange(GENB_SLOTS, device="cuda") % GENB_IMAGES], ring)
    step_ids = torch.zeros(GENB_SLOTS, 1, dtype=torch.int64, device="cuda")
    step_pos = torch.full((GENB_SLOTS,), len(prompt_ids), dtype=torch.int64, device="cuda")
    step_start = torch.zeros(GENB_SLOTS, dtype=torch.int64, device="cuda")
    lm.decode_step_ring(step_ids, ring, step_pos, step_start)  # warm-up
    rates["n2c"]["ring_step_ops"] = op_shape_profile(
        torch, f"(n2c) {GENB_OP_STEPS} ring steps of the {GENB_SLOTS} slots (the adapter alone)",
        lambda: [lm.decode_step_ring(step_ids, ring, step_pos, step_start)
                 for _ in range(GENB_OP_STEPS)], GENB_OP_STEPS)
    del ring
    rates["greedy_flips"], rates["ring_cut_max_abs_err"] = flips, cut_err
    for name in runs:
        figure_line(card, f"genb_serving_{name}", rates[name])
    del engines

    # (n3) beam search through decoder_lm: 8 images x beam 3 x 30 tokens
    t0 = time.perf_counter()
    prompt = torch.tensor([prompt_ids] * GENB_BEAM_IMAGES, device="cuda")
    feats = pool[:GENB_BEAM_IMAGES]

    def beam(n):
        return beam_search_batched(decoder_lm(text, feats), prompt, beam_size=GENB_BEAM,
                                   max_new_tokens=n, stop_token_id=GENB_EOS, device="cuda")

    beam(GENB_BEAM_NEW)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = beam(GENB_BEAM_NEW)
    torch.cuda.synchronize()
    beam_ms = (time.perf_counter() - t1) * 1e3
    check(bool(torch.isfinite(out["scores"]).all())
          and tuple(out["tokens"].shape) == (GENB_BEAM_IMAGES, GENB_BEAM, GENB_BEAM_NEW),
          f"(n3) beam result {tuple(out['tokens'].shape)} malformed")
    prof = per_step_profile(torch, "(n3) BLIP beam", beam, 11, GENB_BEAM_NEW)
    # the 2-layer cut's best beams against the CPU's, up to the CPU's selection gap
    cut = blip_text_cut(text, GENB_CUT)
    card_out, card_sel, _ = traced_beam(torch, decoder_lm(cut, feats[:2]), prompt[:2], "cuda",
                                        GENB_EOS, GENB_BEAM, GENB_BEAM_NEW)
    cpu_cut = copy.deepcopy(cut).cpu()
    cpu_out, cpu_sel, cpu_gaps = traced_beam(torch, decoder_lm(cpu_cut, feats[:2].cpu()),
                                             prompt[:2].cpu(), "cpu", GENB_EOS, GENB_BEAM,
                                             GENB_BEAM_NEW)
    beam_flips = 0
    for i in range(2):
        b_card, b_cpu = int(card_out["scores"][i].argmax()), int(cpu_out["scores"][i].argmax())
        a = card_out["tokens"][i, b_card, : int(card_out["seq_lengths"][i, b_card])].tolist()
        b = cpu_out["tokens"][i, b_cpu, : int(cpu_out["seq_lengths"][i, b_cpu])].tolist()
        if a == b:
            continue
        steps_diff = [s for s, (u, v) in enumerate(zip(card_sel, cpu_sel))
                      if not torch.equal(u[i].cpu(), v[i])]
        top2 = cpu_out["scores"][i].topk(2).values
        gap = float(cpu_gaps[i, steps_diff[0]]) if steps_diff else float(top2[0] - top2[1])
        check(gap < FLIP_GAP, f"(n3) beam image {i}: the cut's best beam differs from the CPU's "
              f"where the CPU's gap is {gap:.3e} (>= {FLIP_GAP})")
        beam_flips += 1
    del cpu_cut
    rates["beam"] = dict(images=GENB_BEAM_IMAGES, beam=GENB_BEAM, new_tokens=GENB_BEAM_NEW,
                         ms=beam_ms, cut_flips=beam_flips, **prof)
    say(f"(n3) BLIP beam search {GENB_BEAM_IMAGES} images x beam {GENB_BEAM} x {GENB_BEAM_NEW} "
        f"tokens through decoder_lm: {beam_ms:.1f} ms a call; device "
        f"{prof['device_ms_per_step']:.3f} ms and {prof['launches_per_step']:.0f} launches a "
        f"step, busy {prof['busy_share']:.3f}; the {GENB_CUT}-layer cut's best beams of images "
        f"0-1 equal the CPU's (near-tie flips {beam_flips}; smallest CPU selection gap "
        f"{float(cpu_gaps.min()):.3e}) ({time.perf_counter() - t0:.1f} s)")
    figure_line(card, "genb_beam", rates["beam"])
    return launches, rates


def genb_apps_path(torch, counters, card: str, work: Path, handles: dict) -> tuple:
    """(n4) the sweep CLI, cli.sweep.main (what `python -m
    clipcap_tpu_torch.cli.sweep` runs) from (m)'s files on disk: 2 trials
    of 4 images from a seeded COCO folder of 8 JPEGs with 5 captions each,
    over configs/sweep_bayes_01.yaml's space with its `mode` pinned to
    CLIP-ViT-L (the CLI builds its BLIP ranker on the captioner, as JAX's
    does, so a trial in ITC mode raises KeyError there; the CPU tests pin
    that); (n5) cli.human_eval.main with n=4 and --mode CLIP-ViT-L, and the
    multi-filter packet through prepare_human_eval on the CLI's engine with
    (m)'s retrieval model as its BLIP ranker (main's --multi_filter raises
    KeyError at the ITM stage, as JAX's does); (n6) Gumbel caption
    optimization on (m)'s retrieval model: one step against the CPU, then
    50 steps of a 12-token caption. The launch counters are set to 0 just
    before (n4) and read after (n6)."""
    import csv
    import dataclasses
    import importlib.util

    import numpy as np
    import yaml
    from PIL import Image

    from clipcap_tpu_torch.cli import human_eval, sweep
    from clipcap_tpu_torch.cli.synthesis import build_engine
    from clipcap_tpu_torch.data.preprocessing import blip_preprocess
    from clipcap_tpu_torch.models.blip_retrieval import encode_image
    from clipcap_tpu_torch.ops import sampling as S
    from clipcap_tpu_torch.rank.rankers import BLIPRanker
    from clipcap_tpu_torch.tools import gumbel_caption_opt as G

    root, tok = handles["root"], handles["tok"]
    coco = work / "genb_coco"
    write_coco(coco, SWEEP_IMAGES, 64)
    files = ["--valid_json_path", str(coco / "captions.json"), "--image_folder_path",
             str(coco / "images"), "--blip_checkpoint", str(root / "blip.pth"), "--blip_vocab",
             str(root / "vocab.txt"), "--clip_vit_l_checkpoint", str(root / "vit_l14.pt"),
             "--clip_merges", str(root / "merges.txt")]
    space = yaml.safe_load((ROOT / "configs" / "sweep_bayes_01.yaml").read_text())
    space["parameters"]["mode"] = {"values": ["CLIP-ViT-L"]}
    sweep_yaml = work / "sweep_bayes_01_clip_l.yaml"
    sweep_yaml.write_text(yaml.safe_dump(space, sort_keys=False))
    rates = {}
    counters(reset=True)

    # (n4) the sweep CLI from the files on disk
    t0 = time.perf_counter()
    results = sweep.main(files + ["--sweep_yaml", str(sweep_yaml), "--trials",
                                  str(SWEEP_TRIALS), "--n", str(SWEEP_N)])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    after_sweep = counters()
    trials = [dict(trial, **scores) for trial, scores in results]
    metrics = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr")
    check(len(trials) == SWEEP_TRIALS
          and all(np.isfinite(t[m]) for t in trials for m in metrics),
          f"(n4) the sweep returned {trials}")
    check(after_sweep["fused_attention"] > 0 and after_sweep["fused_filter_sample"] > 0,
          f"(n4) the sweep launched K1 {after_sweep['fused_attention']} and K2 "
          f"{after_sweep['fused_filter_sample']} times")
    say(f"(n4) cli.sweep.main --sweep_yaml sweep_bayes_01.yaml's space (mode pinned to "
        f"CLIP-ViT-L) --trials {SWEEP_TRIALS} --n {SWEEP_N} from the files on disk: "
        f"{sweep_s:.1f} s; "
        + " | ".join(f"{t['mode']} batch {t['batch_size']} top-k {t['top_k']} top-p "
                     f"{t['top_p']:.4f} min_len {t['min_len']}: Bleu_4 {t['Bleu_4']:.4f} "
                     f"CIDEr {t['CIDEr']:.4f}" for t in trials)
        + f"; K1 {after_sweep['fused_attention']}, K2 {after_sweep['fused_filter_sample']} "
        f"launches")
    rates["sweep"] = dict(seconds=sweep_s, trials=trials, k1=after_sweep["fused_attention"],
                          k2=after_sweep["fused_filter_sample"])

    # (n5) human-eval preparation: main's plain packet, and the multi-filter
    # packet on main's engine with the retrieval model as its BLIP ranker
    t0 = time.perf_counter()
    has_plots = importlib.util.find_spec("matplotlib") is not None
    n = HUMAN_EVAL_N
    for multi in (False, True):
        out = work / f"human_eval_{'multi' if multi else 'plain'}"
        argv = files + ["--n", str(n), "--mode", "CLIP-ViT-L", "--output_folder", str(out)]
        if not multi and has_plots:
            recs = human_eval.main(argv)
        else:  # main always plots, and its BLIP ranker cannot rank by ITM
            args = human_eval.build_argparser().parse_args(argv)
            engine = build_engine(args)
            if multi:
                retrieval = handles["retrieval"]
                engine = dataclasses.replace(engine, blip_ranker=BLIPRanker(
                    retrieval, retrieval.vit_cfg, handles["ret_text"], tok))
            recs = human_eval.prepare_human_eval(
                engine, args.valid_json_path, args.image_folder_path, args.output_folder, n=n,
                mode=args.mode, multi_filter=multi, make_plots=False)
            del engine
        check(len(recs) == n, f"(n5) {len(recs)} records, want {n}")
        if multi:
            check(all(r["synth_captions"] and np.isfinite(r["synth_captions_scores_itc"]).all()
                      for r in recs), "(n5) multi-filter records malformed")
            continue
        with open(out / "eval.csv", newline="") as f:
            eval_rows = list(csv.reader(f))
        with open(out / "gt.csv", newline="") as f:
            gt_rows = list(csv.reader(f))
        check(len(eval_rows) == n + 1 and len(gt_rows) == n + 1
              and sum(r[2] == "True" for r in gt_rows[1:]) == n // 2,
              f"(n5) eval.csv {len(eval_rows)} rows, gt.csv {len(gt_rows)} rows")
        plots = sorted(p.name for p in out.glob("score_*"))
        check(len(plots) == (4 if has_plots else 0), f"(n5) plots {plots}")
    human_s = time.perf_counter() - t0
    say(f"(n5) human-eval preparation n={n} --mode CLIP-ViT-L: the plain packet and the "
        f"multi-filter one (prepare_human_eval on the CLI's engine, ranked by the retrieval "
        f"model): {human_s:.1f} s; eval.csv and gt.csv {n} rows each, blinded split {n // 2}; "
        + ("matplotlib installed: cli.human_eval.main prepared the plain packet and plotted "
           "the scores" if has_plots else
           "matplotlib is NOT installed on this machine: the plain packet was prepared by "
           "prepare_human_eval(..., make_plots=False), not by main"))
    rates["human_eval"] = dict(seconds=human_s, matplotlib=has_plots)

    # (n6) Gumbel caption optimization on (m)'s retrieval model
    t0 = time.perf_counter()
    retrieval, ret_text = handles["retrieval"], handles["ret_text"]
    image = Image.open(handles["image_path"]).convert("RGB")
    px = torch.from_numpy(blip_preprocess(image, retrieval.vit_cfg.image_size))[None].to("cuda")
    img = encode_image(retrieval, px)
    gen = torch.Generator().manual_seed(71)
    init = 0.01 * torch.randn(1, GUMBEL_LEN, ret_text.vocab_size, generator=gen)
    noise = S.gumbel_like(init, gen)
    cpu = copy.deepcopy(retrieval).cpu()
    step = {}
    for side, (model, dev) in (("card", (retrieval, "cuda")), ("cpu", (cpu, "cpu"))):
        opt = G.AdamW(lambda count: GUMBEL_LR, 0.0, ["logits"])
        logits = init.clone().to(dev)
        state = opt.init([logits])
        itc, grad, _ = G.gumbel_step(model, G.image_feature(model, img.to(dev)), logits, opt,
                                     state, noise.to(dev), 1.0, tok.cls_token_id,
                                     tok.sep_token_id)
        step[side] = (itc.cpu(), grad.cpu(), logits.cpu())
    del cpu
    errs = {}
    for i, what in enumerate(("itc", "gradient", "logits after Adam")):
        a, b = step["card"][i], step["cpu"][i]
        scale = max(float(b.abs().max()), 1e-30)
        errs[what] = assert_close(torch, a, b, CARD_VS_CPU[0] * scale, CARD_VS_CPU[1],
                                  f"(n6) one Gumbel step's {what} card vs CPU") / scale
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = G.optimize_caption(retrieval, ret_text, img, tok, caption_length=GUMBEL_LEN,
                             steps=GUMBEL_STEPS, lr=GUMBEL_LR, seed=3, log_every=0,
                             device="cuda")
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t1) * 1e3 / GUMBEL_STEPS
    check(bool(np.isfinite(res["itc"])) and len(res["tokens"]) == GUMBEL_LEN,
          f"(n6) optimize_caption gave {res}")
    say(f"(n6) Gumbel caption optimization on the BLIP retrieval model (ViT-B/16 at 384 px, "
        f"the text encoder, vocabulary {ret_text.vocab_size}): one step card vs CPU, max abs err "
        f"over the CPU's largest value: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (bound {CARD_VS_CPU[0]}); {GUMBEL_STEPS} steps of a {GUMBEL_LEN}-token caption: "
        f"{ms_step:.2f} ms a step (wall), final ITC {res['itc']:.4f}, caption "
        f"{res['caption'][:60]!r} ({time.perf_counter() - t0:.1f} s)")
    rates["gumbel"] = dict(ms_per_step=ms_step, steps=GUMBEL_STEPS, itc=res["itc"],
                           step_rel_err=errs)
    launches = counters()
    figure_line(card, "genb_apps", {"sweep_s": sweep_s, "human_eval_s": human_s,
                                    "gumbel_ms_per_step": ms_step})
    return launches, rates


def genb_rest_path(torch, counters, FA, FS, S, card: str, work: Path, handles: dict) -> tuple:
    """Phase (n): the rest of Gen B on (m)'s weights, vocabulary and
    modules: (n1) K3 and K2 at [64, 30524] against their plain versions,
    and K1 at the shape of (n2)'s pool encode; (n2)-(n3) BLIP served and
    beam-searched; (n4)-(n6) the sweep, human eval and Gumbel optimization,
    then K2 against its plain version at each sweep trial's batch size,
    top-k and top-p. Returns the launches of the serving path and of the
    apps' path, and the rates."""
    t_phase = time.perf_counter()
    k = check_sampler_genb_serving(torch, FS, S)
    vit_cfg = handles["vit_cfg"]
    k1_shapes = check_attention_preprocess(
        torch, FA, [(GENB_IMAGES, vit_cfg.seq_len, vit_cfg.heads, vit_cfg.width // vit_cfg.heads)],
        "(n2)'s pool encode")
    serving_launches, rates = genb_serving_path(torch, counters, card, handles)
    torch.cuda.empty_cache()
    apps_launches, app_rates = genb_apps_path(torch, counters, card, work, handles)
    rates.update(app_rates, k2=k["fused_filter_sample"], k3=k["fused_step_sample"],
                 k1_shapes=k1_shapes)
    rates["k2_sweep"] = [check_sampler_genb(torch, FS, S, rows=t["batch_size"], top_k=t["top_k"],
                                            top_p=t["top_p"], label="(n4)")
                         for t in app_rates["sweep"]["trials"]]
    shutil.rmtree(handles["root"], ignore_errors=True)
    say(f"Gen-B phase (n): {time.perf_counter() - t_phase:.1f} s")
    return serving_launches, apps_launches, rates


# --- 15. parallelism on torch.distributed (phase (o)) ---------------------------------
#
# The smoke needs one card and NCCL takes one rank per GPU, so every
# parallel path runs at world size 1 under NCCL: the code runs on CUDA
# tensors, its collectives sit on the step (NCCL issues them even for one
# rank), and each path reproduces the unsharded path. Multi-rank correctness
# is the CPU tests' (gloo, 2 and 4 processes); no multi-GPU figure is taken.

PAR_STEPS = 75  # the no-beam sweep's steps: (o1)'s greedy and sampled 72-row decodes
PAR_TP_STEPS = 24  # (o4)'s GPT-J decode
SP_BATCH, MOE_BATCH, PP_BATCH = 16, 64, 16


def parallel_profile(torch, label: str, run, steps: int) -> tuple:
    """Device ms and kernel launches per step of one profiled call of `run`
    (`steps` decode steps), and the NCCL kernels among them (count and
    device ms per step): the collectives' cost on the card. `steps` may
    be a function read after the call. Returns them and what `run`
    returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clipcap_tpu_torch.core.mesh import COLLECTIVES

    torch.cuda.synchronize()
    issued = dict(COLLECTIVES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    steps = steps() if callable(steps) else steps
    issued = sum(COLLECTIVES[k] - issued[k] for k in issued)
    busy = launches = nccl_ms = nccl = 0
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            busy += e.duration_ns() / 1e6
            launches += 1
            by_name[e.name()] = by_name.get(e.name(), 0) + 1
            if "nccl" in e.name().lower():
                nccl += 1
                nccl_ms += e.duration_ns() / 1e6
    check(launches > 0, f"profile {label}: the profiler recorded no CUDA kernel")
    out = dict(device_ms_per_step=busy / steps, launches_per_step=launches / steps,
               nccl_kernels_per_step=nccl / steps, nccl_ms_per_step=nccl_ms / steps,
               collectives_per_step=issued / steps, by_name=by_name)
    say(f"profile {label}, per step of {steps}: device {out['device_ms_per_step']:.4f} ms, "
        f"{out['launches_per_step']:.1f} kernel launches, NCCL kernels "
        f"{out['nccl_kernels_per_step']:.2f} ({out['nccl_ms_per_step']:.4f} ms), collectives "
        f"issued {out['collectives_per_step']:.2f}")
    return out, result


def launch_difference(label: str, plain: dict, par: dict) -> None:
    """Print the kernels whose launch counts differ between a plain and a
    parallel profile (parallel_profile's `by_name`, popped from both)."""
    a, b = plain.pop("by_name"), par.pop("by_name")
    diff = sorted(((b.get(k, 0) - a.get(k, 0), k) for k in set(a) | set(b)
                   if b.get(k, 0) != a.get(k, 0)), key=lambda d: -abs(d[0]))
    say(f"{label}: launches by kernel, parallel minus plain: "
        + ("; ".join(f"{n:+d} {k[:70]}" for n, k in diff[:8]) if diff else "none"))


def parallel_init(torch, work: Path) -> None:
    """NCCL at world size 1 through the port's init_distributed, a file://
    rendezvous in the phase's work directory; a failure fails the smoke."""
    from clipcap_tpu_torch.core.mesh import init_distributed

    rank, world = init_distributed("cuda", init_method=f"file://{work / 'nccl_rendezvous'}")
    backend = torch.distributed.get_backend()
    check((rank, world, backend) == (0, 1, "nccl"),
          f"(o) init_distributed gave rank {rank} of {world} on {backend}, want 0 of 1 on nccl")
    say(f"(o) NCCL process group: rank {rank} of {world}, backend {backend}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")


def parallel_dp_decode(torch, counters, bundle) -> tuple:
    """(o1) the main-path bundle after enable_data_parallel_decode(): the
    no-beam sweep of 8 images x 9 top-p (72 rows, 75 steps; K1 encodes, K2
    samples) and a greedy 72-row decode of 75 steps, token for token the
    plain bundle's. The launch counters are set to 0 before the parallel
    runs and read after."""
    import dataclasses

    from clipcap_tpu_torch.core.mesh import mesh_shape
    from clipcap_tpu_torch.data.preprocessing import normalize_on_device
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.eval.samplers import NoBeamCaptionSampler
    from clipcap_tpu_torch.models.bundle import CaptionerBundle

    t0 = time.perf_counter()
    dp = CaptionerBundle(bundle.model, bundle.cap_cfg, bundle.lm_cfg, bundle.tokenizer,
                         vit_cfg=bundle.vit_cfg, device="cuda")
    mesh = dp.enable_data_parallel_decode()
    gen = torch.Generator(device="cuda").manual_seed(61)
    pixels = normalize_on_device(torch.rand(8, 3, 224, 224, generator=gen, device="cuda"))
    sampler = NoBeamCaptionSampler(top_p_values=TOP_P_SWEEP, max_decode_length=PAR_STEPS,
                                   device="cuda")
    with torch.no_grad():
        prompt = bundle.prefix_from_pixels(pixels).repeat_interleave(len(TOP_P_SWEEP), dim=0)
    greedy = GenerationSettings(max_new_tokens=PAR_STEPS, greedy=True)

    def plain_greedy():
        return generate(bundle.lm, prompt, greedy, device="cuda")

    def dp_greedy():
        return generate(dp.lm_decode, prompt, greedy, device="cuda",
                        cache_constraint=dp.cache_constraint)

    # the checked runs are the profiled ones; a short DP decode first sets
    # up the data group's communicator
    generate(dp.lm_decode, prompt, dataclasses.replace(greedy, max_new_tokens=2),
             device="cuda", cache_constraint=dp.cache_constraint)
    prof = {}
    prof["plain_greedy"], want_g = parallel_profile(torch, "(o1) plain greedy 72 rows",
                                                    plain_greedy, PAR_STEPS)
    prof["plain_sweep"], want_s = parallel_profile(
        torch, "(o1) plain sweep", lambda: sampler.sample_batch(bundle, pixels), PAR_STEPS)
    counters(reset=True)
    prof["dp_greedy"], got_g = parallel_profile(torch, "(o1) DP greedy 72 rows", dp_greedy,
                                                PAR_STEPS)
    prof["dp_sweep"], got_s = parallel_profile(
        torch, "(o1) DP sweep", lambda: sampler.sample_batch(dp, pixels), PAR_STEPS)
    launches = counters()
    for key in ("tokens", "lengths", "stopped"):
        check(torch.equal(got_g[key], want_g[key]), f"(o1) DP greedy {key} differ from the plain")
    check(got_s == want_s, "(o1) the DP sweep's captions differ from the plain bundle's")
    check(launches["fused_filter_sample"] == PAR_STEPS and launches["fused_attention"] > 0,
          f"(o1) K2 launched {launches['fused_filter_sample']} times (want {PAR_STEPS}), K1 "
          f"{launches['fused_attention']}")
    launch_difference("(o1) greedy", prof["plain_greedy"], prof["dp_greedy"])
    launch_difference("(o1) sweep", prof["plain_sweep"], prof["dp_sweep"])
    say(f"(o1) DP decode on mesh {mesh_shape(mesh)}: greedy 72 x {PAR_STEPS} and the sweep "
        f"(8 images x 9 top-p, K2 x{launches['fused_filter_sample']}) token for token the plain "
        f"bundle's ({time.perf_counter() - t0:.1f} s)")
    return launches, prof


def parallel_int8(torch, counters, xl, pixels) -> tuple:
    """(o2) phase (i)'s GPT2-XL int8 LM through parallel/dp.py at world 1:
    the sweep's 72 rows, greedy and sampled (K2), 75 steps, token for token
    the unsharded decode's."""
    from clipcap_tpu_torch.core.mesh import MeshSpec, make_mesh
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.parallel.dp import dp_decode_shardings

    t0 = time.perf_counter()
    sh = dp_decode_shardings(make_mesh(MeshSpec(data=1), device_type="cuda"))
    with torch.no_grad():
        prompt = xl.prefix_from_pixels(pixels).repeat_interleave(len(TOP_P_SWEEP), dim=0)
    q8 = xl.lm_decode
    runs = {"greedy": GenerationSettings(max_new_tokens=PAR_STEPS, greedy=True),
            "sampled": GenerationSettings(max_new_tokens=PAR_STEPS,
                                          top_p=TOP_P_SWEEP * (prompt.shape[0] // 9))}
    want = {name: generate(q8, prompt, st, seed=3, device="cuda") for name, st in runs.items()}
    counters(reset=True)
    got = {name: generate(q8, prompt, st, seed=3, device="cuda",
                          cache_constraint=sh.constrain_cache) for name, st in runs.items()}
    launches = counters()
    for name in runs:
        check(torch.equal(got[name]["tokens"], want[name]["tokens"]),
              f"(o2) DP int8 {name} tokens differ from the unsharded decode")
    check(launches["fused_filter_sample"] == PAR_STEPS,
          f"(o2) K2 launched {launches['fused_filter_sample']} times, want {PAR_STEPS}")
    secs = time.perf_counter() - t0
    say(f"(o2) DP int8 GPT2-XL ({xl.lm_cfg.n_layer} layers) decode, {prompt.shape[0]} rows x "
        f"{PAR_STEPS} steps greedy and sampled: tokens equal ({secs:.1f} s)")
    return launches, dict(s=secs)


def parallel_serving(torch, counters, bundle) -> tuple:
    """(o3) 256 requests on 64 slots, "fused_step" (K3), through a bundle
    after enable_data_parallel_decode(): every request's tokens the plain
    serve's, one K3 launch per dispatched step."""
    import dataclasses

    import numpy as np

    from clipcap_tpu_torch.decode.engine import GenerationSettings
    from clipcap_tpu_torch.decode.serving import Request
    from clipcap_tpu_torch.models.bundle import CaptionerBundle

    t0 = time.perf_counter()
    dp = CaptionerBundle(bundle.model, bundle.cap_cfg, bundle.lm_cfg, bundle.tokenizer,
                         vit_cfg=bundle.vit_cfg, device="cuda")
    dp.enable_data_parallel_decode()
    gen = torch.Generator(device="cuda").manual_seed(5)
    pool = bundle.project_prefix(torch.randn(SERVE_REQUESTS, bundle.cap_cfg.mapper.dim_clip,
                                             generator=gen, device="cuda"))
    caps = np.random.default_rng(6).integers(8, 25, SERVE_REQUESTS).tolist()
    reqs = [Request(i, i, max_length=c) for i, c in enumerate(caps)]
    settings = dataclasses.replace(GenerationSettings(max_new_tokens=SERVE_NEW, eos_token_id=EOS),
                                   top_p=0.8, repetition_penalty=1.2, min_length=5,
                                   filter_method="fused_step")
    plain, par = (b.make_serving_engine(settings, slots=SERVE_SLOTS, steps_per_sync=SERVE_SYNC,
                                        pipeline_depth=2).warmup() for b in (bundle, dp))
    prof = {}
    prof["plain"], want = parallel_profile(torch, "(o3) plain serve", lambda: plain.serve(
        reqs, seed=7, prefix_pool=pool), lambda: plain.last_stats["steps"])
    counters(reset=True)
    prof["dp"], got = parallel_profile(torch, "(o3) DP serve", lambda: par.serve(
        reqs, seed=7, prefix_pool=pool), lambda: par.last_stats["steps"])
    launches = counters()
    steps = par.last_stats["steps"]
    check(sorted(got) == sorted(want) and all(got[i]["tokens"] == want[i]["tokens"]
                                              for i in want),
          "(o3) the DP serve's tokens differ from the plain serve's")
    check(launches["fused_step_sample"] == steps,
          f"(o3) K3 launched {launches['fused_step_sample']} times over {steps} steps")
    launch_difference("(o3)", prof["plain"], prof["dp"])
    say(f"(o3) DP serving, {SERVE_REQUESTS} requests on {SERVE_SLOTS} slots, \"fused_step\": "
        f"every request equals the plain serve's; {steps} steps, K3 x"
        f"{launches['fused_step_sample']} ({time.perf_counter() - t0:.1f} s)")
    return launches, prof


def parallel_tp(torch, counters, handles: dict) -> tuple:
    """(o4) phase (j)'s GPT-J-6B bf16 captioner after
    enable_tensor_parallel(1): prefill logits of the sweep's 72 rows bit for
    bit the untouched model's, and its greedy and sampled (K2 at [72, 50400])
    decodes token for token."""
    from clipcap_tpu_torch.core.mesh import mesh_shape
    from clipcap_tpu_torch.decode.engine import GenerationSettings, generate
    from clipcap_tpu_torch.models.bundle import CaptionerBundle

    t0 = time.perf_counter()
    model, prompt = handles["model"], handles["prompt"]
    lm = model.lm
    prompt = prompt[:8].repeat_interleave(len(TOP_P_SWEEP), dim=0)
    runs = {"greedy": GenerationSettings(max_new_tokens=PAR_TP_STEPS, greedy=True),
            "sampled": GenerationSettings(max_new_tokens=PAR_TP_STEPS,
                                          top_p=TOP_P_SWEEP * (prompt.shape[0] // 9))}

    def decode(m, name, constraint=None):
        return generate(m, prompt, runs[name], seed=9, device="cuda",
                        cache_constraint=constraint)["tokens"]

    with torch.no_grad():
        want_logits = lm.prefill(prompt, lm.init_cache(prompt.shape[0], prompt.shape[1]))[0]
    prof = {}
    prof["plain"], want_sampled = parallel_profile(
        torch, "(o4) plain GPT-J sampled 72 rows", lambda: decode(lm, "sampled"), PAR_TP_STEPS)
    want = {"greedy": decode(lm, "greedy"), "sampled": want_sampled}
    tp = CaptionerBundle(model, handles["cap_cfg"], handles["lm_cfg"], None,
                         vit_cfg=handles["vit_cfg"], device="cuda")
    mesh = tp.enable_tensor_parallel(1)
    check(lm.tp_group is not None and lm.blocks[0].n_head == handles["lm_cfg"].n_head,
          "(o4) the LM is not tensor-parallel over its 16 heads")
    counters(reset=True)
    with torch.no_grad():
        got_logits = lm.prefill(prompt, lm.init_cache(prompt.shape[0], prompt.shape[1]))[0]
    prof["tp"], got_sampled = parallel_profile(
        torch, "(o4) TP GPT-J sampled 72 rows",
        lambda: decode(tp.lm_decode, "sampled", tp.cache_constraint), PAR_TP_STEPS)
    got = {"greedy": decode(tp.lm_decode, "greedy", tp.cache_constraint), "sampled": got_sampled}
    launches = counters()
    check(torch.equal(got_logits, want_logits), "(o4) TP prefill logits are not the untouched "
          f"model's bit for bit (max abs err {max_abs(got_logits, want_logits):.3e})")
    for name in runs:
        check(torch.equal(got[name], want[name]), f"(o4) TP {name} tokens differ")
    check(launches["fused_filter_sample"] == PAR_TP_STEPS,
          f"(o4) K2 launched {launches['fused_filter_sample']} times, want {PAR_TP_STEPS}")
    launch_difference("(o4)", prof["plain"], prof["tp"])
    say(f"(o4) TP GPT-J-6B ({handles['lm_cfg'].n_layer} layers, bf16) on mesh "
        f"{mesh_shape(mesh)}: prefill logits [72, 1, 50400] bit for bit; greedy and sampled "
        f"72 x {PAR_TP_STEPS} token for token; K2 at [72, 50400] x"
        f"{launches['fused_filter_sample']} ({time.perf_counter() - t0:.1f} s)")
    return launches, prof


def parallel_zero_train(torch, work: Path, args: list, plain_losses: dict) -> dict:
    """(o5) `torchrun --nproc_per_node 1 -m clipcap_tpu_torch.cli.train
    --mesh_data 1 --zero_shard_params` on phase (h)'s shards, 3 steps: each
    step's loss (h)'s plain run's within RESUME_RTOL, and the checkpoint
    loads into the plain trainer."""
    from clipcap_tpu_torch.cli import train as train_cli
    from clipcap_tpu_torch.core.config import TrainConfig
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.train.checkpoints import restore_checkpoint
    from clipcap_tpu_torch.train.train_step import create_train_state

    t0 = time.perf_counter()
    out_dir = work / "train_zero"
    zero_args = args + ["--max_steps", "3", "--save_every_steps", "0", "--mesh_data", "1",
                        "--zero_shard_params", "--output_dir", str(out_dir)]
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "1", "-m", "clipcap_tpu_torch.cli.train"]
                         + zero_args, cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"(o5) torchrun cli.train --zero_shard_params exited "
          f"{run.returncode}: {run.stdout[-1500:]} {run.stderr[-3000:]}")
    losses, _ = train_metrics(out_dir)
    check(sorted(losses) == [1, 2, 3], f"(o5) logged steps {sorted(losses)}")
    diffs = {i: abs(losses[i] - plain_losses[i]) / abs(plain_losses[i]) for i in losses}
    check(max(diffs.values()) <= RESUME_RTOL,
          f"(o5) ZeRO losses {losses} against (h)'s {plain_losses}")
    cap_cfg, lm_cfg, kw = train_cli.build_configs(train_cli.build_argparser().parse_args(
        zero_args))
    template, _ = create_train_state(1, cap_cfg, lm_cfg, TrainConfig(total_steps=3, **kw),
                                     model=Captioner(cap_cfg, lm_cfg, device="cuda", seed=1),
                                     device="cuda")
    state = restore_checkpoint(str(out_dir / "demo_model_final"), template)
    check(int(state.step) == 3 and state.shards is None
          and all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
          "(o5) the ZeRO checkpoint does not load into the plain trainer at step 3")
    secs = time.perf_counter() - t0
    say(f"(o5) torchrun --nproc_per_node 1 cli.train --mesh_data 1 --zero_shard_params, 3 "
        f"steps on (h)'s shards: losses {[losses[i] for i in (1, 2, 3)]} against (h)'s "
        f"{[plain_losses[i] for i in (1, 2, 3)]} (max relative diff "
        f"{max(diffs.values()):.3e}); the checkpoint restores into the plain trainer at step 3 "
        f"({secs:.1f} s with the process's start)")
    return dict(losses=losses, max_rel_diff=max(diffs.values()), s=secs)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(
        min=1e-30))


def parallel_pp(torch) -> dict:
    """(o6) one GPT-2 124M captioner train step's loss and gradients through
    make_gpt2_pp_apply at pipe 1, 2 micro-batches, batch 16, against the
    plain step's, within 1e-5 relative (each gradient's max abs error over
    its max abs)."""
    import functools

    from clipcap_tpu_torch.core.config import CaptionerConfig, GPT2Config, MapperConfig, TrainConfig
    from clipcap_tpu_torch.core.mesh import MeshSpec, make_mesh
    from clipcap_tpu_torch.models.captioner import Captioner
    from clipcap_tpu_torch.parallel.pp import make_gpt2_pp_apply
    from clipcap_tpu_torch.train import train_step as TTS

    t0 = time.perf_counter()
    cap_cfg = CaptionerConfig(lm_type="gpt2", mapper=MapperConfig())
    lm_cfg = GPT2Config.variant("gpt2")
    train_cfg = TrainConfig(total_steps=10, bf16_compute=False, remat=False)
    model = Captioner(cap_cfg, lm_cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(71)
    tokens = torch.randint(1, lm_cfg.vocab_size, (PP_BATCH, 24), generator=gen, device="cuda")
    tokens[:, 18:] = -1
    batch = {"tokens": tokens, "prefix": torch.randn(PP_BATCH, cap_cfg.mapper.dim_clip,
                                                     generator=gen, device="cuda")}
    names = [n for n, keep in model.trainable_filter().items() if keep]
    mesh = make_mesh(MeshSpec(pipe=1), device_type="cuda")
    pp_apply = functools.partial(make_gpt2_pp_apply(lm_cfg, mesh, n_micro=2), model.lm)
    loss, grads, _ = TTS.compute_grads(model, batch, names, cap_cfg, train_cfg)
    pp_loss, pp_grads, _ = TTS.compute_grads(model, batch, names, cap_cfg, train_cfg,
                                             lm_apply=pp_apply)
    loss_err = abs(float(pp_loss) - float(loss)) / abs(float(loss))
    grad_err = max(_rel_err(g, w) for g, w in zip(pp_grads, grads))
    check(loss_err <= 1e-5 and grad_err <= 1e-5,
          f"(o6) the pipelined step's loss ({loss_err:.3e}) or gradients ({grad_err:.3e}) are "
          "not the plain step's within 1e-5 relative")
    secs = time.perf_counter() - t0
    say(f"(o6) GPT-2 124M captioner step through make_gpt2_pp_apply (pipe 1, 2 micro-batches, "
        f"batch {PP_BATCH}): loss {float(pp_loss):.6f} vs {float(loss):.6f} (relative "
        f"{loss_err:.3e}); worst gradient relative error {grad_err:.3e} over {len(names)} "
        f"tensors ({secs:.1f} s)")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err, s=secs)


def parallel_sp(torch, handles: dict) -> dict:
    """(o7) phase (m)'s BLIP ViT-L/16 at 384 px (T=577) in f32 through
    make_vit_sp_apply at model 1, batch 16, against ViT.forward, which runs
    K1: within 1e-4 relative."""
    import copy

    from clipcap_tpu_torch.core.mesh import MeshSpec, make_mesh
    from clipcap_tpu_torch.data.preprocessing import normalize_on_device
    from clipcap_tpu_torch.parallel.sp import make_vit_sp_apply

    t0 = time.perf_counter()
    vit = handles["visual"]
    vit = vit if vit.cls.dtype == torch.float32 else copy.deepcopy(vit).float()
    cfg = handles["vit_cfg"]
    gen = torch.Generator(device="cuda").manual_seed(73)
    pixels = normalize_on_device(torch.rand(SP_BATCH, 3, cfg.image_size, cfg.image_size,
                                            generator=gen, device="cuda"))
    apply = make_vit_sp_apply(cfg, make_mesh(MeshSpec(model=1), device_type="cuda"))
    with torch.no_grad():
        want = vit(pixels, output="tokens")
        got = apply(vit, pixels, output="tokens")
    err = _rel_err(got, want)
    check(tuple(got.shape) == (SP_BATCH, cfg.grid ** 2 + 1, cfg.width) and err <= 1e-4,
          f"(o7) the ring-attention ViT {tuple(got.shape)} is {err:.3e} relative from ViT.forward")
    secs = time.perf_counter() - t0
    say(f"(o7) BLIP ViT-L/16 at {cfg.image_size} px (T={cfg.grid ** 2 + 1}), batch {SP_BATCH}, "
        f"f32: make_vit_sp_apply at model 1 within {err:.3e} relative of ViT.forward (K1) "
        f"({secs:.1f} s)")
    return dict(rel_err=err, s=secs)


def parallel_ep(torch) -> dict:
    """(o8) the MoE mapper at MapperConfig's defaults (512 -> 768, 8 layers,
    8 heads), 8 experts, top-2, capacity 1.25, batch 64: output, aux loss and
    the gradients with the expert-parallel path at model 1 equal to
    moe.apply's within 1e-5 relative."""
    from clipcap_tpu_torch.core.config import MapperConfig
    from clipcap_tpu_torch.core.mesh import MeshSpec, make_mesh
    from clipcap_tpu_torch.models import moe
    from clipcap_tpu_torch.parallel.ep import expert_constraint

    t0 = time.perf_counter()
    cfg = MapperConfig()
    moe_cfg = moe.MoEConfig(n_experts=8, n_top=2, capacity_factor=1.25)
    mapper = moe.init(cfg, moe_cfg, device="cuda", seed=5)
    gen = torch.Generator(device="cuda").manual_seed(79)
    prefix = torch.randn(MOE_BATCH, cfg.dim_clip, generator=gen, device="cuda")
    ep = expert_constraint(make_mesh(MeshSpec(model=1), device_type="cuda"))

    def run(constraint):
        out, aux = moe.apply(mapper, prefix, expert_constraint=constraint)
        loss = out.square().sum() + moe_cfg.aux_loss_weight * aux
        return out.detach(), aux.detach(), torch.autograd.grad(loss, list(mapper.parameters()))

    want, got = run(None), run(ep)
    errs = dict(out=_rel_err(got[0], want[0]), aux=_rel_err(got[1], want[1]),
                grads=max(_rel_err(g, w) for g, w in zip(got[2], want[2]) if w.abs().max() > 0))
    check(max(errs.values()) <= 1e-5, f"(o8) the expert-parallel MoE mapper against moe.apply: "
          f"{errs}")
    secs = time.perf_counter() - t0
    say(f"(o8) MoE mapper (8 layers, 512 -> 768, 8 experts, top-2, capacity 1.25), batch "
        f"{MOE_BATCH}: the expert-parallel path at model 1 within {errs} relative of moe.apply, "
        f"forward and gradient ({secs:.1f} s)")
    return dict(rel_err=errs, s=secs)


def parallel_dryrun(torch) -> dict:
    """(o9) tools/dryrun_multichip's drive on the card in this process's
    NCCL group (world size 1; (o5) runs a torchrun process): its OK line,
    the 1-D mesh skipping pp, tp, sp and ep, as JAX's drive does."""
    from clipcap_tpu_torch.tools.dryrun_multichip import dryrun

    t0 = time.perf_counter()
    line = dryrun("cuda")
    check(line.startswith("dryrun_multichip OK") and "dp_int8_decode=ok, dp_serving=ok" in line,
          f"(o9) dryrun_multichip: {line}")
    secs = time.perf_counter() - t0
    say(f"(o9) {line} ({secs:.1f} s)")
    return dict(line=line, s=secs)


def profile_call(torch, label: str, run, wall_ms: float) -> dict:
    """Where the time of one call goes: the device time of each kernel
    (torch.profiler, CUPTI), summed, as a share of the wall time of the same
    profiled call, and beside `wall_ms`, the wall of an earlier unprofiled
    call of the same work (the profiler slows the host side). Raises if the
    profiler recorded no kernel. Returns the launches, the busy ms and the
    profiled call's wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the device's activity only: host-side events of a 100k-launch call
    # would take minutes to aggregate
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # summed by name from the raw kineto events: key_averages() takes ~0.2 ms
    # an event (minutes for a 500k-launch call), these a few us
    t_agg, by_name = time.perf_counter(), {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    kernels = sorted(((name, ms, n) for name, (ms, n) in by_name.items()), key=lambda e: -e[1])
    t_agg = time.perf_counter() - t_agg
    check(bool(kernels), f"profile {label}: the profiler recorded no CUDA kernel")
    busy_ms = sum(ms for _, ms, _ in kernels)
    launches = sum(n for _, _, n in kernels)
    top = "; ".join(f"{name[:40]} {ms:.2f} ms x{n}" for name, ms, n in kernels[:8])
    say(f"profile {label}: {launches} kernel launches, device busy {busy_ms:.1f} ms = "
        f"{100 * busy_ms / prof_wall_ms:.1f}% of this call's {prof_wall_ms:.1f} ms wall under "
        f"the profiler ({100 * busy_ms / wall_ms:.1f}% of the {wall_ms:.1f} ms wall of the "
        f"unprofiled call {label}); top: {top}; aggregated in {t_agg:.1f} s")
    return dict(launches=launches, busy_ms=busy_ms, wall_ms=prof_wall_ms)


def op_shape_profile(torch, label: str, run, per: int, top: int = 8) -> dict:
    """The host ops that own the most device time in one call, by op and
    input shapes (torch.profiler with record_shapes: a kernel's time goes
    to the op that launched it), in ms per `per` repeats of the work. For
    short calls: host events take ~0.2 ms each to aggregate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):
        got = getattr(e, "self_device_time_total", None)
        return got if got is not None else e.self_cuda_time_total

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    # the host ops only: the kernels' own rows would count their time twice
    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type == DeviceType.CPU and self_device_us(e) > 0),
                 key=lambda e: -self_device_us(e))
    check(bool(ops), f"op profile {label}: no op owned device time")
    total = sum(self_device_us(e) for e in ops) / 1e3 / per
    out = [dict(op=e.key, input_shapes=str(e.input_shapes), ms=self_device_us(e) / 1e3 / per,
                calls=e.count / per) for e in ops[:top]]
    say(f"op profile {label}: {total:.3f} device ms a repeat; top ops by device time: "
        + "; ".join(f"{o['op']} {o['input_shapes'][:120]} {o['ms']:.3f} ms x{o['calls']:g}"
                    for o in out))
    return dict(device_ms=total, top=out)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="drive the port's paths on one CUDA card")
    ap.add_argument("--t0_layers", type=int, default=T0_LAYERS, choices=range(2, 25),
                    metavar="N", help=f"T0-11B's depth in phase (k), of each stack's 24 "
                    f"layers (default {T0_LAYERS})")
    ap.add_argument("--gptj_layers", type=int, default=GPTJ_LAYERS, choices=range(2, 29),
                    metavar="N", help=f"GPT-J-6B's depth in phase (j), of its 28 layers "
                    f"(default {GPTJ_LAYERS})")
    ap.add_argument("--xl_layers", type=int, default=XL_LAYERS, choices=range(1, 49),
                    metavar="N", help=f"GPT2-XL's depth in phase (i), of its 48 layers "
                    f"(default {XL_LAYERS})")
    args = ap.parse_args()
    if not (ROOT / "clipcap_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no clipcap_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    say(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    from clipcap_tpu_torch.ops import sampling as S
    from clipcap_tpu_torch.ops.kernels import _build
    from clipcap_tpu_torch.ops.kernels import fused_attention as FA
    from clipcap_tpu_torch.ops.kernels import fused_sampler as FS

    t0 = time.perf_counter()
    logs = _build.build(["fused_attention", "fused_sampler"])
    say(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, both sources in parallel)")
    for name in ("fused_attention", "fused_sampler"):  # ptxas -v: registers, spills
        for line in logs.get(name, "").splitlines():
            if "ptxas" in line or "spill" in line:
                say(f"  {name}.cu {line.strip()}")

    def counters(reset: bool = False):
        if reset:
            for d in (FA.LAUNCHES, FS.LAUNCHES):
                for k in d:
                    d[k] = 0
        return {**FA.LAUNCHES, **FS.LAUNCHES}

    k1 = check_attention(torch, FA)
    k1["backward"] = check_attention_grad(torch, FA)
    k234, k4_launches = check_sampler(torch, FS, S)
    bundle = make_bundle(torch)
    t0 = time.perf_counter()
    main_launches, rates = main_path(torch, counters, bundle)
    say(f"main path phases (a)-(d) and profile: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_launches, serve_rates = serving_path(torch, counters, bundle)
    say(f"serving phase (e): {time.perf_counter() - t0:.1f} s")
    # (f) and (g) share the checkpoint, the CLIP state dict and the vocabulary
    work = ROOT / "build" / "smoke_infer"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    par, par_launches, par_s = {}, {}, {}  # phase (o): results, launches and seconds by part
    try:
        infer_launches, infer_rates, handles = infer_path(torch, counters, bundle, card, work)
        eval_launches, eval_rates = evaluate_path(torch, counters, card, work, handles,
                                                  rates.pop("c_profile"))
        torch.cuda.empty_cache()
        prep_launches, prep_rates = preprocess_path(torch, counters, FA, card, work)
        k1["at_preprocess_shapes"] = prep_rates.pop("k1_shapes")
        int8_launches, int8_rates = int8_path(torch, counters, card, work, handles, bundle,
                                                args.xl_layers)
        del handles
        # phase (o), on the handles of the phases it goes on from
        t_par = time.perf_counter()
        parallel_init(torch, work)
        int8_handles = int8_rates.pop("handles")
        par_launches["o2"], par["o2"] = parallel_int8(torch, counters, int8_handles["xl"],
                                                      int8_handles["pixels"])
        del int8_handles
        torch.cuda.empty_cache()
        par_s["o2"] = time.perf_counter() - t_par
        gptj_launches, gptj_rates = gptj_path(torch, counters, FS, S, card, work, bundle,
                                              args.gptj_layers)
        t_par = time.perf_counter()
        gptj_handles = gptj_rates.pop("handles")
        par_launches["o4"], par["o4"] = parallel_tp(torch, counters, gptj_handles)
        del gptj_handles
        par_s["o4"] = time.perf_counter() - t_par
        torch.cuda.empty_cache()
        gptj_rates["int8_prefix_train"] = gptj_int8_train(torch, card)
        torch.cuda.empty_cache()
        t5_launches, t5_rates = t5_path(torch, counters, FS, S, card, work, args.t0_layers)
        torch.cuda.empty_cache()
        genb_launches, genb_rates, genb_handles = genb_path(torch, counters, FA, FS, S, card,
                                                            work)
        k1["at_genb_shapes"] = genb_rates.pop("k1_shapes")
        torch.cuda.empty_cache()
        genb_serve_launches, genb_apps_launches, rest_rates = genb_rest_path(
            torch, counters, FA, FS, S, card, work, genb_handles)
        k1["at_genb_serving_shapes"] = rest_rates.pop("k1_shapes")
        t_par = time.perf_counter()
        par["o7"] = parallel_sp(torch, genb_handles)
        par_s["o7"] = time.perf_counter() - t_par
        del genb_handles
        torch.cuda.empty_cache()
        train_launches, train_rates = train_path(torch, counters, card, work)
        t_par = time.perf_counter()
        train_handles = train_rates.pop("handles")
        par["o5"] = parallel_zero_train(torch, work, train_handles["args"],
                                        train_handles["losses"])
        par_launches["o1"], par["o1"] = parallel_dp_decode(torch, counters, bundle)
        par_launches["o3"], par["o3"] = parallel_serving(torch, counters, bundle)
        par["o6"] = parallel_pp(torch)
        par["o8"] = parallel_ep(torch)
        par["o9"] = parallel_dryrun(torch)
        par_s["o1,o3,o5,o6,o8,o9"] = time.perf_counter() - t_par
        say("parallel phase (o), seconds by part: " + ", ".join(f"{k} {v:.1f}"
                                                                for k, v in par_s.items()))
    finally:
        # before the rendezvous file goes: NCCL's monitor reads it until then
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    parallel_launches = {k: sum(launches[k] for launches in par_launches.values())
                         for k in par_launches["o1"]}
    # each kernel that a path runs was launched there (K4 has no path)
    paths = {"fused_attention": {"main": main_launches["fused_attention"],
                                 "infer": infer_launches["fused_attention"],
                                 "evaluate": eval_launches["fused_attention"],
                                 "int8": int8_launches["fused_attention"],
                                 "gptj": gptj_launches["fused_attention"],
                                 "t5": t5_launches["fused_attention"],
                                 "preprocess": prep_launches["fused_attention"],
                                 "genb": genb_launches["fused_attention"],
                                 "serving_genb": genb_serve_launches["fused_attention"],
                                 "genb_apps": genb_apps_launches["fused_attention"],
                                 "train": train_launches["fused_attention"],
                                 "parallel": parallel_launches["fused_attention"]},
             "fused_filter_sample": {"main": main_launches["fused_filter_sample"],
                                     "serving": serve_launches["fused_filter_sample"],
                                     "infer": infer_launches["fused_filter_sample"],
                                     "evaluate": eval_launches["fused_filter_sample"],
                                     "int8": int8_launches["fused_filter_sample"],
                                     "gptj": gptj_launches["fused_filter_sample"],
                                     "t5": t5_launches["fused_filter_sample"],
                                     "genb": genb_launches["fused_filter_sample"],
                                     "serving_genb": genb_serve_launches["fused_filter_sample"],
                                     "genb_apps": genb_apps_launches["fused_filter_sample"],
                                     "train": train_launches["fused_filter_sample"],
                                     "parallel": parallel_launches["fused_filter_sample"]},
             "fused_step_sample": {"main": main_launches["fused_step_sample"],
                                   "serving": serve_launches["fused_step_sample"],
                                   "int8": int8_launches["fused_step_sample"],
                                   "gptj": gptj_launches["fused_step_sample"],
                                   "t5": t5_launches["fused_step_sample"],
                                   "serving_genb": genb_serve_launches["fused_step_sample"],
                                   "parallel": parallel_launches["fused_step_sample"]},
             "fused_filter": {"kernel_phase": k4_launches}}
    for name, by_path in paths.items():
        if name != "fused_filter":
            for path, n in by_path.items():
                check(n > 0, f"kernel {name} was not launched on the {path} path")

    sampler_src = "clipcap_tpu_torch/csrc/fused_sampler.cu"
    sources = {"fused_attention": ("clipcap_tpu_torch/csrc/fused_attention.cu",
                                   "clipcap_tpu/ops/pallas/fused_attention.py:68", k1),
               "fused_filter_sample": (sampler_src, "clipcap_tpu/ops/pallas/fused_sampler.py:255",
                                       k234["fused_filter_sample"]),
               "fused_step_sample": (sampler_src, "clipcap_tpu/ops/pallas/fused_sampler.py:371",
                                     k234["fused_step_sample"]),
               "fused_filter": (sampler_src, "clipcap_tpu/ops/pallas/fused_sampler.py:447",
                                k234["fused_filter"])}
    # the sampler kernels also at GPT-J's vocabulary and T0's: [72, V] and the sweep of rows
    v50400 = gptj_rates.pop("sampler_v50400")
    v32128 = t5_rates.pop("sampler_v32128")
    for name in ("fused_filter_sample", "fused_step_sample", "fused_filter"):
        sources[name][2]["at_vocab_50400"] = v50400[name]
        sources[name][2]["at_vocab_32128"] = v32128[name]
    # K2 at Gen B's synthesis step, [40, 30524] with top-k 2500 and per-row top-p
    sources["fused_filter_sample"][2]["at_genb_40x30524"] = genb_rates.pop("k2")
    # K2 and K3 at BLIP serving's step, [64, 30524] with top-k 2500 and top-p 0.5
    sources["fused_filter_sample"][2]["at_genb_64x30524"] = rest_rates.pop("k2")
    sources["fused_step_sample"][2]["at_genb_64x30524"] = rest_rates.pop("k3")
    # K2 at each sweep trial's synthesis step, [batch_size, 30524] with its top-k and top-p
    sources["fused_filter_sample"][2]["at_genb_sweep_trials"] = rest_rates.pop("k2_sweep")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(paths[name].values()), launches_by_path=paths[name],
                    on_path=name != "fused_filter", **nums)
               for name, (src, rep, nums) in sources.items()]
    say(f"main path on {card}: {rates['images_per_s']:.1f} images/s (ViT-B/32 encode, B=64), "
        f"{rates['captions_per_s']:.2f} captions/s (NoBeam sampler, 72 rows)")
    say(f"serving on {card}: " + json.dumps(serve_rates))
    say(f"infer on {card}: " + json.dumps(infer_rates))
    say(f"evaluate on {card}: " + json.dumps(eval_rates))
    say(f"int8 on {card}: " + json.dumps(int8_rates))
    say(f"gptj on {card}: " + json.dumps(gptj_rates))
    say(f"t5 on {card}: " + json.dumps(t5_rates))
    say(f"preprocess on {card}: " + json.dumps(prep_rates))
    say(f"genb on {card}: " + json.dumps(genb_rates))
    say(f"genb serving and apps on {card}: " + json.dumps(rest_rates))
    say(f"train on {card}: " + json.dumps(train_rates))
    say(f"parallel on {card}: " + json.dumps(par))
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
