"""What K1's f32 time at the ViT-B/32 shape is made of, measured on the card.

    python -m clipcap_tpu_torch.tools.k1_variants

From the root of the repository, on a machine with a CUDA card and nvcc.
Builds copies of csrc/fused_attention.cu, each with one change, next to
the port's own build, and runs each beside the kernel as it is at
B=64, T=50, H=12, dh=64, f32, on views of one packed qkv projection:

- `one_pass`: plain TF32, only big*big (wrong at the f32 tolerance: its
  error is printed); the difference is what the 3xTF32 compensation costs;
- `cvt_rna`: TF32 rounding by the cvt.rna.tf32.f32 instruction instead of
  the kernel's two integer operations (the same bits);
- `clocks`: the kernel with clock64 stamps; it reports the clocks of each
  phase of a block (copies of the first tile, its products and softmax,
  the later tiles, the epilogue) and how many blocks share an SM.

Times are device times of the attn_kernel launches (torch.profiler, as in
chip_smoke.py; the wrapper's host time per call is longer than the kernel)
over 50 launches after a warm-up, inputs warm in L2, taken in turns:
kernel, variants, variants in reverse, kernel. Prints the card's name and
power limit first and one JSON line last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import fused_attention as FA

SHAPE = (64, 50, 12, 64)  # B, T, H, dh
_MMA_PASSES = ("    mma_tf32(d[i], as, b0[i], b1[i]);\n", "")
_SMALL_PASS = ("  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, s0[i], s1[i]);\n", "")
_CVT = ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;\n')
# the clocks copy: stamps at the phase boundaries of tile 0 and of the block
_CLOCKS = [
    ("template <typename T, int DH>\n__global__",
     "__device__ long long k1_clk[8192][10];\n"
     "#define STAMP(i) do { if (threadIdx.x == 0) clk[i] = clock64(); } while (0)\n"
     "template <typename T, int DH>\n__global__"),
    ("  load_rows<T, DH>(qs, qb, lq.token, q0, ROWS, seq);\n",
     "  long long* clk = k1_clk[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x) & 8191];\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned sm; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm)); clk[7] = sm;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(clk[8]));\n  }\n"
     "  STAMP(0);\n  load_rows<T, DH>(qs, qb, lq.token, q0, ROWS, seq);\n"),
    ("    if (it == 0) load_q<T, DH>(qf, qs + wr * LD, g, t4);\n",
     "    if (it == 0) STAMP(1);\n    if (it == 0) load_q<T, DH>(qf, qs + wr * LD, g, t4);\n"),
    ("    fold_tile<T, DH, NB>(nv, st, qf, kt, vt, keys, scale2, g, t4, lane);\n",
     "    fold_tile<T, DH, NB>(nv, st, qf, kt, vt, keys, scale2, g, t4, lane);\n"
     "    if (it == 0) STAMP(2);\n"),
    ("  // normalise into the q tile", "  STAMP(3);\n  // normalise into the q tile"),
    ("          *reinterpret_cast<const int4*>(qs + r * LD + x * C::VEC);\n  }\n}",
     "          *reinterpret_cast<const int4*>(qs + r * LD + x * C::VEC);\n  }\n"
     "  STAMP(4);\n  if (threadIdx.x == 0) asm volatile(\"mov.u64 %0, %%globaltimer;\""
     " : \"=l\"(clk[9]));\n}"),
]
_READ_CLOCKS = """
extern "C" int k1_read_clocks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k1_clk, sizeof(k1_clk));
}
"""
VARIANTS = {"one_pass": [_MMA_PASSES, _SMALL_PASS], "cvt_rna": [_CVT], "clocks": _CLOCKS}
PHASES = ["first tile's copies", "first tile's products and softmax", "later tiles",
          "epilogue"]


def variant_source(name: str) -> str:
    """csrc/fused_attention.cu with the variant's edits; raises if an edit
    does not find its text exactly once."""
    src = (_build.CSRC / "fused_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in fused_attention.cu once")
        src = src.replace(old, new)
    return src + _READ_CLOCKS if name == "clocks" else src


def build_variant(name: str) -> ctypes.CDLL:
    src = variant_source(name)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / f"k1_{name}.cu", out_dir / f"libk1_{name}.so"
    cu.write_text(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"variant {name} failed to build:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(lib))


def kernel_ms(fn, iters: int = 50) -> float:
    """Device time per launch of the attn_kernel launches of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "attn_kernel" in e.key]
    if not events:
        raise RuntimeError("the profiler recorded no attn_kernel launch")
    return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)


def phase_clocks(lib: ctypes.CDLL, n_blocks: int) -> dict:
    buf = np.zeros((8192, 10), np.int64)
    if lib.k1_read_clocks(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("reading the clock stamps failed")
    c = buf[:n_blocks]
    steps = np.diff(c[:, :5], axis=1)
    out = {lab: float(np.median(steps[:, i])) for i, lab in enumerate(PHASES)}
    start, end = c[:, 8] - c[:, 8].min(), c[:, 9] - c[:, 8].min()
    mid = (start + end) // 2
    sm = c[:, 7]
    shared = [int(((start <= m) & (end >= m) & (sm == s)).sum()) for m, s in zip(mid, sm)]
    out["blocks_sharing_an_sm_median"] = float(np.median(shared))
    out["block_us_median"] = float(np.median(end - start)) / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {card}", flush=True)
    b, t, h, dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda")
    q, k, v = (y.reshape(b, t, h, dh) for y in qkv.chunk(3, dim=-1))
    want = FA.fused_attention_plain(q, k, v)
    libs = {"kernel": _build.library("fused_attention")}
    libs.update((name, build_variant(name)) for name in ("one_pass", "cvt_rna", "clocks"))
    saved = _build._libs["fused_attention"]
    times, errs = {}, {}
    try:
        for name in ["kernel", *list(libs)[1:], *list(libs)[:0:-1], "kernel"]:
            _build._libs["fused_attention"] = libs[name]
            errs[name] = float((FA.fused_attention(q, k, v) - want).abs().max())
            times.setdefault(name, []).append(kernel_ms(lambda: FA.fused_attention(q, k, v)))
        _build._libs["fused_attention"] = libs["clocks"]
        FA.fused_attention(q, k, v)
        torch.cuda.synchronize()
        clocks = phase_clocks(libs["clocks"], b * h * ((t + 63) // 64))
    finally:
        _build._libs["fused_attention"] = saved
    ms = {name: float(np.mean(x)) for name, x in times.items()}
    for name in libs:
        print(f"K1 {name}: {ms[name]:.4f} ms (turns {np.round(times[name], 4).tolist()}), "
              f"max abs err {errs[name]:.3e}", flush=True)
    print("K1 phase clocks (median per block): " + ", ".join(
        f"{k} {v:g}" for k, v in clocks.items()), flush=True)
    print(json.dumps({"card": card, "shape": list(SHAPE), "ms": ms, "max_abs_err": errs,
                      "clocks": clocks}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
