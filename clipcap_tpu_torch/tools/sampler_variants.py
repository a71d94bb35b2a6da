"""What the sampler kernel's time (K2/K3) is made of, measured on the card.

    python -m clipcap_tpu_torch.tools.sampler_variants

From the root of the repository, on a machine with a CUDA card and nvcc.
Builds copies of csrc/fused_sampler.cu, each with one change, next to the
port's own build, and times each beside the kernel as it is, on K2 at the
main path's flags (top-p sweep, Philox, no alt_prob) at 8 and 72 rows of
V=50257 with N(0, 9) logits and at 72 rows with N(0, 0.0625) logits (a
narrow row), and on K3 (penalty, eos gate and log P(eos)) at 72 rows:

- `no_atomics`: the value-bucket histogram's adds are plain shared-memory
  adds (racy, so the cutoffs may be wrong): what the atomics cost;
- `u32_atomics`: 32-bit atomic adds of the low word (wrong sums): what
  the 64-bit atomics cost beside 32-bit ones;
- `no_philox`: zero noise instead of Philox (the top-2 pass without the
  generator);
- `vbins_2048`: 2048 value buckets in a select's first pass, not 1024;
- `no_select`: the top-p select skipped (v* = -inf, nothing masked);
- `clocks`: the kernel with clock64 stamps at its phase boundaries and
  at the steps of the top-p select; it reports the median clocks of each
  phase of a block at 72 rows.

Times are device times of the sampler_kernel launches (torch.profiler, as
in chip_smoke.py) over 50 launches after a warm-up, inputs warm in L2,
taken in turns: kernel, variants, variants in reverse, kernel. Prints the
card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import fused_sampler as FS

VOCAB = 50257
_ADD = "if (wt != 0ull) atomicAdd(&H[bk.of(x)], wt);"
_CLOCK_PHASES = ["load", "load reduce", "top-k select", "top-p select", "top-2 pass",
                 "top-2 reduce and outputs"]
_CLOCKS = [
    ("__global__ void __launch_bounds__(THREADS, 2)",
     "__device__ long long smp_clk[8192][8];\n"
     "#define STAMP(i) do { if (threadIdx.x == 0) clk[i] = clock64(); } while (0)\n"
     "__global__ void __launch_bounds__(THREADS, 2)"),
    ("  int phase = 0;\n",
     "  int phase = 0;\n  long long* clk = smp_clk[blockIdx.x & 8191];\n  STAMP(0);\n"),
    ("  for (int o = 16; o > 0; o >>= 1) {\n    LoadStats other;",
     "  STAMP(1);\n  for (int o = 16; o > 0; o >>= 1) {\n    LoadStats other;"),
    ("  // ---- cutoffs: select, then replay the bisections ----\n",
     "  STAMP(2);\n  // ---- cutoffs: select, then replay the bisections ----\n"),
    ("  if ((flags & TOPP) && !(top_p[row] <= 0.f)) {",
     "  STAMP(3);\n  if ((flags & TOPP) && !(top_p[row] <= 0.f)) {"),
    ("  auto filtered = [&](float x) {", "  STAMP(4);\n  auto filtered = [&](float x) {"),
    ("    for (int o = 16; o > 0; o >>= 1) {\n      merge_top2(t, shfl_top2(t, o));",
     "    STAMP(5);\n    for (int o = 16; o > 0; o >>= 1) {\n"
     "      merge_top2(t, shfl_top2(t, o));"),
    ("  cluster.sync();  // no block leaves", "  STAMP(6);\n  cluster.sync();  // no block leaves"),
]
# the top-p select's own steps: the value-bucket histogram, its cluster
# merge, the compaction, the gather and the pairwise resolution
_SELECT_CLOCKS = [
    ("// Shared state of the selects.",
     "__device__ long long smp_sel[8192][8];\n"
     "#define SSTAMP(i) do { if (wg.mass && threadIdx.x == 0) "
     "smp_sel[blockIdx.x & 8191][i] = clock64(); } while (0)\n"
     "// Shared state of the selects."),
    ("  unsigned long long* H = next_hist(hist, nbuf, phase, VBINS, sel);\n",
     "  SSTAMP(0);\n  unsigned long long* H = next_hist(hist, nbuf, phase, VBINS, sel);\n"),
    ("  unsigned long long above = 0ull;\n  const int vbin",
     "  SSTAMP(1);\n  unsigned long long above = 0ull;\n  const int vbin"),
    ("  // compaction of the crossing bucket's tokens\n",
     "  SSTAMP(2);\n  // compaction of the crossing bucket's tokens\n"),
    ("  cluster.sync();  // every block's list is complete",
     "  SSTAMP(3);\n  cluster.sync();  // every block's list is complete"),
    ("  // gather the cluster's candidates", "  SSTAMP(4);\n  // gather the cluster's candidates"),
    ("  float best = -INFINITY;\n  for (int i = tid; i < n; i += THREADS) {",
     "  SSTAMP(5);\n  float best = -INFINITY;\n  for (int i = tid; i < n; i += THREADS) {"),
    ("  float v = sel.best[0];\n", "  float v = sel.best[0];\n  SSTAMP(6);\n"),
]
_SELECT_PHASES = ["histogram fill", "cluster merge and scan", "compaction",
                  "barrier and counts", "gather", "pairwise and reduce"]
_READ_CLOCKS = """
extern "C" int sampler_read_clocks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, smp_clk, sizeof(smp_clk));
}
extern "C" int sampler_read_select_clocks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, smp_sel, sizeof(smp_sel));
}
"""
VARIANTS = {
    "no_atomics": [(_ADD, "if (wt != 0ull) H[bk.of(x)] += wt;")],
    "u32_atomics": [(_ADD, "if (wt != 0ull) atomicAdd(reinterpret_cast<unsigned*>(&H[bk.of(x)]), "
                           "(unsigned)wt);")],
    "no_philox": [("gumbel(philox(gj, row_base + row, k0, k1))", "0.f")],
    "vbins_2048": [("constexpr int VBINS = 1024;", "constexpr int VBINS = 2048;")],
    "no_select": [("    if (isfinite(hi0))\n      v_p = select_cutoff",
                   "    if (false)\n      v_p = select_cutoff")],
    "clocks": _CLOCKS + _SELECT_CLOCKS,
}


def variant_source(name: str) -> str:
    """csrc/fused_sampler.cu with the variant's edits; raises if an edit
    does not find its text exactly once."""
    src = (_build.CSRC / "fused_sampler.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in fused_sampler.cu once")
        src = src.replace(old, new)
    return src + _READ_CLOCKS if name == "clocks" else src


def build_variants(names) -> dict:
    """Build the variants, one nvcc each, all started together."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu, lib = out_dir / f"sampler_{name}.cu", out_dir / f"libsampler_{name}.so"
        cu.write_text(variant_source(name))
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    for fn in ("sampler_read_clocks", "sampler_read_select_clocks"):
        if hasattr(libs.get("clocks"), fn):
            getattr(libs["clocks"], fn).argtypes = [ctypes.c_void_p]
            getattr(libs["clocks"], fn).restype = ctypes.c_int
    return libs


def kernel_ms(fn, iters: int = 50) -> float:
    """Device time per launch of the sampler_kernel launches of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "sampler_kernel" in e.key]
    if not events:
        raise RuntimeError("the profiler recorded no sampler_kernel launch")
    return sum(e.self_device_time_total for e in events) / 1e3 / sum(e.count for e in events)


def use(lib) -> None:
    """Point the K2/K3 wrappers at `lib` (its ctypes signatures set)."""
    FS._lib = None
    saved = _build._libs.get("fused_sampler")
    _build._libs["fused_sampler"] = lib
    try:
        FS._library()
    finally:
        if saved is not None:
            _build._libs["fused_sampler"] = saved


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sampler_variants: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {card}", flush=True)
    from ..ops import sampling as S

    cases = {}
    for rows in (8, 72):
        gen = torch.Generator(device="cuda").manual_seed(rows)
        x = torch.randn(rows, VOCAB, generator=gen, device="cuda") * 3
        top_p = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9],
                             device="cuda").repeat(rows // 9 + 1)[:rows].contiguous()
        hist = torch.randint(0, VOCAB, (rows, 24), generator=gen, device="cuda")
        appears = S.token_occurrence_mask(hist, VOCAB)
        gate = torch.arange(rows, device="cuda") % 2 == 0
        cases[f"K2 rows {rows}"] = (lambda x=x, p=top_p: FS.fused_filter_sample(
            x, 0, p, 5, do_topk=False, want_alt_prob=False))
        if rows == 72:
            xn = torch.randn(rows, VOCAB, generator=gen, device="cuda") * 0.25
            cases["K2 rows 72 sigma 0.25"] = (lambda x=xn, p=top_p: FS.fused_filter_sample(
                x, 0, p, 5, do_topk=False, want_alt_prob=False))
            cases["K3 rows 72"] = (lambda x=x, p=top_p, a=appears, g=gate: FS.fused_step_sample(
                x, 0, p, 5, do_topk=False, want_alt_prob=False, appears=a, penalty=1.2,
                eos_token_id=VOCAB - 1, suppress_eos=g, want_eos_lp=True))
    libs = {"kernel": _build.library("fused_sampler")}
    names = list(VARIANTS)
    libs.update(build_variants(names))
    times = {}
    try:
        for name in ["kernel", *names, *names[::-1], "kernel"]:
            use(libs[name])
            for case, fn in cases.items():
                times.setdefault(case, {}).setdefault(name, []).append(kernel_ms(fn))
        use(libs["clocks"])
        cases["K2 rows 72"]()
        torch.cuda.synchronize()
        buf = np.zeros((8192, 8), np.int64)
        if libs["clocks"].sampler_read_clocks(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise RuntimeError("reading the clock stamps failed")
        blocks = 72 * FS.cluster_size(72, VOCAB)
        steps = np.diff(buf[:blocks, :7], axis=1)
        clocks = {lab: float(np.median(steps[:, i])) for i, lab in enumerate(_CLOCK_PHASES)}
        clocks["block_total"] = float(np.median(buf[:blocks, 6] - buf[:blocks, 0]))
        sbuf = np.zeros((8192, 8), np.int64)
        if libs["clocks"].sampler_read_select_clocks(sbuf.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise RuntimeError("reading the select's clock stamps failed")
        steps = np.diff(sbuf[:blocks, :7], axis=1)
        for i, lab in enumerate(_SELECT_PHASES):
            clocks[f"top-p {lab}"] = float(np.median(steps[:, i]))
    finally:
        use(libs["kernel"])
    ms = {case: {name: float(np.mean(v)) for name, v in by.items()} for case, by in times.items()}
    for case, by in ms.items():
        print(f"{case}: " + ", ".join(f"{name} {t:.4f}" for name, t in by.items()) + " ms",
              flush=True)
    print("K2 rows 72 phase clocks (median per block): " + ", ".join(
        f"{k} {v:g}" for k, v in clocks.items()), flush=True)
    print(json.dumps({"card": card, "vocab": VOCAB, "ms": ms, "clocks": clocks}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
