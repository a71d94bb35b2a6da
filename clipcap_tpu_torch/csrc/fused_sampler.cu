// Fused per-step logit filter + Gumbel top-2 sampler (Hopper, sm_90a).
//
// Replaces the TPU kernels of clipcap_tpu/ops/pallas/fused_sampler.py:
// _sampler_kernel, reached through fused_filter_sample and, with its
// prologue, fused_step_sample; and filt_kernel (fused_filter), which is the
// FILTER output mode below: the filtered row (masked = -inf, kept values bit
// for bit the input's) is written back to a [B, V] output and the sampler is
// skipped. Per row of [B, V] f32 logits, in order:
//   prologue (fused_step_sample only): raw log P(eos) by a logsumexp,
//     min-length eos suppression, the CTRL repetition penalty from an int8
//     `appears` row, temperature;
//   top-k cutoff lo_k: the TPU kernel's bisection on count(x >= mid) >= k
//     over [finite min, max], then x < lo_k masked;
//   top-p cutoff lo_p: its bisection on the filtered softmax mass over
//     [max - 100, max], then !(x >= lo_p) masked;
//   Gumbel top-2 (the first index wins ties) -> next, alt, and alt_prob, the
//     filtered softmax at alt (0 when no second token is kept).
//
// Bound on the H100: the row must cross device memory once (4 bytes per
// logit, plus 1 byte per token of `appears` for the prologue): 14.5 MB at
// [72, 50257], ~4.3 us at 3.35 TB/s; the FILTER mode also writes the row
// back, 29.0 MB, ~8.6 us. The first version (one 1024-thread block per
// row, 28 shared-memory passes per bisection, Philox twice per token) took
// ~0.25 ms there: most SMs idle at small batch, ~34-37 passes per row.
//
// Design:
// - The cutoffs by selection, replayed into the bisection's own bits. The
//   bisection's test at `mid` depends only on the set {x >= mid}: for top-k
//   it holds exactly when mid <= v_k, the k-th largest value (with
//   multiplicity; -inf past the finite count); for top-p exactly when
//   mid <= v*, the largest value whose cumulative mass from the top exceeds
//   p (-inf if none). A select finds v_k and v*; the 28 steps then run as
//   scalar f32 arithmetic with `ok = mid <= v` and give lo_k and lo_p bit
//   for bit as the bisection would. The select: one histogram pass over
//   1024 value buckets of the row's range (top-k: [finite min, max]; top-p:
//   [max(finite min, lo_k, max - 28.5), max]) finds the crossing bucket;
//   each block compacts that bucket's tokens into a candidate list; every
//   block gathers the cluster's lists and resolves v exactly by weighing
//   each candidate against the others (integer sums). A bucket of more than
//   512 tokens (ties) goes to a radix select over order-preserving uint32
//   keys (-0.0 taken as +0.0; digits of 11, 11 and 10 bits, the last over
//   a compacted list). tests/test_torch_sampler_select.py holds a PyTorch
//   emulation of both paths against the bisections.
// - Deterministic mass. The top-p mass is exp(x - max) rounded to 2^-40
//   and summed as 64-bit integers (shared-memory integer atomics, no float
//   atomics), so its sums are the same in any order and for any cluster
//   size; the test is mass > floor(p * total). It differs from the plain
//   version's f32 sum of exp(x - m)/s only by rounding, so the cutoffs are
//   the TPU kernel's except where p lies within ~1e-7 of a cumulative mass.
// - A row spread over a thread block cluster. `rows * C` blocks of 512
//   threads run as clusters of C (1 to 8: the largest size whose blocks all
//   run at once, two per SM where shared memory allows, so that a small
//   batch still reaches every SM without a second wave: C = 8 up to 33
//   rows, 4 at 64, 3 at 72, 1 above 88). Each block loads a contiguous
//   ~V/C slice of its row into shared memory with 16-byte loads (a scalar
//   head up to the first 16-byte boundary and a tail) and runs every pass
//   on it. Cross-block reductions and the histograms go through distributed
//   shared memory: each block writes its partial into its own slot,
//   cluster.sync(), and every block reads all C slots in rank order. Rank 0
//   writes the per-row outputs; in FILTER mode each block writes its slice.
// - One load pass: the logits, the `appears` row and the suppression gate
//   are read once; penalty and temperature applied; the max, the finite
//   min and the raw logsumexp (online max/sum) taken on the way.
// - One Gumbel top-2 pass over the kept tokens only: (value, index) pairs
//   merged under "larger value, then smaller index"; Philox runs for kept
//   tokens only (a filtered token's perturbed value is -inf and wins no
//   slot); alt_prob's sum over the kept set is taken in the same pass.
// On the main path's flags (top-p only) a row takes a load pass, a
// histogram pass, a compaction pass and the top-2 pass, and five cluster
// barriers. What holds it back (tools/sampler_variants.py's clock stamps):
// the histogram pass, whose 64-bit shared atomics are throughput-bound,
// takes over a third of a block's clocks; the barriers and the cross-block
// merges most of the rest; 64 registers a thread (two blocks per SM) spill.
//
// Random numbers: without injected noise, u ~ U(0,1) comes from a
// Philox-4x32-10 counter generator keyed by the caller's 64-bit seed with the
// counter (token, row_base + row), row_base being a data-parallel shard's
// first global row (0 otherwise), so a row draws the same noise whatever the
// number of ranks. Same distribution as jax.random.gumbel or the TPU
// core PRNG, different draws: trajectories are not bit-comparable.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;  // two blocks per SM: 64 registers a thread
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CLUSTER = 8;
constexpr int SMS = 132;           // the H100 SXM's SMs
constexpr int BINS = 2048;         // the widest digit, 11 bits
constexpr int CAP = 1024;          // candidate list entries per block
constexpr int GATHER_MAX = 512;    // candidates a cluster resolves pairwise
constexpr int VBINS = 1024;        // value buckets of a select's first pass
// exp(-28.5) * 2^40 < 0.5: a lighter token's top-p weight rounds to 0
constexpr float MASS_SPAN = 28.5f;
// dynamic shared memory a block may take: the H100's 227 KB less room for
// the static shared variables below; an SM holds 228 KB, 1 KB of it
// reserved per block
constexpr int STATIC_SMEM = 4096;
constexpr int SMEM_DYN_LIMIT = 232448 - STATIC_SMEM;
constexpr int SMEM_PER_SM = 233472;
constexpr float FIX_SCALE = 1099511627776.0f;  // 2^40

enum : int {
  TOPK = 1,
  TOPP = 2,
  ALT_PROB = 4,
  NOISE = 8,
  PENALTY = 16,
  SUPPRESS = 32,
  EOS_LP = 64,
  TEMPERATURE = 128,
  FILTER = 256,
};

// Per-block partials of the load pass.
struct LoadStats {
  float hi;  // max after the prologue
  float mn;  // finite min after the prologue
  float m0;  // raw max, and the raw sum of exp(x - m0), for log P(eos)
  float s0;
};

// Top-2 of (perturbed value, index), with the kept logit carried along.
struct Top2 {
  float v1, x1;
  int i1;
  float v2, x2;
  int i2;
};

__device__ __forceinline__ size_t smem_hist_bytes(int nbuf) { return (size_t)nbuf * BINS * 8; }

// Order-preserving key of an f32 value; -0.0 shares +0.0's key.
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t b = __float_as_uint(x == 0.f ? 0.f : x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void merge_lse(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mx)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mx));
  m = mx;
}

__device__ __forceinline__ void merge_stats(LoadStats& a, const LoadStats& b) {
  a.hi = fmaxf(a.hi, b.hi);
  a.mn = fminf(a.mn, b.mn);
  merge_lse(a.m0, a.s0, b.m0, b.s0);
}

__device__ __forceinline__ bool beats(float v, int i, float w, int k) {
  return v > w || (v == w && i < k);
}

__device__ __forceinline__ void merge_top2(Top2& a, const Top2& b) {
  if (beats(b.v1, b.i1, a.v1, a.i1)) {
    if (beats(a.v1, a.i1, b.v2, b.i2)) {
      a.v2 = a.v1; a.x2 = a.x1; a.i2 = a.i1;
    } else {
      a.v2 = b.v2; a.x2 = b.x2; a.i2 = b.i2;
    }
    a.v1 = b.v1; a.x1 = b.x1; a.i1 = b.i1;
  } else if (beats(b.v1, b.i1, a.v2, a.i2)) {
    a.v2 = b.v1; a.x2 = b.x1; a.i2 = b.i1;
  }
}

__device__ __forceinline__ Top2 shfl_top2(const Top2& t, int o) {
  Top2 r;
  r.v1 = __shfl_xor_sync(FULL, t.v1, o);
  r.x1 = __shfl_xor_sync(FULL, t.x1, o);
  r.i1 = __shfl_xor_sync(FULL, t.i1, o);
  r.v2 = __shfl_xor_sync(FULL, t.v2, o);
  r.x2 = __shfl_xor_sync(FULL, t.x2, o);
  r.i2 = __shfl_xor_sync(FULL, t.i2, o);
  return r;
}

// Philox-4x32-10 (Salmon et al., SC'11), first output word.
__device__ __forceinline__ uint32_t philox(uint32_t c0, uint32_t c1, uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
    c0 = n0;
    c2 = n2;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  // 23 random mantissa bits -> u in (0, 1), as the TPU kernel does
  const float u = (float)(bits >> 9) * (1.0f / 8388608.0f) + (0.5f / 8388608.0f);
  return -logf(-logf(u));
}

// The bisection's 28 (`iters`) steps, replayed with the test `mid <= v`.
__device__ __forceinline__ float replay(float lo, float hi, float v, int iters) {
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool ok = mid <= v;
    lo = ok ? mid : lo;
    hi = ok ? hi : mid;
  }
  return lo;
}

// Shared state of the selects.
struct Select {
  unsigned long long warp_tot[WARPS];
  unsigned long long above;  // weight of the keys above the crossing bucket
  int bin;                   // the crossing bucket, -1 for none
  int nlist;                 // candidates appended to this block's list
  float best[WARPS];
};

// What a select weighs and which tokens it sees.
struct Weigh {
  bool mass;  // exp(x - hi0) in 2^-40 fixed point, else 1 per token
  float hi0;
  float cut;  // x < cut counts as -inf (the top-k mask, for top-p)
  __device__ float value(float x) const { return x < cut ? -INFINITY : x; }
  __device__ unsigned long long weight(float x) const {
    return mass ? __float2ull_rn(expf(x - hi0) * FIX_SCALE) : 1ull;
  }
};

// Value buckets: VBINS equal slices of [lo, hi], a larger bin holding
// larger values (the lowest also takes everything below lo). Monotone in x.
struct Buckets {
  float hi, inv_w;
  __device__ static Buckets over(float hi, float lo) {
    const float span = hi - lo;
    return {hi, span > 0.f && span < INFINITY ? (float)VBINS / span : 0.f};
  }
  __device__ int of(float x) const {
    const float t = (hi - x) * inv_w;
    return VBINS - 1 - (t < (float)(VBINS - 1) ? (int)t : VBINS - 1);
  }
};

// Compaction: the lanes with `ok` append x to the block's list, one atomic
// per warp reserving the warp's slots (a warp with none skips it). Called
// by whole warps.
__device__ __forceinline__ void append(float* list, Select& sel, bool ok, float x) {
  const unsigned act = __ballot_sync(FULL, ok);
  if (act == 0u) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(&sel.nlist, __popc(act));
  base = __shfl_sync(FULL, base, 0);
  const int pos = base + __popc(act & ((1u << lane) - 1u));
  if (ok && pos < CAP) list[pos] = x;
}

// Clear this block's next histogram buffer. The buffers alternate, and a
// buffer is cleared only after a cluster barrier that follows every
// block's reads of it.
__device__ unsigned long long* next_hist(unsigned long long* hist, int nbuf, int& phase, int nb,
                                         Select& sel) {
  unsigned long long* H = hist + (size_t)(phase++ % nbuf) * BINS;
  __syncthreads();  // this block is done with the buffer and with sel
  for (int b = threadIdx.x; b < nb; b += THREADS) H[b] = 0ull;
  if (threadIdx.x == 0) sel.bin = -1;
  __syncthreads();
  return H;
}

// After every block filled H (nb bins): sum the cluster's histograms over
// the blocks in rank order and return the crossing bucket, the largest b
// with above + weight(bins >= b) > thr (-1 if none), moving `above` to the
// weight of the bins past it. With `set_thr`, thr becomes floor(pp * total)
// first.
__device__ int crossing_bin(cg::cluster_group& cluster, int C, unsigned long long* H, int nb,
                            unsigned long long& above, unsigned long long& thr, bool set_thr,
                            float pp, Select& sel) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  cluster.sync();  // every block's histogram is complete
  // four ranks' loads in flight at a time (a rank past C re-reads the last)
  const int per = nb / THREADS;
  unsigned long long h[4] = {0ull, 0ull, 0ull, 0ull}, mine = 0ull;
#pragma unroll
  for (int r0 = 0; r0 < MAX_CLUSTER; r0 += 4) {
    if (r0 >= C) break;
    ulonglong2 lo2[4], hi2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const ulonglong2* p = reinterpret_cast<const ulonglong2*>(
          cluster.map_shared_rank(H, min(r0 + i, C - 1)) + tid * per);
      lo2[i] = p[0];
      hi2[i] = per == 4 ? p[1] : make_ulonglong2(0ull, 0ull);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < C) {
        h[0] += lo2[i].x;
        h[1] += lo2[i].y;
        h[2] += hi2[i].x;
        h[3] += hi2[i].y;
      }
    }
  }
  for (int q = 0; q < per; ++q) mine += h[q];
  // suffix sums from this thread's bins to the top
  unsigned long long incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_down_sync(FULL, incl, o);
    if (lane + o < 32) incl += y;
  }
  if (lane == 0) sel.warp_tot[w] = incl;
  __syncthreads();
  unsigned long long later = 0ull, total = 0ull;
  for (int v = 0; v < WARPS; ++v) {
    const unsigned long long t = sel.warp_tot[v];
    total += t;
    if (v > w) later += t;
  }
  incl += later;
  if (set_thr) thr = (unsigned long long)floor((double)pp * (double)total);
  unsigned long long ge_next = above + incl - mine;
  for (int q = per - 1; q >= 0; --q) {
    const unsigned long long ge = ge_next + h[q];
    if (ge > thr && ge_next <= thr) {
      sel.bin = tid * per + q;
      sel.above = ge_next;
    }
    ge_next = ge;
  }
  __syncthreads();
  const int bin = sel.bin;
  if (bin >= 0) above = sel.above;
  return bin;
}

// The key-digit radix select, for a crossing value-bucket too large to
// gather: the value of the largest key t with above + weight({key >= t})
// > thr among the tokens of value bucket `vbin` of `bk`. Digits of 11, 11
// and 10 key bits; after the first, each block compacts the digit's
// crossing bucket into its list and the last digit reads the list (a
// rescan only if it overflowed).
__device__ float radix_select(cg::cluster_group& cluster, int C, const float* xs, int len,
                              unsigned long long* hist, int nbuf, int& phase, float* list,
                              Select& sel, const Weigh& wg, const Buckets& bk, int vbin,
                              unsigned long long above, unsigned long long thr) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0;
  for (int d = 0; d < 3; ++d) {
    const int shift = d == 0 ? 21 : (d == 1 ? 10 : 0);
    const int nb = d == 2 ? 1024 : 2048;
    unsigned long long* H = next_hist(hist, nbuf, phase, nb, sel);
    if (d == 1 && tid == 0) sel.nlist = 0;
    __syncthreads();
    const int match = d == 1 ? 21 : 10;  // the digits already chosen
    const uint32_t want = prefix >> match;
    const bool from_list = d == 2 && sel.nlist <= CAP;
    const int n = from_list ? sel.nlist : len;
    const float* src = from_list ? list : xs;
    // warp-uniform trip count: the warp's lanes meet at the ballot below
    for (int jb = tid - lane; jb < n; jb += THREADS) {
      const int j = jb + lane;
      const float x = j < n ? wg.value(src[j]) : -INFINITY;
      const uint32_t k = order_key(x);
      bool ok = x != -INFINITY && (from_list || bk.of(x) == vbin) &&
                (d == 0 || (k >> match) == want);
      const unsigned long long wt = ok ? wg.weight(x) : 0ull;
      ok = ok && wt != 0ull;
      if (ok) atomicAdd(&H[(k >> shift) & (nb - 1)], wt);
      if (d == 1) append(list, sel, ok, x);
    }
    const int bin = crossing_bin(cluster, C, H, nb, above, thr, false, 0.f, sel);
    if (bin < 0) return -INFINITY;  // cannot happen: the bucket crossed
    prefix |= (uint32_t)bin << shift;
  }
  return key_value(prefix);
}

// The cutoff value v of a select: the largest token value with
// weight({x >= v}) > thr over this row's tokens in the cluster (top-k: the
// k-th largest, thr = k - 1; top-p: v*, thr = floor(p * total mass)), -inf
// if there is none. A histogram pass over value buckets of [lo, max] finds
// the crossing bucket (top-k: lo is the finite min; top-p: the larger of
// that, the top-k cutoff and max - 28.5, below which a token weighs 0), so
// a row's own range spreads over the buckets, however narrow. Each block
// compacts that bucket's tokens into its list; every block gathers the
// cluster's lists and resolves v exactly by weighing each candidate against
// all others. A bucket with more than GATHER_MAX tokens (ties, or a range
// that bunches) goes to the key-digit radix select instead.
__device__ float select_cutoff(cg::cluster_group& cluster, int C, const float* xs, int len,
                               unsigned long long* hist, int nbuf, int& phase, float* list,
                               Select& sel, const Weigh& wg, float lo, unsigned long long thr,
                               float pp) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const Buckets bk = Buckets::over(wg.hi0, lo);
  unsigned long long* H = next_hist(hist, nbuf, phase, VBINS, sel);
  for (int j = tid; j < len; j += THREADS) {
    const float x = wg.value(xs[j]);
    if (x == -INFINITY) continue;
    const unsigned long long wt = wg.weight(x);
    if (wt != 0ull) atomicAdd(&H[bk.of(x)], wt);
  }
  unsigned long long above = 0ull;
  const int vbin = crossing_bin(cluster, C, H, VBINS, above, thr, wg.mass, pp, sel);
  if (vbin < 0) return -INFINITY;
  // compaction of the crossing bucket's tokens
  if (tid == 0) sel.nlist = 0;
  __syncthreads();
  for (int jb = tid - lane; jb < len; jb += THREADS) {
    const int j = jb + lane;
    const float x = j < len ? wg.value(xs[j]) : -INFINITY;
    const bool ok = x != -INFINITY;
    append(list, sel, ok && bk.of(x) == vbin && wg.weight(x) != 0ull, x);
  }
  cluster.sync();  // every block's list is complete; nobody reads H any more
  int counts[MAX_CLUSTER];
  int n = 0;
  bool over = false;
  for (int r = 0; r < C; ++r) {
    counts[r] = *cluster.map_shared_rank(&sel.nlist, r);
    over = over || counts[r] > CAP;
    n += counts[r];
  }
  if (over || n > GATHER_MAX)
    return radix_select(cluster, C, xs, len, hist, nbuf, phase, list, sel, wg, bk, vbin, above,
                        thr);
  // gather the cluster's candidates (in rank order) into the free histogram space
  unsigned long long* gw = hist;
  float* gx = reinterpret_cast<float*>(hist + GATHER_MAX);
  for (int i = tid; i < n; i += THREADS) {
    int r = 0, o = i;
    while (o >= counts[r]) o -= counts[r++];
    const float x = cluster.map_shared_rank(list, r)[o];
    gx[i] = x;
    gw[i] = wg.weight(x);
  }
  __syncthreads();
  float best = -INFINITY;
  for (int i = tid; i < n; i += THREADS) {
    const float xi = gx[i];
    unsigned long long m = above;
    for (int j = 0; j < n; ++j) m += gx[j] >= xi ? gw[j] : 0ull;
    if (m > thr) best = fmaxf(best, xi);
  }
  for (int o = 16; o > 0; o >>= 1) best = fmaxf(best, __shfl_xor_sync(FULL, best, o));
  if (lane == 0) sel.best[w] = best;
  __syncthreads();
  float v = sel.best[0];
  for (int i = 1; i < WARPS; ++i) v = fmaxf(v, sel.best[i]);
  return v;
}

__global__ void __launch_bounds__(THREADS, 2)
sampler_kernel(const float* __restrict__ logits, const float* __restrict__ top_k,
               const float* __restrict__ top_p, const int8_t* __restrict__ appears,
               const float* __restrict__ suppress, const float* __restrict__ noise,
               int* __restrict__ next_out, int* __restrict__ alt_out,
               float* __restrict__ alt_prob_out, float* __restrict__ eos_lp_out,
               float* __restrict__ filtered_out, int vocab,
               int flags, int iters, float penalty, float inv_temp, int eos_id,
               unsigned long long seed, int row_base) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LoadStats part_stats[WARPS];
  __shared__ LoadStats slot_stats;
  __shared__ Top2 part_top2[WARPS];
  __shared__ Top2 slot_top2;
  __shared__ float part_sum[WARPS];
  __shared__ float slot_sum;
  __shared__ Select sel;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nbuf = C > 1 ? 2 : 1;
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int slice = (vocab + C - 1) / C;
  const int start = rank * slice;
  const int len = max(0, min(slice, vocab - start));
  const size_t off = (size_t)row * vocab + start;  // this block's slice in [B, V]

  unsigned long long* hist = reinterpret_cast<unsigned long long*>(smem);
  float* list = reinterpret_cast<float*>(smem + smem_hist_bytes(nbuf));
  float* xbase = list + CAP;
  // slice element j lives at xs[j]; xs is offset so that 16-byte global
  // loads land on 16-byte shared addresses
  const int a = (int)((reinterpret_cast<uintptr_t>(logits + off) >> 2) & 3);
  float* xs = xbase + a;
  int phase = 0;

  // ---- load + prologue: one pass over the slice ----
  const bool supp = (flags & SUPPRESS) && suppress[row] > 0.f;
  LoadStats st = {-INFINITY, INFINITY, -INFINITY, 0.f};
  auto take = [&](int j, float raw) {
    if (flags & EOS_LP) {
      if (raw > st.m0) {
        st.s0 = (st.m0 == -INFINITY ? 0.f : st.s0 * expf(st.m0 - raw)) + 1.f;
        st.m0 = raw;
      } else if (st.m0 > -INFINITY) {
        st.s0 += expf(raw - st.m0);
      }
    }
    float v = raw;
    if (supp && start + j == eos_id) v = -INFINITY;
    if ((flags & PENALTY) && appears[off + j] != 0) v = v < 0.f ? v * penalty : v / penalty;
    if (flags & TEMPERATURE) v = v * inv_temp;
    xs[j] = v;
    st.hi = fmaxf(st.hi, v);
    if (isfinite(v)) st.mn = fminf(st.mn, v);
  };
  const float* g = logits + off;
  const int head = min(len, (4 - a) & 3);
  const int nvec = (len - head) >> 2;
  if (tid < head) take(tid, g[tid]);
  for (int i = tid; i < nvec; i += THREADS) {
    const int j = head + 4 * i;
    const float4 q = *reinterpret_cast<const float4*>(g + j);
    take(j, q.x);
    take(j + 1, q.y);
    take(j + 2, q.z);
    take(j + 3, q.w);
  }
  for (int j = head + 4 * nvec + tid; j < len; j += THREADS) take(j, g[j]);

  for (int o = 16; o > 0; o >>= 1) {
    LoadStats other;
    other.hi = __shfl_xor_sync(FULL, st.hi, o);
    other.mn = __shfl_xor_sync(FULL, st.mn, o);
    other.m0 = __shfl_xor_sync(FULL, st.m0, o);
    other.s0 = __shfl_xor_sync(FULL, st.s0, o);
    merge_stats(st, other);
  }
  if (lane == 0) part_stats[w] = st;
  __syncthreads();
  if (tid == 0) {
    LoadStats b = part_stats[0];
    for (int v = 1; v < WARPS; ++v) merge_stats(b, part_stats[v]);
    slot_stats = b;
  }
  cluster.sync();
  LoadStats rs = *cluster.map_shared_rank(&slot_stats, 0);
  for (int r = 1; r < C; ++r) merge_stats(rs, *cluster.map_shared_rank(&slot_stats, r));
  const float hi0 = rs.hi;

  // ---- cutoffs: select, then replay the bisections ----
  float cut_k = -INFINITY, cut_p = -INFINITY;
  bool mask_p = false;
  if ((flags & TOPK) && top_k[row] > 0.f) {
    const float kk = top_k[row];
    float v_k = -INFINITY;
    if (isfinite(hi0))
      v_k = select_cutoff(cluster, C, xs, len, hist, nbuf, phase, list, sel,
                          Weigh{false, hi0, -INFINITY}, rs.mn,
                          (unsigned long long)ceilf(kk) - 1ull, 0.f);
    cut_k = replay(rs.mn, hi0, v_k, iters);
  }
  if ((flags & TOPP) && !(top_p[row] <= 0.f)) {
    const float pp = top_p[row];
    float v_p = -INFINITY;
    if (isfinite(hi0))
      v_p = select_cutoff(cluster, C, xs, len, hist, nbuf, phase, list, sel,
                          Weigh{true, hi0, cut_k},
                          fmaxf(hi0 - MASS_SPAN, fmaxf(rs.mn, cut_k)), 0ull, pp);
    cut_p = replay(hi0 - 100.0f, hi0, v_p, iters);
    mask_p = true;
  }
  auto filtered = [&](float x) {
    if (x < cut_k) x = -INFINITY;
    if (mask_p && !(x >= cut_p)) x = -INFINITY;
    return x;
  };

  if (flags & FILTER) {
    // ---- fused_filter: each block writes its slice of the filtered row ----
    float* o = filtered_out + off;
    const bool vec = ((reinterpret_cast<uintptr_t>(o) >> 2) & 3) == (uintptr_t)a;
    if (vec) {
      if (tid < head) o[tid] = filtered(xs[tid]);
      for (int i = tid; i < nvec; i += THREADS) {
        const int j = head + 4 * i;
        float4 q;
        q.x = filtered(xs[j]);
        q.y = filtered(xs[j + 1]);
        q.z = filtered(xs[j + 2]);
        q.w = filtered(xs[j + 3]);
        *reinterpret_cast<float4*>(o + j) = q;
      }
      for (int j = head + 4 * nvec + tid; j < len; j += THREADS) o[j] = filtered(xs[j]);
    } else {
      for (int j = tid; j < len; j += THREADS) o[j] = filtered(xs[j]);
    }
  } else {
    // ---- Gumbel top-2 over the kept tokens, and alt_prob's sum ----
    const uint32_t k0 = (uint32_t)(seed & 0xffffffffull), k1 = (uint32_t)(seed >> 32);
    Top2 t = {-INFINITY, 0.f, 0x7fffffff, -INFINITY, 0.f, 0x7fffffff};
    float sf = 0.f;
    for (int j = tid; j < len; j += THREADS) {
      const float x = filtered(xs[j]);
      if (x == -INFINITY) continue;
      const int gj = start + j;
      if (flags & ALT_PROB) sf += expf(x - hi0);
      const float gn = (flags & NOISE) ? noise[off + j] : gumbel(philox(gj, row_base + row, k0, k1));
      const float p = x + gn;
      if (!(p > -INFINITY)) continue;
      const Top2 one = {p, x, gj, -INFINITY, 0.f, 0x7fffffff};
      merge_top2(t, one);
    }
    for (int o = 16; o > 0; o >>= 1) {
      merge_top2(t, shfl_top2(t, o));
      sf += __shfl_xor_sync(FULL, sf, o);
    }
    if (lane == 0) {
      part_top2[w] = t;
      part_sum[w] = sf;
    }
    __syncthreads();
    if (tid == 0) {
      Top2 b = part_top2[0];
      float s = part_sum[0];
      for (int v = 1; v < WARPS; ++v) {
        merge_top2(b, part_top2[v]);
        s += part_sum[v];
      }
      slot_top2 = b;
      slot_sum = s;
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
      Top2 b = *cluster.map_shared_rank(&slot_top2, 0);
      float s = *cluster.map_shared_rank(&slot_sum, 0);
      for (int r = 1; r < C; ++r) {
        merge_top2(b, *cluster.map_shared_rank(&slot_top2, r));
        s += *cluster.map_shared_rank(&slot_sum, r);
      }
      const bool has1 = b.v1 > -INFINITY, has2 = b.v2 > -INFINITY;
      next_out[row] = has1 ? b.i1 : 0;
      alt_out[row] = has2 ? b.i2 : 0;
      // the filtered softmax at alt: its max is hi0, which the filters keep
      alt_prob_out[row] = ((flags & ALT_PROB) && has2) ? expf(b.x2 - hi0) / s : 0.f;
      if (flags & EOS_LP)
        eos_lp_out[row] = logits[(size_t)row * vocab + eos_id] - (rs.m0 + logf(rs.s0));
    }
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

size_t smem_bytes(int vocab, int c) {
  const int slice = (vocab + c - 1) / c;
  return (size_t)(c > 1 ? 2 : 1) * BINS * 8 + (size_t)CAP * 4 + (size_t)(slice + 4) * 4;
}

int blocks_per_sm(int vocab, int c) {
  const int by_smem = SMEM_PER_SM / (int)(smem_bytes(vocab, c) + STATIC_SMEM + 1024);
  return by_smem < 2 ? by_smem : 2;
}

// Blocks per row: the largest cluster size up to MAX_CLUSTER whose rows * C
// blocks all run at once (one wave: a second, partial wave would double the
// time), else the smallest that fits the row; 0 if the row does not fit a
// cluster of MAX_CLUSTER.
int choose_cluster(int rows, int vocab) {
  int best = 0;
  for (int c = MAX_CLUSTER; c >= 1; --c) {
    if (smem_bytes(vocab, c) > (size_t)SMEM_DYN_LIMIT) continue;
    if ((long long)rows * c <= (long long)SMS * blocks_per_sm(vocab, c)) return c;
    best = c;
  }
  return best;
}

int launch(const float* logits, const float* top_k, const float* top_p, const int8_t* appears,
           const float* suppress, const float* noise, int* next_out, int* alt_out,
           float* alt_prob_out, float* eos_lp_out, float* filtered_out, int rows, int vocab,
           int flags, int iters, float penalty, float inv_temp, int eos_id,
           unsigned long long seed, int row_base, void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaErrorInvalidValue;
  const int c = choose_cluster(rows, vocab);
  if (c == 0) return (int)cudaErrorInvalidValue;
  // the dynamic shared memory limit, raised once per device
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_DYN_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sampler_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * c));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(vocab, c);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sampler_kernel, logits, top_k, top_p, appears, suppress, noise,
                           next_out, alt_out, alt_prob_out, eos_lp_out, filtered_out, vocab,
                           flags, iters, penalty, inv_temp, eos_id, seed, row_base);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Largest vocabulary a row may have: its slices must fit the shared memory
// of a cluster of MAX_CLUSTER blocks.
extern "C" int clipcap_sampler_max_vocab(void) {
  int lo = 1, hi = 1 << 24;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (smem_bytes(mid, MAX_CLUSTER) <= (size_t)SMEM_DYN_LIMIT) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Blocks per row (the cluster size) a launch of [rows, vocab] uses; 0 if
// the row does not fit.
extern "C" int clipcap_sampler_cluster(int rows, int vocab) {
  return rows > 0 && vocab > 0 ? choose_cluster(rows, vocab) : 0;
}

// logits [rows, vocab] f32; top_k, top_p, suppress [rows] f32; appears
// [rows, vocab] int8; noise [rows, vocab] f32; outputs [rows]. Pointers a
// flag does not use may be null. Row i draws Philox's counter row
// row_base + i (a data-parallel shard's rows of a global batch). Returns
// the cudaError_t of the launch.
extern "C" int clipcap_fused_sampler(const void* logits, const void* top_k, const void* top_p,
                                     const void* appears, const void* suppress,
                                     const void* noise, void* next_out, void* alt_out,
                                     void* alt_prob_out, void* eos_lp_out, int rows, int vocab,
                                     int flags, int iters, float penalty, float inv_temp,
                                     int eos_id, unsigned long long seed, int row_base,
                                     void* stream) {
  return launch(static_cast<const float*>(logits), static_cast<const float*>(top_k),
                static_cast<const float*>(top_p), static_cast<const int8_t*>(appears),
                static_cast<const float*>(suppress), static_cast<const float*>(noise),
                static_cast<int*>(next_out), static_cast<int*>(alt_out),
                static_cast<float*>(alt_prob_out), static_cast<float*>(eos_lp_out), nullptr,
                rows, vocab, flags & ~FILTER, iters, penalty, inv_temp, eos_id, seed, row_base,
                stream);
}

// fused_filter: logits [rows, vocab] f32, top_k, top_p [rows] f32 ->
// filtered_out [rows, vocab] f32. `flags` takes TOPK and TOPP only. Returns
// the cudaError_t of the launch.
extern "C" int clipcap_fused_filter(const void* logits, const void* top_k, const void* top_p,
                                    void* filtered_out, int rows, int vocab, int flags, int iters,
                                    void* stream) {
  return launch(static_cast<const float*>(logits), static_cast<const float*>(top_k),
                static_cast<const float*>(top_p), nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, static_cast<float*>(filtered_out), rows, vocab,
                (flags & (TOPK | TOPP)) | FILTER, iters, 1.f, 1.f, -1, 0ull, 0, stream);
}
