// Fused per-step logit filter + Gumbel top-2 sampler (Hopper, sm_90a).
//
// Replaces the TPU kernels of clipcap_tpu/ops/pallas/fused_sampler.py:
// _sampler_kernel, reached through fused_filter_sample and, with its
// prologue, fused_step_sample; and filt_kernel (fused_filter), which is the
// FILTER output mode below: the same top-k/top-p passes, then the filtered
// row (masked = -inf, kept values bit for bit the input's) is written back
// to a [B, V] output and the sampler is skipped. Per row of [B, V] f32
// logits, in order:
//   prologue (fused_step_sample only): raw log P(eos) by a logsumexp,
//     min-length eos suppression, the CTRL repetition penalty from an int8
//     `appears` row, temperature;
//   top-k cutoff: bisection on count(x >= mid) >= k over [finite min, max];
//   top-p cutoff: bisection on the filtered softmax mass over [max-100, max];
//   Gumbel top-2 (the first index wins ties) -> next, alt, and alt_prob, the
//     filtered softmax at alt (0 for a singleton kept set).
// The bisections run the JAX kernel's iteration count and brackets with the
// same f32 arithmetic, so the cutoffs are the JAX kernel's up to the summation
// order of the top-p mass.
//
// Design: one block of 1024 threads per row. The f32 row (201 KB at V=50257)
// is loaded once into dynamic shared memory, which a block may size up to
// 227 KB on the H100, and every pass (the ~56 bisection reductions, the
// softmax sums, the two arg-max passes) runs on it; only per-row scalars go
// back to device memory. The filtered probabilities are recomputed from the
// row in each top-p iteration instead of being stored, since a second
// [V] f32 buffer does not fit beside the row. The `appears` row (1 byte per
// token) and injected noise are read from device memory with coalesced loads
// and not staged. Each block reduction is a warp-shuffle tree, one shared
// slot per warp, then every warp reduces the 32 partials itself in the same
// order, so all threads see the same bits and take the same bisection branch.
// The feature gates (top-k, top-p, alt_prob, noise, prologue) are a bitmask
// uniform over the launch, so the branches never diverge inside a block.
//
// Random numbers: without injected noise, u ~ U(0,1) comes from a
// Philox-4x32-10 counter generator keyed by the caller's 64-bit seed with the
// counter (token, row). Same distribution as jax.random.gumbel or the TPU
// core PRNG, different draws: trajectories are not bit-comparable.
//
// Bound on the H100: the row must cross device memory once (4 bytes per
// logit, plus 1 byte per token of `appears` for the penalty), ~14.5 MB at
// [72, 50257], ~4.3 us at 3.35 TB/s; the FILTER mode also writes the row
// back, 29.0 MB, ~8.6 us. This first version is far from that:
// one block per row leaves most SMs idle at small batch, and each bisection
// step is a full pass over shared memory with two barriers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

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

struct Scratch {
  float f[WARPS];
  int i[WARPS];
};

__device__ __forceinline__ float block_sum(float v, Scratch& red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // readers of the previous reduction are done
  if (lane == 0) red.f[w] = v;
  __syncthreads();
  float r = red.f[lane];
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(FULL, r, o);
  return r;
}

__device__ __forceinline__ int block_sum_int(int v, Scratch& red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red.i[w] = v;
  __syncthreads();
  int r = red.i[lane];
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(FULL, r, o);
  return r;
}

__device__ __forceinline__ float block_max(float v, Scratch& red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red.f[w] = v;
  __syncthreads();
  float r = red.f[lane];
  for (int o = 16; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(FULL, r, o));
  return r;
}

__device__ __forceinline__ float block_min(float v, Scratch& red) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red.f[w] = v;
  __syncthreads();
  float r = red.f[lane];
  for (int o = 16; o > 0; o >>= 1) r = fminf(r, __shfl_xor_sync(FULL, r, o));
  return r;
}

// (value, index) arg-max with first-index ties: the larger value wins, an equal
// value goes to the smaller index.
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void block_argmax(float& v, int& i, Scratch& red) {
  for (int o = 16; o > 0; o >>= 1) better(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) {
    red.f[w] = v;
    red.i[w] = i;
  }
  __syncthreads();
  v = red.f[lane];
  i = red.i[lane];
  for (int o = 16; o > 0; o >>= 1) better(v, i, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o));
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

__global__ void __launch_bounds__(THREADS)
sampler_kernel(const float* __restrict__ logits, const float* __restrict__ top_k,
               const float* __restrict__ top_p, const int8_t* __restrict__ appears,
               const float* __restrict__ suppress, const float* __restrict__ noise,
               int* __restrict__ next_out, int* __restrict__ alt_out,
               float* __restrict__ alt_prob_out, float* __restrict__ eos_lp_out,
               float* __restrict__ filtered_out, int vocab,
               int flags, int iters, float penalty, float inv_temp, int eos_id,
               unsigned long long seed) {
  extern __shared__ float x[];  // one row of logits, [vocab]
  __shared__ Scratch red;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = (size_t)row * vocab;

  for (int j = tid; j < vocab; j += THREADS) x[j] = logits[off + j];
  __syncthreads();

  // ---- prologue: eos logprob -> eos suppression -> penalty -> temperature ----
  if (flags & EOS_LP) {
    float mx = -INFINITY;
    for (int j = tid; j < vocab; j += THREADS) mx = fmaxf(mx, x[j]);
    const float m0 = block_max(mx, red);
    float acc = 0.f;
    for (int j = tid; j < vocab; j += THREADS) acc += expf(x[j] - m0);
    const float lse = m0 + logf(block_sum(acc, red));
    if (tid == 0) eos_lp_out[row] = x[eos_id] - lse;
    __syncthreads();  // x[eos_id] is read before suppression writes it
  }
  if ((flags & SUPPRESS) && suppress[row] > 0.f && tid == 0) x[eos_id] = -INFINITY;
  if (flags & (PENALTY | TEMPERATURE)) {
    __syncthreads();
    for (int j = tid; j < vocab; j += THREADS) {
      float xj = x[j];
      if ((flags & PENALTY) && appears[off + j] != 0) xj = xj < 0.f ? xj * penalty : xj / penalty;
      if (flags & TEMPERATURE) xj = xj * inv_temp;
      x[j] = xj;
    }
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = tid; j < vocab; j += THREADS) mx = fmaxf(mx, x[j]);
  const float hi0 = block_max(mx, red);

  // ---- top-k: the largest cutoff keeping at least k tokens ----
  if (flags & TOPK) {
    const float kk = top_k[row];
    float mn = INFINITY;
    for (int j = tid; j < vocab; j += THREADS)
      if (isfinite(x[j])) mn = fminf(mn, x[j]);
    float lo = block_min(mn, red), hi = hi0;
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      int cnt = 0;
      for (int j = tid; j < vocab; j += THREADS) cnt += x[j] >= mid;
      const bool ok = (float)block_sum_int(cnt, red) >= kk;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid;
    }
    if (kk > 0.f)
      for (int j = tid; j < vocab; j += THREADS)
        if (x[j] < lo) x[j] = -INFINITY;
    __syncthreads();
  }

  // ---- top-p: the largest cutoff whose kept mass exceeds p ----
  if (flags & TOPP) {
    const float pp = top_p[row];
    float m1 = -INFINITY;
    for (int j = tid; j < vocab; j += THREADS) m1 = fmaxf(m1, x[j]);
    const float m = block_max(m1, red);
    float acc = 0.f;
    for (int j = tid; j < vocab; j += THREADS) acc += expf(x[j] - m);
    const float s = block_sum(acc, red);
    float lo = hi0 - 100.0f, hi = hi0;
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float mass = 0.f;
      for (int j = tid; j < vocab; j += THREADS)
        if (x[j] >= mid) mass += expf(x[j] - m) / s;
      const bool ok = block_sum(mass, red) > pp;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid;
    }
    if (!(pp <= 0.f))
      for (int j = tid; j < vocab; j += THREADS)
        if (!(x[j] >= lo)) x[j] = -INFINITY;
    __syncthreads();
  }

  // ---- fused_filter: the filtered row is the output ----
  if (flags & FILTER) {
    for (int j = tid; j < vocab; j += THREADS) filtered_out[off + j] = x[j];
    return;
  }

  // ---- Gumbel top-2 ----
  const uint32_t k0 = (uint32_t)(seed & 0xffffffffull), k1 = (uint32_t)(seed >> 32);
  float v1 = -INFINITY;
  int i1 = 0x7fffffff;
  for (int j = tid; j < vocab; j += THREADS) {
    const float g = (flags & NOISE) ? noise[off + j] : gumbel(philox(j, row, k0, k1));
    better(v1, i1, x[j] + g, j);
  }
  block_argmax(v1, i1, red);
  float v2 = -INFINITY;
  int i2 = 0x7fffffff;
  for (int j = tid; j < vocab; j += THREADS) {
    const float g = (flags & NOISE) ? noise[off + j] : gumbel(philox(j, row, k0, k1));
    better(v2, i2, j == i1 ? -INFINITY : x[j] + g, j);
  }
  block_argmax(v2, i2, red);

  float alt_prob = 0.f;
  if (flags & ALT_PROB) {
    float m2 = -INFINITY;
    for (int j = tid; j < vocab; j += THREADS) m2 = fmaxf(m2, x[j]);
    const float mf = block_max(m2, red);
    float acc = 0.f;
    for (int j = tid; j < vocab; j += THREADS) acc += expf(x[j] - mf);
    const float sf = block_sum(acc, red);
    // singleton kept set: the runner-up is a filtered token, probability 0
    alt_prob = isfinite(v2) ? expf(x[i2] - mf) / sf : 0.f;
  }
  if (tid == 0) {
    next_out[row] = i1;
    alt_out[row] = i2;
    alt_prob_out[row] = alt_prob;
  }
}

}  // namespace

// Largest vocabulary whose f32 row fits the dynamic shared memory of a block.
extern "C" int clipcap_sampler_max_vocab(void) {
  return (232448 - (int)sizeof(Scratch) - 1024) / (int)sizeof(float);
}

// logits [rows, vocab] f32; top_k, top_p, suppress [rows] f32; appears
// [rows, vocab] int8; noise [rows, vocab] f32; outputs [rows]. Pointers a
// flag does not use may be null. Returns the cudaError_t of the launch.
extern "C" int clipcap_fused_sampler(const void* logits, const void* top_k, const void* top_p,
                                     const void* appears, const void* suppress,
                                     const void* noise, void* next_out, void* alt_out,
                                     void* alt_prob_out, void* eos_lp_out, int rows, int vocab,
                                     int flags, int iters, float penalty, float inv_temp,
                                     int eos_id, unsigned long long seed, void* stream) {
  if (rows <= 0 || vocab <= 0 || vocab > clipcap_sampler_max_vocab())
    return (int)cudaErrorInvalidValue;
  const int smem = vocab * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sampler_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sampler_kernel<<<rows, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(top_k),
      static_cast<const float*>(top_p), static_cast<const int8_t*>(appears),
      static_cast<const float*>(suppress), static_cast<const float*>(noise),
      static_cast<int*>(next_out), static_cast<int*>(alt_out),
      static_cast<float*>(alt_prob_out), static_cast<float*>(eos_lp_out), nullptr, vocab,
      flags & ~FILTER, iters, penalty, inv_temp, eos_id, seed);
  return (int)cudaGetLastError();
}

// fused_filter: logits [rows, vocab] f32, top_k, top_p [rows] f32 ->
// filtered_out [rows, vocab] f32. `flags` takes TOPK and TOPP only. Returns
// the cudaError_t of the launch.
extern "C" int clipcap_fused_filter(const void* logits, const void* top_k, const void* top_p,
                                    void* filtered_out, int rows, int vocab, int flags, int iters,
                                    void* stream) {
  if (rows <= 0 || vocab <= 0 || vocab > clipcap_sampler_max_vocab())
    return (int)cudaErrorInvalidValue;
  const int smem = vocab * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sampler_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sampler_kernel<<<rows, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(top_k),
      static_cast<const float*>(top_p), nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, static_cast<float*>(filtered_out), vocab, (flags & (TOPK | TOPP)) | FILTER, iters,
      1.f, 1.f, -1, 0ull);
  return (int)cudaGetLastError();
}
