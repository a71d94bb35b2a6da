// Fused bidirectional multi-head attention for encoder sequences (Hopper, sm_90a).
//
// Replaces the TPU kernel clipcap_tpu/ops/pallas/fused_attention.py
// (fused_attention -> _attn_kernel): softmax(q k^T * dh^-0.5) v over
// [B, T, H, dh] tensors with no mask. Scores and softmax are f32; the output
// has the input dtype (f32 or bf16); no [T, T] score tensor touches device
// memory.
//
// Design: one block of four warps per (64-query tile, head, image); each warp
// owns 16 query rows. Both products run on the tensor cores with mma.sync:
// m16n8k16 bf16 for bf16 inputs, m16n8k8 TF32 for f32 inputs.
//
// f32 inputs take the error-compensated 3xTF32 route (CUTLASS's
// OpMultiplyAddFastF32), never plain TF32: TF32 keeps 11 significant bits,
// which puts score errors near 5e-4 at dh=64, far outside the f32 tolerance.
// Each operand x is split into big = tf32(x) (cvt.rna) and
// small = tf32(x - big), and each product accumulates small*big' +
// big*small' + big*big' in f32; only small*small' (~2^-22 relative) is
// dropped. The rounding is cvt.rna's, done in two integer operations (the
// conversion pipe runs at a fraction of the integer rate), so each warp
// splits its operands in registers as it loads them. The three terms run as
// three passes over the accumulators, so consecutive mma.sync instructions
// are independent and do not wait out each other's latency. bf16 rounds the
// probabilities to bf16 before P.V, as the TPU kernel does
// (probs.astype(v.dtype)).
//
// Scores, the online softmax (base 2: running max, sum, rescale) and the
// output accumulator stay in f32 registers in the mma accumulator layout. P.V
// reads P straight from the score accumulators: for bf16 the accumulator
// layout of two 8-key blocks is the A layout of one 16-key step; for TF32
// the keys of each 8-key step are taken in the order (2t, 2t+1) for the A
// columns (t, t+4), and v's rows are read in the same order, so no shuffle
// is needed. A tile's products stop at its last 8-key block (16 for bf16)
// that holds a key below T, chosen once a tile among unrolled variants;
// keys past T inside it score -inf (and their k and v rows are zero).
// Queries past T are computed from zero rows and not stored.
//
// Memory: q, k, v are strided views (last stride 1, head stride dh, 16-byte
// aligned token and batch strides), so the three slices of the packed qkv
// projection are read in place. Tiles move with 16-byte cp.async copies
// (zero-filled past T) into shared memory whose rows are padded by 16 bytes:
// with a row pitch of 4 words mod 32, the TF32 k and v fragment loads, the
// bf16 32-bit k loads and the ldmatrix.trans v loads hit 32 distinct banks.
// Q's fragments are loaded into registers once. Keys and values move in
// tiles of 32 (f32) or 64 (bf16) tokens, double-buffered past one tile, so
// the next tile's copy overlaps this tile's products. The output goes
// through shared memory and leaves in 16-byte stores.
//
// Bound on the H100: at ViT-B/32 (T=50, dh=64) each (image, head) does
// ~4*T*T*dh flops on 4*T*dh elements, ~12 flops per byte in f32, so device
// memory bounds the function (q, k, v read once, o written once: 39.3 MB at
// B=64, f32). The kernel does not reach that bound: 3xTF32 triples the
// mma.sync work, whose TF32 rate on this card is far below the tensor
// cores' wgmma peak, and a block's first copies overlap no product of its
// own (PERF.md has the measurements). At T <= 64 each element is read once;
// past 64 tokens each extra query tile re-reads k and v (from L2). For long
// bf16 sequences shared memory sets the pace: each warp's 16 rows use every
// k and v fragment it loads once, two shared-memory wavefronts per mma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;  // queries per block: four warps of 16 rows
constexpr int THREADS = 128;

template <typename T, int DH>
struct Tile {
  static constexpr bool F32 = sizeof(T) == 4;
  // keys per tile: at T=50 f32 takes two, so the second one's copy overlaps
  // the first one's products
  static constexpr int KT = F32 ? 32 : 64;
  static constexpr int VEC = 16 / (int)sizeof(T);          // elements in a 16-byte copy
  static constexpr int LD = DH + VEC;                      // padded row pitch, elements
  static constexpr int CH = DH / VEC;                      // 16-byte chunks per row
  static constexpr int QK = F32 ? DH / 8 : DH / 16;        // A-fragment k steps over dh
};

struct Layout {
  long long batch, token;  // element strides
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + rows) of one head into a padded tile; rows past seq are zero
template <typename T, int DH>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long token, int row0,
                                          int rows, int seq) {
  using C = Tile<T, DH>;
  for (int c = threadIdx.x; c < rows * C::CH; c += THREADS) {
    const int r = c / C::CH, x = c % C::CH;
    const bool valid = row0 + r < seq;
    const T* g = src + (valid ? (long long)(row0 + r) * token : 0) + x * C::VEC;
    cp_async16(dst + r * C::LD + x * C::VEC, g, valid);
  }
}

// cvt.rna.tf32.f32 bit for bit (round to nearest, ties away from zero: the
// bits are sign-magnitude), in two full-rate integer operations instead of
// the conversion pipe
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d[i] += a.b_i for N column blocks (3xTF32), with a = ab + as and b_i the
// pair (b[i*step], b[i*step + lo]) read from shared memory and split. One
// pass per term, small terms first: consecutive mma.sync write different
// accumulators, so they overlap instead of each waiting out the previous
// one's latency.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const float* b, int step,
                                           int lo) {
  uint32_t b0[N], b1[N], s0[N], s1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    split(b[i * step], b0[i], s0[i]);
    split(b[i * step + lo], b1[i], s1[i]);
    mma_tf32(d[i], as, b0[i], b1[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, s0[i], s1[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, b0[i], b1[i]);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (g, t4): the lane's row group and column pair in the mma fragment layouts
template <typename T, int DH>
__device__ __forceinline__ void load_q(uint32_t (&qf)[Tile<T, DH>::QK][4], const T* qs, int g,
                                       int t4) {
  constexpr int LD = Tile<T, DH>::LD;
#pragma unroll
  for (int kk = 0; kk < Tile<T, DH>::QK; ++kk) {
    if constexpr (Tile<T, DH>::F32) {  // TF32 A: (g, t) (g+8, t) (g, t+4) (g+8, t+4)
      const float* r = reinterpret_cast<const float*>(qs) + g * LD + kk * 8 + t4;
      qf[kk][0] = __float_as_uint(r[0]);
      qf[kk][1] = __float_as_uint(r[8 * LD]);
      qf[kk][2] = __float_as_uint(r[4]);
      qf[kk][3] = __float_as_uint(r[8 * LD + 4]);
    } else {  // bf16 A: pairs at columns 2t and 2t+8 of rows g and g+8
      const T* r = qs + g * LD + kk * 16 + 2 * t4;
      qf[kk][0] = lds32(r);
      qf[kk][1] = lds32(r + 8 * LD);
      qf[kk][2] = lds32(r + 8);
      qf[kk][3] = lds32(r + 8 * LD + 8);
    }
  }
}

// s[nb] = q . k^T for the tile's keys nb*8 .. nb*8+7, nb < NV; keys past T
// inside those blocks are masked afterwards (a branch on the key count
// inside the unrolled loops schedules worse than the padded products)
template <typename T, int DH, int NV>
__device__ __forceinline__ void scores(float (&s)[NV][4],
                                       const uint32_t (&qf)[Tile<T, DH>::QK][4], const T* kt,
                                       int g, int t4) {
  using C = Tile<T, DH>;
#pragma unroll
  for (int nb = 0; nb < NV; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::QK; ++kk) {
    if constexpr (C::F32) {
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(qf[kk][i]), ab[i], as[i]);
      // B of key block nb: k[key nb*8+g][d t], [d t+4]
      const int off = g * C::LD + kk * 8 + t4;
      mma_3xtf32<NV>(s, ab, as, kt + off, 8 * C::LD, 4);
    } else {
#pragma unroll
      for (int nb = 0; nb < NV; ++nb) {  // B: k[key nb*8+g][d 2t, 2t+1], [+8]
        const T* r = kt + (nb * 8 + g) * C::LD + kk * 16 + 2 * t4;
        mma_bf16(s[nb], qf[kk], lds32(r), lds32(r + 8));
      }
    }
  }
}

// acc += p . v for the tile's first NV key blocks (p = 0 past T) with p in
// the score accumulator layout
template <typename T, int DH, int NV>
__device__ __forceinline__ void pv(float (&acc)[DH / 8][4], const float (&p)[NV][4],
                                   const T* vt, int g, int t4, int lane) {
  using C = Tile<T, DH>;
  if constexpr (C::F32) {
#pragma unroll
    for (int kc = 0; kc < NV; ++kc) {
      // A column t holds key 2t, column t+4 key 2t+1: the accumulator's own pairs
      const float pa[4] = {p[kc][0], p[kc][2], p[kc][1], p[kc][3]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(pa[i], ab[i], as[i]);
      // B of column block d: v[key 2t][d*8+g], v[key 2t+1][d*8+g]; eight blocks a pass
      const int off = (kc * 8 + 2 * t4) * C::LD + g;
#pragma unroll
      for (int d0 = 0; d0 < DH / 8; d0 += 8)
        mma_3xtf32<8>(acc + d0, ab, as, vt + off + d0 * 8, 8, C::LD);
    }
  } else {
    const int m = lane >> 3, r8 = lane & 7;  // ldmatrix: lane gives row r8 of matrix m
#pragma unroll
    for (int kc = 0; kc < NV / 2; ++kc) {
      // probabilities rounded to bf16, as the TPU kernel's probs.astype(v.dtype)
      const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                             pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                             pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                             pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
      // matrices: keys +0/+8 (m & 1) by columns +0/+8 (m >> 1)
      const T* r = vt + (kc * 16 + r8 + (m & 1) * 8) * C::LD + (m >> 1) * 8;
#pragma unroll
      for (int d2 = 0; d2 < DH / 16; ++d2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, r + d2 * 16);
        mma_bf16(acc[2 * d2], a, b[0], b[1]);
        mma_bf16(acc[2 * d2 + 1], a, b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one lane's share of rows g and g+8 of its warp's 16 queries
template <int DH>
struct Running {
  float acc[DH / 8][4];  // unnormalised output, mma accumulator layout
  float m0, m1;          // running max of the scores (base 2)
  float l0, l1;          // this lane's share of the sums
};

// folds one tile of keys into the running softmax and output: its first NV
// key blocks of 8, keys past seq inside them scoring -inf
template <typename T, int DH, int NV>
__device__ __forceinline__ void fold(Running<DH>& st, const uint32_t (&qf)[Tile<T, DH>::QK][4],
                                     const T* kt, const T* vt, int keys, float scale2, int g,
                                     int t4, int lane) {
  float s[NV][4];
  scores<T, DH, NV>(s, qf, kt, g, t4);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < NV; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nb * 8 + 2 * t4 + (e & 1);
      s[nb][e] = key < keys ? s[nb][e] * scale2 : -INFINITY;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
  }
  // finite: every tile starts below seq; the first tile's correction is exp2(-inf) = 0
  const float n0 = fmaxf(st.m0, quad_max(mx0)), n1 = fmaxf(st.m1, quad_max(mx1));
  const float c0 = exp2f(st.m0 - n0), c1 = exp2f(st.m1 - n1);
  st.m0 = n0;
  st.m1 = n1;
  st.l0 *= c0;
  st.l1 *= c1;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    st.acc[d][0] *= c0;
    st.acc[d][1] *= c0;
    st.acc[d][2] *= c1;
    st.acc[d][3] *= c1;
  }
#pragma unroll
  for (int nb = 0; nb < NV; ++nb) {  // masked keys: exp2(-inf) = 0
    s[nb][0] = exp2f(s[nb][0] - n0);
    s[nb][1] = exp2f(s[nb][1] - n0);
    s[nb][2] = exp2f(s[nb][2] - n1);
    s[nb][3] = exp2f(s[nb][3] - n1);
    st.l0 += s[nb][0] + s[nb][1];
    st.l1 += s[nb][2] + s[nb][3];
  }
  pv<T, DH, NV>(st.acc, s, vt, g, t4, lane);
}

// fold<NV'> with NV' = nv, taken from NV, NV - step, ... (step 2 for bf16,
// whose P.V takes 16 keys a step): one branch a tile, none in the products
template <typename T, int DH, int NV>
__device__ __forceinline__ void fold_tile(int nv, Running<DH>& st,
                                          const uint32_t (&qf)[Tile<T, DH>::QK][4], const T* kt,
                                          const T* vt, int keys, float scale2, int g, int t4,
                                          int lane) {
  constexpr int STEP = Tile<T, DH>::F32 ? 1 : 2;
  if constexpr (NV > STEP) {
    if (nv < NV) {
      fold_tile<T, DH, NV - STEP>(nv, st, qf, kt, vt, keys, scale2, g, t4, lane);
      return;
    }
  }
  fold<T, DH, NV>(st, qf, kt, vt, keys, scale2, g, t4, lane);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, Layout lq, Layout lk, Layout lv, int seq, int heads,
            float scale) {
  using C = Tile<T, DH>;
  constexpr int KT = C::KT, LD = C::LD, NB = KT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntiles = (seq + KT - 1) / KT;
  const int stages = ntiles > 1 ? 2 : 1;
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + ROWS * LD;
  T* vs = ks + stages * KT * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const T* qb = q + b * lq.batch + (long long)h * DH;
  const T* kb = k + b * lk.batch + (long long)h * DH;
  const T* vb = v + b * lv.batch + (long long)h * DH;
  const float scale2 = scale * 1.4426950408889634f;  // softmax in base 2

  load_rows<T, DH>(qs, qb, lq.token, q0, ROWS, seq);
  load_rows<T, DH>(ks, kb, lk.token, 0, KT, seq);
  load_rows<T, DH>(vs, vb, lv.token, 0, KT, seq);
  cp_async_commit();

  uint32_t qf[C::QK][4];
  Running<DH> st;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) st.acc[d][0] = st.acc[d][1] = st.acc[d][2] = st.acc[d][3] = 0.f;
  st.m0 = st.m1 = -INFINITY;
  st.l0 = st.l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int keys = min(KT, seq - it * KT);
    if (it + 1 < ntiles) {  // the other buffer was consumed before the last barrier
      const int nxt = ((it + 1) & 1) * KT * LD;
      load_rows<T, DH>(ks + nxt, kb, lk.token, (it + 1) * KT, KT, seq);
      load_rows<T, DH>(vs + nxt, vb, lv.token, (it + 1) * KT, KT, seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) load_q<T, DH>(qf, qs + wr * LD, g, t4);
    const T* kt = ks + (it & 1) * KT * LD;
    const T* vt = vs + (it & 1) * KT * LD;

    // the products skip the tile's key blocks that hold no key below seq
    // (at T=50 in f32, 8 of the 64 padded keys)
    const int nv = C::F32 ? (keys + 7) / 8 : (keys + 15) / 16 * 2;
    fold_tile<T, DH, NB>(nv, st, qf, kt, vt, keys, scale2, g, t4, lane);
    __syncthreads();
  }

  // normalise into the q tile (every warp is past the loop's last barrier),
  // then 16-byte stores of the rows below seq into contiguous [B, T, H, dh]
  const float i0 = 1.f / quad_sum(st.l0), i1 = 1.f / quad_sum(st.l1);
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    T* r = qs + (wr + g) * LD + d * 8 + 2 * t4;
    store_pair(r, st.acc[d][0] * i0, st.acc[d][1] * i0);
    store_pair(r + 8 * LD, st.acc[d][2] * i1, st.acc[d][3] * i1);
  }
  __syncthreads();
  T* ob = o + ((long long)b * seq * heads + h) * DH;
  for (int c = threadIdx.x; c < ROWS * C::CH; c += THREADS) {
    const int r = c / C::CH, x = c % C::CH;
    if (q0 + r < seq)
      *reinterpret_cast<int4*>(ob + (long long)(q0 + r) * heads * DH + x * C::VEC) =
          *reinterpret_cast<const int4*>(qs + r * LD + x * C::VEC);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, Layout lq, Layout lk,
           Layout lv, int batch, int seq, int heads, float scale, cudaStream_t stream) {
  using C = Tile<T, DH>;
  auto ok = [](Layout l) { return l.batch % C::VEC == 0 && l.token % C::VEC == 0; };
  if (!ok(lq) || !ok(lk) || !ok(lv) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (seq + C::KT - 1) / C::KT;
  const int stages = ntiles > 1 ? 2 : 1;
  const int smem = (ROWS + 2 * stages * C::KT) * C::LD * (int)sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((seq + ROWS - 1) / ROWS, heads, batch);
  attn_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, lv, seq, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [batch, seq, heads, head_dim] views with last stride 1, head stride
// head_dim and the given batch and token strides (elements, multiples of 16
// bytes); o: contiguous [batch, seq, heads, head_dim]. dtype 0 = f32, 1 = bf16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int clipcap_fused_attention(const void* q, const void* k, const void* v, void* o,
                                       int batch, int seq, int heads, int head_dim,
                                       int dtype, float scale, long long q_batch,
                                       long long q_token, long long k_batch, long long k_token,
                                       long long v_batch, long long v_token, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout lq{q_batch, q_token}, lk{k_batch, k_token}, lv{v_batch, v_token};
  if (head_dim == 64) {
    if (dtype == 0) return launch<float, 64>(q, k, v, o, lq, lk, lv, batch, seq, heads, scale, s);
    return launch<__nv_bfloat16, 64>(q, k, v, o, lq, lk, lv, batch, seq, heads, scale, s);
  }
  if (head_dim == 128) {
    if (dtype == 0) return launch<float, 128>(q, k, v, o, lq, lk, lv, batch, seq, heads, scale, s);
    return launch<__nv_bfloat16, 128>(q, k, v, o, lq, lk, lv, batch, seq, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
