// Device code shared by gmh_attention.cu and gmh_scores.cu: asynchronous
// copies into shared memory, the register-tiled f32 product and the head
// score stage (f32 FMAs, or bf16 mma.sync tiles with f32 accumulators, then
// tanh, head mean and the symmetrised channels-last store).
//
// The score stage, per graph and channel:
//   S[n, m]   = (1/H) sum_h tanh(s_h[n, m] / score_div)
//   s_h[n, m] = sum_{d < ds} Q[n, h*ds + d] K[m, h*ds + d]
//   out[n, m] = (S[n, m] + S[m, n]) / 2, written channels-last
// score_div is sqrt(F_out) of the layer; tanhf is the accurate one, and no
// product uses TF32.
//
// Bank conflicts.  Rows are padded, not swizzled:
//  * a matrix whose rows are spread over the threads of a warp and written
//    by threads (the left operand of a product, the raw head sums) has an
//    odd row stride in floats, so the distinct rows a warp reads at one
//    column fall in distinct banks; the right operand of a product is read
//    along a row, consecutive threads on consecutive columns;
//  * a matrix copied in 16-byte pieces and read the same way (f32 Q and K,
//    the adjacency) has a row stride of 4 mod 8 floats (ld4): up to eight
//    rows at one column fall in distinct banks;
//  * Q and K read as bf16 mma operands (8-byte loads, four rows a
//    half-warp) have a row stride of 8 mod 16 floats (ld8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gmh {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__host__ __device__ constexpr int odd(int n) { return n | 1; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Row stride (floats) of a matrix copied in 16-byte pieces whose rows are
// spread over the threads of a warp: the least ld >= n with ld % 8 == 4, so
// rows r = 0..7 start 4 r banks apart (mod 32): up to eight distinct rows
// read at one column fall in distinct banks.
__host__ __device__ constexpr int ld4(int n) { return n + ((12 - n % 8) % 8); }

// Row stride (floats) of Q and K read as bf16 mma fragments: the least
// ld >= n with ld % 16 == 8, so the four rows of a half-warp's 8-byte loads
// start 8 banks apart.
__host__ __device__ constexpr int ld8(int n) { return n + ((24 - n % 16) % 16); }

// Row stride (floats) of one head's raw sums of an N x N map.
__host__ __device__ constexpr int map_ld(int N) { return odd(N); }

// Stage ablation, for scripts/gmh_stage_times.py: a build with
// -DGMH_ABLATE=<mask of the stages below> puts a zero fill of the buffer a
// masked stage writes in its place (the store: nothing), so that the stages
// after it see finite values; kLoads (gmh_projection and the tile-pair
// stage) zero-fills the ring of their copies once, in place of the copies.
// In the tile-pair stage kHeadSums removes the products and the tanh (the
// maps get zeros).  The default, 0, removes nothing.
#ifndef GMH_ABLATE
#define GMH_ABLATE 0
#endif
enum Stage : unsigned { kNormX = 1, kProjection = 2, kHeadSums = 4, kStore = 8, kLoads = 16 };
__device__ constexpr bool ablated(Stage s) { return (GMH_ABLATE & s) != 0; }

__device__ __forceinline__ void zero_fill(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// ------------------------------------------------------ asynchronous copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// dst[r * ldd + c] <- src[r * srow + c * scol] for r < rows, c < cols, by all
// threads of the block, not committed: 16-byte copies where the rows are
// dense and both sides 16-byte aligned, else 4-byte copies.
__device__ __forceinline__ void copy_tile_async(float* dst, int ldd, const float* src,
                                                long long srow, long long scol,
                                                int rows, int cols) {
  const bool vec = scol == 1 && (cols & 3) == 0 && (ldd & 3) == 0 && (srow & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec) {
    const int cv = cols >> 2;
    for (int i = threadIdx.x; i < rows * cv; i += blockDim.x) {
      const int r = i / cv, c = (i - r * cv) << 2;
      cp_async16(dst + r * ldd + c, src + r * srow + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      cp_async4(dst + r * ldd + c, src + r * srow + c * scol);
    }
  }
}

// ------------------------------------------------------- element types
//
// The one-block forward kernels (N <= 64) take their tensors in f32 or, all
// of one call, in bf16 (the JAX package's bf16 score networks).  A bf16
// value is widened to f32 as it is staged, exactly, so the shared layouts,
// every sum and every rounding point are those of the f32 kernel; each
// output is rounded to bf16 (nearest, ties to even) once, as it is stored.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// copy_tile_async for T = float (not committed); for bf16, plain 2-byte
// loads by all threads of the block (consecutive threads on consecutive
// columns), widened into dst: visible to the block after its next barrier.
template <typename T>
__device__ __forceinline__ void copy_tile(float* dst, int ldd, const T* src, long long srow,
                                          long long scol, int rows, int cols) {
  if constexpr (std::is_same<T, float>::value) {
    copy_tile_async(dst, ldd, src, srow, scol, rows, cols);
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ldd + c] = to_f32(src[r * srow + c * scol]);
    }
  }
}

// Four consecutive outputs p[0..3] in one store (16 bytes of f32, 8 of
// bf16); p aligned to it.
__device__ __forceinline__ void store_run4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_run4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned*>(&lo);
  w.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// ------------------------------------------------------------ f32 products

// out = A (M x K) B (K x Ncol) with A[r * lda + k] and B[k * ldb + c], by
// all threads of the block in TM x TN register patches.  A thread owns rows
// pm + i * RT and columns pn + j * CT (RT, CT: patches down and across), so
// the threads of a warp read B on consecutive columns and A on distinct
// rows (distinct banks for an odd lda); each k costs TM + TN shared loads
// for TM * TN FMAs.  epi(r, c, value) receives every output once.
template <int TM, int TN, typename Epi>
__device__ __forceinline__ void tiled_product(const float* __restrict__ A, int lda,
                                              const float* __restrict__ B, int ldb,
                                              int M, int Ncol, int K, Epi epi) {
  const int RT = cdiv(M, TM), CT = cdiv(Ncol, TN);
  for (int p = threadIdx.x; p < RT * CT; p += blockDim.x) {
    const int pm = p / CT, pn = p - pm * CT;
    int ra[TM], cb[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) ra[i] = min(pm + i * RT, M - 1) * lda;
#pragma unroll
    for (int j = 0; j < TN; ++j) cb[j] = min(pn + j * CT, Ncol - 1);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = A[ra[i] + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = B[k * ldb + cb[j]];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = pm + i * RT;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = pn + j * CT;
        if (c < Ncol) epi(r, c, acc[i][j]);
      }
    }
  }
}

// The same product with 16-byte shared loads, for A and B whose rows are
// 16-byte aligned (lda, ldb multiples of 4) and Ncol a multiple of 4: a
// thread owns rows pm + i * RT and the four columns 4 pn.., reads four k of
// an A row and four columns of a B row per load, and keeps the FMAs of
// each output in k order.  Four k cost TM + 4 loads for 16 TM FMAs.
template <int TM, typename Epi>
__device__ __forceinline__ void tiled_product4(const float* __restrict__ A, int lda,
                                               const float* __restrict__ B, int ldb,
                                               int M, int Ncol, int K, Epi epi) {
  const int RT = cdiv(M, TM), CT = Ncol / 4;
  for (int p = threadIdx.x; p < RT * CT; p += blockDim.x) {
    const int pm = p / CT, c0 = 4 * (p - pm * CT);
    int ra[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ra[i] = min(pm + i * RT, M - 1) * lda;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      float4 b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) b[u] = *reinterpret_cast<const float4*>(B + (k + u) * ldb + c0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + ra[i] + k);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][0] = fmaf(av[u], b[u].x, acc[i][0]);
          acc[i][1] = fmaf(av[u], b[u].y, acc[i][1]);
          acc[i][2] = fmaf(av[u], b[u].z, acc[i][2]);
          acc[i][3] = fmaf(av[u], b[u].w, acc[i][3]);
        }
      }
    }
    for (; k < K; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + c0);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = A[ra[i] + k];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = pm + i * RT;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(r, c0 + j, acc[i][j]);
    }
  }
}

// --------------------------------------------------------- the score stage
//
// Two steps.  The head sums s_h[n, m] of a channel go to shared memory as
// "raw sums" R[h * raw_plane(N) + n * map_ld(N) + m]: from f32 FMAs, or from
// bf16 tensor-core tiles rounded to bf16.  Then store_pairs takes the tanh,
// the head mean and the symmetrisation of each pair n <= m once, for the
// block's channels, and writes both (n, m) and (m, n) channels-last.  The
// scale by 1/score_div is a multiplication by its f32 reciprocal (within two
// f32 ulps of the division, in the argument of tanh).

__host__ __device__ constexpr int raw_plane(int N) { return N * map_ld(N); }

// Patches of one channel's raw sums in f32, TM x TN outputs each.
template <int TM, int TN>
__host__ __device__ constexpr int sum_patches(int N) { return cdiv(N, TM) * cdiv(N, TN); }

// Patch p of head h of one channel's raw sums, f32 products: rows
// pm + i * RT and columns pn + j * CT, as tiled_product owns them.  Each d
// costs TM + TN shared loads for TM * TN FMAs; with 16-byte rows (ld a
// multiple of 4, ld4 for no conflicts) and ds a multiple of 4, each load
// brings four d.
template <int TM, int TN>
__device__ __forceinline__ void sum_patch_f32(int p, int h, const float* __restrict__ Q,
                                              const float* __restrict__ K, int ld,
                                              float* __restrict__ R, int N, int ds) {
  const int RT = cdiv(N, TM), CT = cdiv(N, TN);
  const int pm = p / CT, pn = p - pm * CT;
  const int ldr = map_ld(N);
  int rq[TM], rk[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) rq[i] = min(pm + i * RT, N - 1) * ld;
#pragma unroll
  for (int j = 0; j < TN; ++j) rk[j] = min(pn + j * CT, N - 1) * ld;
  float s[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
  int d = h * ds;
  if ((ds & 3) == 0 && (ld & 3) == 0)  // 16-byte loads of four d, in d order
    for (; d < (h + 1) * ds; d += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(Q + rq[i] + d);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(K + rk[j] + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
  for (; d < (h + 1) * ds; ++d) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = Q[rq[i] + d];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = K[rk[j] + d];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
  R += h * raw_plane(N);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = pm + i * RT;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = pn + j * CT;
      if (n < N && m < N) R[n * ldr + m] = s[i][j];
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const unsigned*>(&v);
}

// Columns kk, kk + 1 of head h of row r of f32 Q or K, rounded to bf16 and
// packed as one mma operand register; columns past the head are zero.
__device__ __forceinline__ unsigned bf16_pair(const float* __restrict__ X, int ld, int r,
                                              int h, int kk, int ds) {
  const float* p = X + r * ld + h * ds + kk;
  if ((ds & 1) == 0) {  // kk is even: both columns in the head or neither
    if (kk >= ds) return 0u;
    const float2 v = *reinterpret_cast<const float2*>(p);
    return pack_bf16(v.x, v.y);
  }
  return pack_bf16(kk < ds ? p[0] : 0.f, kk + 1 < ds ? p[1] : 0.f);
}

// Rows 16 nt.. of head h of one channel's raw sums, all N columns, bf16
// products, by one warp: one A operand (Q rows) per k step feeds the
// ceil(N / 8) <= kMaxColTiles 16 x 8 tiles of the strip.  s_h comes from
// mma.sync m16n8k8 (bf16 inputs, f32 accumulators), one k step per 8
// columns of the head, and is rounded to bf16 once.  The operands are read
// from the f32 Q and K (row stride ld, ld % 16 == 8) and rounded to bf16 as
// they are packed: lane (g = lane / 4, t = lane % 4) holds A rows g and
// g + 8, B row g, at columns 2 t and 2 t + 1 of the k step, and accumulator
// i at row g + 8 (i / 2), column 2 t + (i % 2).  Rows past N read row N - 1
// (their sums are never stored; an mma row or column only reaches its own
// outputs); columns past the head are zero.
constexpr int kMaxColTiles = 8;  // N <= 64

__device__ __forceinline__ void sum_strip_bf16(int nt, int h, const float* __restrict__ Q,
                                               const float* __restrict__ K, int ld,
                                               float* __restrict__ R, int N, int ds) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ldr = map_ld(N), tm = cdiv(N, 8);
  const int ra = min(nt * 16 + g, N - 1), rb = min(nt * 16 + g + 8, N - 1);
  float c[kMaxColTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxColTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
  for (int k0 = 0; k0 < ds; k0 += 8) {
    const int kk = k0 + 2 * t;
    const unsigned a0 = bf16_pair(Q, ld, ra, h, kk, ds);
    const unsigned a1 = bf16_pair(Q, ld, rb, h, kk, ds);
#pragma unroll
    for (int j = 0; j < kMaxColTiles; ++j) {
      if (j >= tm) break;
      const unsigned b0 = bf16_pair(K, ld, min(j * 8 + g, N - 1), h, kk, ds);
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a0), "r"(a1), "r"(b0));
    }
  }
  R += h * raw_plane(N);
#pragma unroll
  for (int j = 0; j < kMaxColTiles; ++j) {
    if (j >= tm) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = nt * 16 + g + 8 * (i >> 1), m = j * 8 + 2 * t + (i & 1);
      if (n < N && m < N) R[n * ldr + m] = __bfloat162float(__float2bfloat16_rn(c[j][i]));
    }
  }
}

// Pairs n <= m of an N x N map, folded so that no item is idle: fold f holds
// row f (m >= f) and row N - 1 - f (m >= N - 1 - f), N + 1 items; the middle
// row of an odd N is taken once.
__host__ __device__ constexpr int pair_items(int N) { return ((N + 1) / 2) * (N + 1); }

__device__ __forceinline__ bool pair_of(int i, int N, int& n, int& m) {
  const int f = i / (N + 1), j = i - f * (N + 1);
  if (j < N - f) {
    n = f;
    m = f + j;
    return true;
  }
  n = N - 1 - f;
  m = n + (j - (N - f));
  return n != f;
}

// For the block's G channels (raw sums of channel g at R + g * rstride):
//   S_g[n, m] = (1/H) sum_h tanh(s_h[n, m] / score_div)
//   out[(n N + m) C + g] = out[(m N + n) C + g] = (S_g[n, m] + S_g[m, n]) / 2
// with out pointing at (graph, 0, 0, first channel).  One pair n <= m a
// thread: the tanh of both entries is taken once, and both outputs are
// written for the group's channels as runs of four-channel stores where
// they allow (with G = C, C consecutive outputs); T is the output's type
// (bf16: each output rounded once, both directions the same bits).
template <typename T>
__device__ __forceinline__ void store_pairs(T* __restrict__ out,
                                            const float* __restrict__ R, int rstride,
                                            int N, int C, int G, int H, float score_div) {
  const int ldr = map_ld(N), rp = raw_plane(N);
  const float inv = 1.0f / score_div, fh = static_cast<float>(H);
  const bool vec = (G & 3) == 0 && (C & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & (4 * sizeof(T) - 1)) == 0;
  for (int i = threadIdx.x; i < pair_items(N); i += blockDim.x) {
    int n, m;
    if (!pair_of(i, N, n, m)) continue;
    T* o1 = out + static_cast<long long>(n * N + m) * C;
    T* o2 = out + static_cast<long long>(m * N + n) * C;
    for (int g0 = 0; g0 < G; g0 += 4) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (g0 + u >= G) break;
        const float* r = R + (g0 + u) * rstride;
        float a = 0.f, b = 0.f;
        for (int h = 0; h < H; ++h) {
          a += tanhf(r[h * rp + n * ldr + m] * inv);
          b += tanhf(r[h * rp + m * ldr + n] * inv);
        }
        v[u] = (a / fh + b / fh) * 0.5f;
      }
      if (vec) {
        store_run4(o1 + g0, v);
        store_run4(o2 + g0, v);
      } else {
        for (int u = 0; u < 4 && g0 + u < G; ++u) o1[g0 + u] = o2[g0 + u] = from_f32<T>(v[u]);
      }
    }
  }
}

// -------------------------------------------- tiled scores (N > 64)
//
// A graph whose Q, K and N x N head sums do not fit one block (N > 64: at
// grid's N = 361 the sums of one head alone are 521 KB against 227 KB) is
// cut into tiles of kTile rows.  A block takes one tile pair (I, J), I <= J,
// of one graph for a group of G <= kMaxGroup channels; the pairs come from
// the wrapper's plan (pairs[2 p], pairs[2 p + 1] = I, J), which covers
// every pair once.  For each entry (n, m), n in I and m in J, the block
// takes both directions of every head,
//   a = sum_h tanh(s_h(Q_n, K_m) / score_div)
//   b = sum_h tanh(s_h(Q_m, K_n) / score_div)
// in the same thread, and writes out[n, m, g] = out[m, n, g] = (a / H +
// b / H) / 2: the map is exactly symmetric.  A diagonal pair (I == J)
// takes each entry n <= m once and writes it both ways.  The rounding
// points of the one-block stage are kept: f32 (FMAs in d order, tanhf, the
// head sums in h order, then (a 1/H + b 1/H) 1/2: the maps of the T-plane
// design this one replaced, bit for bit; scripts/gmh_stage_times.py
// --parent checks it), or (kBf16) Q and K rounded to bf16 as they are
// packed into mma operands (cvt.rn.bf16x2.f32), the products of a head on
// the tensor cores (mma.sync m16n8k8, bf16 in, f32 sums; a head of ds <= 8
// is one k-step, columns past it zero), each s_h rounded to bf16 once, its
// tanh (tanh_bf16_path, within 6e-7 of tanh) and the head sums in f32.
//
// Work of a block, 256 threads: warp w takes the 16 x 8 sub-tile of rows
// 16 (w / 4).. of I and columns 8 (w % 4).. of J, lane (g, t) = (lane / 4,
// lane % 4) its entries n = g, g + 8 and m = 2t, 2t + 1 of it: the
// accumulator layout of an m16n8k8 mma, whose two products a head are
// Q_I K_J^T and K_I Q_J^T (s_h(Q_m, K_n) = s_h(K_n, Q_m)), so a lane holds
// both directions of its four entries.  f32 takes the same entries with
// 16-byte shared loads of four d: each 4 d of a head cost eight loads (the
// rows of a warp's lanes are eight and four distinct rows, conflict-free)
// for 32 FMAs.  Four heads of width 8 (every tiled config) have a
// specialised body (kDs8): the heads unrolled, no k-loop, no bounds on the
// operand loads.  A lane leaves its
// entries' values of each channel in its warp's staging (an entry's G
// values side by side), so that after the last channel the warp stores
// its 16 x 8 entries as runs of the G channels (16 bytes an entry at
// G = 4), consecutive lanes on consecutive entries along a row of the
// (n, m) side and along a column (a row of the (m, n) side), the kept
// entries only.  G is at most kMaxGroup = 4: blocks of eight channels (an
// entry a 32-byte sector) were slower (PERF.md §6), their tail longer.
// The channel loop is not unrolled: unrolled, with the values in
// registers, it made the bf16 kernel several times its size, and slower.
// A warp whose sub-tile holds no entry (past a ragged tile's end, or below
// the diagonal of a diagonal pair) skips the channel's work; within a warp
// that has one, every lane takes its four entries (a lane left out of a
// step saves no issue slot: the warp issues it for the others), and only
// the kept ones are stored.
//
// Shared layout (floats): a ring of two stages of [Q_I | K_I | Q_J | K_J]
// of one channel, kTile rows of ld each (ld8(A) for bf16 fragments, ld4(A)
// for 16-byte f32 loads; channel g + 1 is copied while g is computed), then
// each warp's staging, kWarpEntries x kMaxGroup floats.  56 KB (bf16) or
// 52 KB (f32) at attn 32: three blocks an SM, as the registers allow.

constexpr int kTile = 32;          // rows of a tile
constexpr int kMaxGroup = 4;       // channels of a block
constexpr int kStages = 2;         // channels in the ring
constexpr int kWarpEntries = 128;  // entries of a warp's 16 x 8 sub-tile

__host__ __device__ constexpr int tile_ld(int A, bool bf16) { return bf16 ? ld8(A) : ld4(A); }

// Shared bytes of a block of G channels (past kMaxGroup, more than a block
// may use, so that a wrapper's fit test turns it down).
template <bool kBf16>
__host__ __device__ constexpr int tiled_scores_smem(int A, int G) {
  return G > kMaxGroup ? kMaxSmem + 1
                       : static_cast<int>(sizeof(float)) *
                             (kStages * 4 * kTile * tile_ld(A, kBf16) +
                              (kThreads / 32) * kWarpEntries * kMaxGroup);
}

// tanh(s / score_div) of the bf16 path, c = -2 log2(e) / score_div:
// 2 / (1 + e^{-2|x|}) - 1 with s's sign, from the approximate exp2 and
// reciprocal (two multi-function-unit operations and four others, no
// branch).  Its error against tanh is below 6e-7 absolute, under a 2^-9
// relative rounding of the head sum the path makes first; the f32 path
// keeps tanhf.
__device__ __forceinline__ float tanh_bf16_path(float s, float c) {
  float t, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(t) : "f"(c * fabsf(s)));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.0f + t));
  return copysignf(fmaf(2.0f, r, -1.0f), s);
}

// The f32 value rounded to the nearest bf16 (ties to even), as an f32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The mma operand of columns off, off + 1 of a row, rounded to bf16.
__device__ __forceinline__ unsigned bf16_frag(const float* row, int off) {
  const float2 v = *reinterpret_cast<const float2*>(row + off);
  return pack_bf16(v.x, v.y);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// The rows a lane reads: qn[i], kn[i] of its entries' n (f32) or of the
// fragment's A rows g, g + 8 (bf16); qm[j], km[j] of its entries' m (f32)
// or of the fragment's B row g (bf16, j = 0).
struct LaneRows {
  const float *qn[2], *kn[2], *qm[2], *km[2];
};

// s1[i][j] = s_h(Q_n_i, K_m_j) and s2[i][j] = s_h(Q_m_j, K_n_i) of a lane's
// entries.
template <bool kBf16, bool kDs8>
__device__ __forceinline__ void head_sums(const LaneRows& R, int h, int ds, float (&s1)[2][2],
                                          float (&s2)[2][2]) {
  if constexpr (kBf16) {
    const int t = threadIdx.x & 3;
    float d1[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kDs8) {
      const int off = h * 8 + 2 * t;
      mma_bf16(d1, bf16_frag(R.qn[0], off), bf16_frag(R.qn[1], off), bf16_frag(R.km[0], off));
      mma_bf16(d2, bf16_frag(R.kn[0], off), bf16_frag(R.kn[1], off), bf16_frag(R.qm[0], off));
    } else {
      for (int k0 = 0; k0 < ds; k0 += 8) {
        const int kk = k0 + 2 * t;
        mma_bf16(d1, bf16_pair(R.qn[0], 0, 0, h, kk, ds), bf16_pair(R.qn[1], 0, 0, h, kk, ds),
                 bf16_pair(R.km[0], 0, 0, h, kk, ds));
        mma_bf16(d2, bf16_pair(R.kn[0], 0, 0, h, kk, ds), bf16_pair(R.kn[1], 0, 0, h, kk, ds),
                 bf16_pair(R.qm[0], 0, 0, h, kk, ds));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s1[i][j] = bf16_round(d1[2 * i + j]);
        s2[i][j] = bf16_round(d2[2 * i + j]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s1[i][j] = s2[i][j] = 0.f;
    auto step = [&](int d) {  // four d, each sum's FMAs in d order
      float4 qn[2], kn[2], qm[2], km[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qn[i] = *reinterpret_cast<const float4*>(R.qn[i] + d);
        kn[i] = *reinterpret_cast<const float4*>(R.kn[i] + d);
        qm[i] = *reinterpret_cast<const float4*>(R.qm[i] + d);
        km[i] = *reinterpret_cast<const float4*>(R.km[i] + d);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s1[i][j] = fmaf(qn[i].x, km[j].x, s1[i][j]);
          s1[i][j] = fmaf(qn[i].y, km[j].y, s1[i][j]);
          s1[i][j] = fmaf(qn[i].z, km[j].z, s1[i][j]);
          s1[i][j] = fmaf(qn[i].w, km[j].w, s1[i][j]);
          s2[i][j] = fmaf(qm[j].x, kn[i].x, s2[i][j]);
          s2[i][j] = fmaf(qm[j].y, kn[i].y, s2[i][j]);
          s2[i][j] = fmaf(qm[j].z, kn[i].z, s2[i][j]);
          s2[i][j] = fmaf(qm[j].w, kn[i].w, s2[i][j]);
        }
    };
    if constexpr (kDs8) {
      step(h * 8);
      step(h * 8 + 4);
    } else {
      int d = h * ds;
      if ((ds & 3) == 0)
        for (; d < (h + 1) * ds; d += 4) step(d);
      for (; d < (h + 1) * ds; ++d)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s1[i][j] = fmaf(R.qn[i][d], R.km[j][d], s1[i][j]);
            s2[i][j] = fmaf(R.qm[j][d], R.kn[i][d], s2[i][j]);
          }
    }
  }
}

// pairs: the plan, (I, J) of every pair; grid (pairs, channel groups, B).
// q, k: (B, C, N, A) in strides (b, c, n), the feature stride 1.
template <bool kBf16, bool kDs8>
__global__ void __launch_bounds__(kThreads, 3)
tiled_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const int* __restrict__ pairs, float* __restrict__ out, int C, int N,
                    int A, int H, int ds, int G, long long qsb, long long qsc, long long qsn,
                    long long ksb, long long ksc, long long ksn, float score_div) {
  extern __shared__ __align__(16) float smem[];
  const int ld = tile_ld(A, kBf16), mat = kTile * ld, stride = 4 * mat;
  const int I = pairs[2 * blockIdx.x], J = pairs[2 * blockIdx.x + 1];
  const bool diag = I == J;
  const int I0 = I * kTile, J0 = J * kTile;
  const int nI = min(kTile, N - I0), nJ = min(kTile, N - J0);
  const int b = blockIdx.z, c0 = blockIdx.y * G;
  const int nch = min(G, C - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  float* stg = smem + kStages * stride + warp * kWarpEntries * kMaxGroup;  // [entry][channel]

  // stage s holds Q_I, K_I at 0, mat and Q_J, K_J at 2 mat, 3 mat.  Where
  // the rows take 16-byte copies, a thread copies piece pc of rows pr,
  // pr + pstep, .. of each matrix (one division a thread, not one a piece)
  const int cv = A >> 2;
  const bool vec16 = (A & 3) == 0 && ((qsn | ksn | qsb | ksb | qsc | ksc) & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)) & 15) ==
                         0 &&
                     kThreads % cv == 0;
  const int pr = vec16 ? threadIdx.x / cv : 0, pc = vec16 ? 4 * (threadIdx.x - pr * cv) : 0;
  const int pstep = vec16 ? kThreads / cv : 0;
  auto copy = [&](float* dst, const float* src, long long sn, int rows) {
    if (vec16) {
      for (int r = pr; r < rows; r += pstep) cp_async16(dst + r * ld + pc, src + r * sn + pc);
    } else {
      copy_tile_async(dst, ld, src, sn, 1, rows, A);
    }
  };
  auto stage = [&](int g) {
    if (ablated(kLoads) || g >= nch) return;
    float* dst = smem + (g & 1) * stride;
    const float* qc = q + b * qsb + (c0 + g) * qsc;
    const float* kc = k + b * ksb + (c0 + g) * ksc;
    copy(dst, qc + I0 * qsn, qsn, nI);
    copy(dst + mat, kc + I0 * ksn, ksn, nI);
    if (!diag) {
      copy(dst + 2 * mat, qc + J0 * qsn, qsn, nJ);
      copy(dst + 3 * mat, kc + J0 * ksn, ksn, nJ);
    }
  };
  if (ablated(kLoads)) zero_fill(smem, kStages * stride);

  const int n0 = 16 * (warp >> 2), m0 = 8 * (warp & 3);  // the warp's sub-tile
  const bool active = n0 < nI && m0 < nJ && (!diag || n0 <= m0 + 7);
  // the lane's entries (n0 + g8 + 8 i, m0 + 2 t4 + j); rows past a ragged
  // tile's end read its last row (never stored)
  const int nJc = diag ? nI : nJ;
  int rn[2], rm[2];
  rn[0] = min(n0 + g8, nI - 1) * ld;
  rn[1] = min(n0 + g8 + 8, nI - 1) * ld;
  if constexpr (kBf16) {  // the fragments' rows: A rows g, g + 8; B row g
    rm[0] = rm[1] = min(m0 + g8, nJc - 1) * ld;
  } else {  // the lane's own entries' rows
    rm[0] = min(m0 + 2 * t4, nJc - 1) * ld;
    rm[1] = min(m0 + 2 * t4 + 1, nJc - 1) * ld;
  }
  const float inv = 1.0f / score_div, ih = 1.0f / static_cast<float>(H);
  const float c2 = -2.8853900817779268f * inv;  // tanh_bf16_path's

  stage(0);
  cp_async_commit();
  for (int g = 0; g < nch; ++g) {
    stage(g + 1);  // into the stage channel g - 1 held
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // channel g landed
    const float* cur = smem + (g & 1) * stride;
    const float* Qm = diag ? cur : cur + 2 * mat;
    const float* Km = diag ? cur + mat : cur + 3 * mat;
    const LaneRows R = {{cur + rn[0], cur + rn[1]}, {cur + mat + rn[0], cur + mat + rn[1]},
                        {Qm + rm[0], Qm + rm[1]}, {Km + rm[0], Km + rm[1]}};
    if (active) {
      // every lane of a warp with a kept entry takes the tanh of its four
      // (a lane of a warp issues with the others; entries not kept are
      // not stored)
      float a[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, bsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      auto head = [&](int h) {
        float s1[2][2], s2[2][2];
        head_sums<kBf16, kDs8>(R, h, ds, s1, s2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if constexpr (kBf16) {
              a[i][j] += tanh_bf16_path(s1[i][j], c2);
              bsum[i][j] += tanh_bf16_path(s2[i][j], c2);
            } else {
              a[i][j] += tanhf(s1[i][j] * inv);
              bsum[i][j] += tanhf(s2[i][j] * inv);
            }
          }
      };
      if (!ablated(kHeadSums)) {
        if constexpr (kDs8) {  // four heads of width 8: unrolled, fixed offsets
#pragma unroll
          for (int h = 0; h < 4; ++h) head(h);
        } else {
          for (int h = 0; h < H; ++h) head(h);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          stg[((g8 + 8 * i) * 8 + 2 * t4 + j) * kMaxGroup + g] =
              (a[i][j] * ih + bsum[i][j] * ih) * 0.5f;
    }
    __syncthreads();  // every warp is past channel g: its stage is free
  }
  if (!active || ablated(kStore)) return;

  // each kept entry's run of the group's channels, to (n, m) and (m, n), a
  // lane an entry: 16-, 8- or 4-byte pieces as the run's alignment allows
  float* ob = out + static_cast<size_t>(b) * N * N * C + c0;
  const uintptr_t at = reinterpret_cast<uintptr_t>(ob) | (static_cast<uintptr_t>(C) << 2);
  const int vw = (nch & 3) == 0 && (at & 15) == 0 ? 4 : (nch & 1) == 0 && (at & 7) == 0 ? 2 : 1;
  for (int side = 0; side < 2; ++side) {
    for (int e = lane; e < kWarpEntries; e += 32) {
      const int rr = side ? e & 15 : e >> 3, cc = side ? e >> 4 : e & 7;
      const int n = n0 + rr, m = m0 + cc;  // tile-local
      if (n >= nI || m >= nJ || (diag && (side ? n >= m : n > m))) continue;
      const int gn = I0 + n, gm = J0 + m;
      float* o = ob + (static_cast<size_t>(side ? gm : gn) * N + (side ? gn : gm)) * C;
      const float* src = stg + (rr * 8 + cc) * kMaxGroup;
      for (int p = 0; p < nch; p += vw) {
        if (vw == 4)
          *reinterpret_cast<float4*>(o + p) = *reinterpret_cast<const float4*>(src + p);
        else if (vw == 2)
          *reinterpret_cast<float2*>(o + p) = *reinterpret_cast<const float2*>(src + p);
        else
          o[p] = src[p];
      }
    }
  }
}

// Launch over the wrapper's plan of npairs tile pairs; the cudaError_t of
// the launch (0 on success).  The kernel's shared-memory limit is raised at
// every launch that needs more than the default 48 KB, not once behind a
// static flag: two libraries include this launcher, and a function-local
// static of a template is one symbol shared by every library loaded (a
// unique global symbol), so a flag set by one would skip the other's call.
template <bool kBf16, bool kDs8>
int tiled_scores_launch_ds(const float* q, const float* k, const int* pairs, float* out, int B,
                           int C, int N, int A, int H, int ds, int G, int npairs,
                           long long qsb, long long qsc, long long qsn, long long ksb,
                           long long ksc, long long ksn, float score_div, cudaStream_t stream) {
  const int smem = tiled_scores_smem<kBf16>(A, G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(tiled_scores_kernel<kBf16, kDs8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(npairs, cdiv(C, G), B);
  tiled_scores_kernel<kBf16, kDs8><<<grid, kThreads, smem, stream>>>(
      q, k, pairs, out, C, N, A, H, ds, G, qsb, qsc, qsn, ksb, ksc, ksn, score_div);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int tiled_scores_launch(const float* q, const float* k, const int* pairs, float* out, int B,
                        int C, int N, int A, int H, int ds, int G, int npairs, long long qsb,
                        long long qsc, long long qsn, long long ksb, long long ksc,
                        long long ksn, float score_div, cudaStream_t stream) {
  if (G < 1 || tiled_scores_smem<kBf16>(A, G) > kMaxSmem || B > 65535 || cdiv(C, G) > 65535)
    return (int)cudaErrorInvalidValue;
  auto launch = ds == 8 && H == 4 ? tiled_scores_launch_ds<kBf16, true>
                                   : tiled_scores_launch_ds<kBf16, false>;
  return launch(q, k, pairs, out, B, C, N, A, H, ds, G, npairs, qsb, qsc, qsn, ksb, ksc, ksn,
                score_div, stream);
}

}  // namespace gmh
