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
// after it see finite values; kLoads (gmh_projection only) zero-fills the
// ring of its adjacency and X copies.  The default, 0, removes nothing.
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
// written for the group's channels as runs of 16-byte stores where they
// allow (with G = C, C consecutive floats).
__device__ __forceinline__ void store_pairs(float* __restrict__ out,
                                            const float* __restrict__ R, int rstride,
                                            int N, int C, int G, int H, float score_div) {
  const int ldr = map_ld(N), rp = raw_plane(N);
  const float inv = 1.0f / score_div, fh = static_cast<float>(H);
  const bool vec = (G & 3) == 0 && (C & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int i = threadIdx.x; i < pair_items(N); i += blockDim.x) {
    int n, m;
    if (!pair_of(i, N, n, m)) continue;
    float* o1 = out + static_cast<long long>(n * N + m) * C;
    float* o2 = out + static_cast<long long>(m * N + n) * C;
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
        const float4 w = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(o1 + g0) = w;
        *reinterpret_cast<float4*>(o2 + g0) = w;
      } else {
        for (int u = 0; u < 4 && g0 + u < G; ++u) o1[g0 + u] = o2[g0 + u] = v[u];
      }
    }
  }
}

// -------------------------------------------- tiled scores (N > 64)
//
// A graph whose Q, K and N x N head sums do not fit one block (N > 64: at
// grid's N = 361 the sums of one head alone are 521 KB against 227 KB) is
// cut into tiles of kTile rows.  A block takes one tile pair (I, J), I <= J,
// of one graph for a group of G channels; the pairs come from the wrapper's
// plan (pairs[2 p], pairs[2 p + 1] = I, J), which covers every pair once.
// Per channel g the block stages the Q and K rows of both tiles and takes
//   T_IJ[n, m] = sum_h tanh(s_h(Q_n, K_m) / score_div)   n in I, m in J
//   T_JI[m, n] = sum_h tanh(s_h(Q_m, K_n) / score_div)   m in J, n in I
// into shared memory; after the group's channels it writes
//   out[n, m, g] = out[m, n, g] = (T_IJ[n, m] / H + T_JI[m, n] / H) / 2
// for the rows of I and then of J, as runs over (m, g) (with G = C, whole
// rows of a tile's N_J x C floats), so the symmetrisation needs no second
// pass and no scratch.  A diagonal pair (I == J) takes T_II once, reads it
// both ways and writes its tile once.  The rounding points of the one-block
// stage are kept: f32, or (kBf16) Q and K rounded to bf16 (a pass over the
// staged rows), products exact in f32 and summed in f32 in d order, each
// s_h rounded to bf16 once, tanhf and the head sums in f32.  The products
// are f32 FMAs on the bf16-valued operands (a bf16 x bf16 product is exact
// in f32, so an FMA rounds only its sum): the tensor cores would add in
// another order, and at these sizes the tanh, not the products, sets the
// time.
//
// Work of a block, 256 threads: per channel, thread t takes direction
// t / 128 (IJ, or JI; the JI threads idle on a diagonal pair) and a patch
// of 2 rows x 4 columns, rows pm + 16 i and columns pn + 8 j (pm = p / 8,
// pn = p % 8, p = t % 128): per head ds d cost 2 + 4 row loads (16-byte
// loads of four d where ds % 4 == 0) for 8 ds FMAs, and 8 tanhf.  Rows
// past a ragged tile's end read its last row and are never stored.
//
// Shared layout (floats): two stages of [Q_I | K_I | Q_J | K_J], each
// kTile x ld (ld4(A): 16-byte copies, eight distinct K rows a warp in
// distinct banks), so the copies of channel g + 1 land while channel g is
// computed; then T_IJ and T_JI of the G channels, tile_plane(G) floats a
// channel, rows of kTileLd floats (odd).  tile_plane(G) = 32 / G (mod 32)
// for G dividing 32, so the store phase's reads of both T (a warp over
// 32 / G columns x G channels, once along a row and once down a column)
// fall in distinct banks.

constexpr int kTile = 32;        // rows of a tile
constexpr int kTileLd = kTile + 1;

__host__ __device__ constexpr int tile_plane(int G) {
  return kTile * kTileLd + (32 % G == 0 ? (32 / G) & 31 : 1);
}

struct TiledScoresLayout {
  int ld;     // row stride of the staged Q and K
  int stage;  // floats of one stage: Q_I, K_I, Q_J, K_J
  int t;      // offset of T_IJ (T_JI follows at t + G * tile_plane(G))
  int total;
  __host__ __device__ TiledScoresLayout(int A, int G) {
    ld = ld4(A);
    stage = 4 * kTile * ld;
    t = 2 * stage;
    total = t + 2 * G * tile_plane(G);
  }
};

// The f32 value rounded to the nearest bf16 (ties to even), as an f32.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One patch of T for one channel: rows r[i] of Qr against rows c[j] of Kc,
// all heads, into Tp (rows of kTileLd floats).
template <bool kBf16>
__device__ __forceinline__ void tile_patch(const float* __restrict__ Qr,
                                           const float* __restrict__ Kc, int ld, int pm,
                                           int pn, int nr, int nc, int H, int ds, float inv,
                                           float* __restrict__ Tp) {
  int rq[2], rk[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) rq[i] = min(pm + 16 * i, nr - 1) * ld;
#pragma unroll
  for (int j = 0; j < 4; ++j) rk[j] = min(pn + 8 * j, nc - 1) * ld;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bool vec = (ds & 3) == 0 && (ld & 3) == 0;
  for (int h = 0; h < H; ++h) {
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    int d = h * ds;
    if (vec)
      for (; d < (h + 1) * ds; d += 4) {
        float4 a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = *reinterpret_cast<const float4*>(Qr + rq[i] + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Kc + rk[j] + d);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
      }
    for (; d < (h + 1) * ds; ++d) {
      float a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = Qr[rq[i] + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Kc[rk[j] + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += tanhf((kBf16 ? bf16_round(s[i][j]) : s[i][j]) * inv);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Tp[(pm + 16 * i) * kTileLd + pn + 8 * j] = acc[i][j];
}

// pairs: the plan, (I, J) of every pair; grid (pairs, channel groups, B).
// q, k: (B, C, N, A) in strides (b, c, n), the feature stride 1.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
tiled_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const int* __restrict__ pairs, float* __restrict__ out, int C, int N,
                    int A, int H, int ds, int G, long long qsb, long long qsc, long long qsn,
                    long long ksb, long long ksc, long long ksn, float score_div) {
  extern __shared__ __align__(16) float smem[];
  const TiledScoresLayout L(A, G);
  const int I = pairs[2 * blockIdx.x], J = pairs[2 * blockIdx.x + 1];
  const bool diag = I == J;
  const int I0 = I * kTile, J0 = J * kTile;
  const int nI = min(kTile, N - I0), nJ = min(kTile, N - J0);
  const int b = blockIdx.z, c0 = blockIdx.y * G;
  const int nch = min(G, C - c0);
  const int plane = tile_plane(G);
  float* tIJ = smem + L.t;
  float* tJI = diag ? tIJ : tIJ + G * plane;
  const int mat = kTile * L.ld;  // floats of one staged matrix

  // stage s holds Q_I, K_I at 0, mat and Q_J, K_J at 2 mat, 3 mat
  auto stage = [&](int g, float* dst) {
    const float* qc = q + b * qsb + (c0 + g) * qsc;
    const float* kc = k + b * ksb + (c0 + g) * ksc;
    copy_tile_async(dst, L.ld, qc + I0 * qsn, qsn, 1, nI, A);
    copy_tile_async(dst + mat, L.ld, kc + I0 * ksn, ksn, 1, nI, A);
    if (!diag) {
      copy_tile_async(dst + 2 * mat, L.ld, qc + J0 * qsn, qsn, 1, nJ, A);
      copy_tile_async(dst + 3 * mat, L.ld, kc + J0 * ksn, ksn, 1, nJ, A);
    }
  };
  const float inv = 1.0f / score_div;
  const int t = threadIdx.x, dir = t >> 7, p = t & 127, pm = p >> 3, pn = p & 7;
  const int warp = t >> 5, lane = t & 31, nwarps = blockDim.x >> 5;

  stage(0, smem);
  cp_async_commit();
  for (int g = 0; g < nch; ++g) {
    float* cur = smem + (g & 1) * L.stage;
    if (g + 1 < nch) {
      stage(g + 1, smem + ((g + 1) & 1) * L.stage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kBf16) {  // Q and K rounded to bf16, every staged element once: rows by warp
      const int rows = diag ? 2 * kTile : 4 * kTile;
      for (int r = warp; r < rows; r += nwarps)
        for (int c = lane; c < A; c += 32) {
          float& v = cur[r * L.ld + c];
          v = bf16_round(v);
        }
      __syncthreads();
    }
    if (ablated(kHeadSums)) {
      if (dir == 0 || !diag) {
        float* Tp = (dir ? tJI : tIJ) + g * plane;
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 4; ++j) Tp[(pm + 16 * i) * kTileLd + pn + 8 * j] = 0.f;
      }
    } else if (dir == 0) {  // rows of I against K_J (K_I on a diagonal pair)
      tile_patch<kBf16>(cur, cur + (diag ? 1 : 3) * mat, L.ld, pm, pn, nI, diag ? nI : nJ, H,
                        ds, inv, tIJ + g * plane);
    } else if (!diag) {  // rows of J against K_I
      tile_patch<kBf16>(cur + 2 * mat, cur + mat, L.ld, pm, pn, nJ, nI, H, ds, inv,
                        tJI + g * plane);
    }
    __syncthreads();  // T of channel g complete; stage g & 1 free for g + 2
  }
  if (ablated(kStore)) return;

  // rows of I (pass 0), then of J (pass 1, off the diagonal), a warp an
  // output row and its lanes along the row's run of (column, channel):
  // both entries of a pair from the same two sums in the same order, so
  // the map is exactly symmetric.  1/H multiplies (exact for a power of
  // two, as the 4 heads of every config); a power-of-two group splits a
  // lane's index by a shift, with no integer division
  const float ih = 1.0f / static_cast<float>(H);
  const bool pow2 = (nch & (nch - 1)) == 0;
  const int gshift = __ffs(nch) - 1;
  float* ob = out + static_cast<size_t>(b) * N * N * C + c0;
  for (int pass = 0; pass < (diag ? 1 : 2); ++pass) {
    const int nr = pass ? nJ : nI, nc = pass ? nI : nJ;
    const int r0 = pass ? J0 : I0, cc0 = pass ? I0 : J0;
    for (int r = warp; r < nr; r += nwarps) {
      float* orow = ob + (static_cast<size_t>(r0 + r) * N + cc0) * C;
      for (int j = lane; j < nc * nch; j += 32) {
        const int cidx = pow2 ? j >> gshift : j / nch, g = j - cidx * nch;
        const int n = pass ? cidx : r, m = pass ? r : cidx;  // n in I, m in J
        const float a = tIJ[g * plane + n * kTileLd + m];
        const float bb = tJI[g * plane + m * kTileLd + n];
        orow[cidx * C + g] = (a * ih + bb * ih) * 0.5f;
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
template <bool kBf16>
int tiled_scores_launch(const float* q, const float* k, const int* pairs, float* out, int B,
                        int C, int N, int A, int H, int ds, int G, int npairs, long long qsb,
                        long long qsc, long long qsn, long long ksb, long long ksc,
                        long long ksn, float score_div, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * TiledScoresLayout(A, G).total;
  if (G < 1 || smem > kMaxSmem || B > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(tiled_scores_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(npairs, cdiv(C, G), B);
  tiled_scores_kernel<kBf16><<<grid, kThreads, smem, stream>>>(
      q, k, pairs, out, C, N, A, H, ds, G, qsb, qsc, qsn, ksb, ksc, ksn, score_div);
  return (int)cudaGetLastError();
}

}  // namespace gmh
