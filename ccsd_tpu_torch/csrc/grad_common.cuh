// Device code shared by the backward kernels gcn_aggregate_bwd.cu and
// gmh_attention_bwd.cu: staging, register-tiled f32 products, the degrees
// with their slope, the gradient of the adjacency through the GCN
// normalisation, and the deterministic sums of per-block partials over the
// batch (thread-block clusters, then integer tickets).
//
// The normalisation of gcn_norm (ccsd_tpu/models/gcn.py:23-35):
//   A'[n, m] = loop if add_loop and n == m, else A[n, m]
//   r[n]     = sum_m A'[n, m];   d[n] = max(r[n], 1)^-1/2
//   norm     = d[n] A'[n, m] d[m]
// Given gN = dL/dnorm, the gradient of A is
//   dA[n, m] = gN[n, m] d[n] d[m] + dr[n]      (0 on an assigned diagonal)
//   dr[n]    = slope[n] sum_m (gN[n, m] A'[n, m] + gN[m, n] A'[m, n]) d[m]
//   slope[n] = dd/dr: -d^3 / 2 where r > 1, -1/4 where r == 1, 0 below.
// At the tie r == 1 (a node with only its loop: an absent node of a padded
// graph) jnp.clip passes half the gradient, so jax.grad of the reference
// gives -1/4 there; the kernels follow it.
//
// Sums over the batch, with no float atomics, so that a gradient is the
// same on every run: the blocks of one channel form clusters of kCluster
// consecutive blocks (graphs, or a graph's row groups); each block leaves
// its partial in its shared memory, and rank r of a cluster adds slice r of
// the cluster's partials through distributed shared memory, in rank order.
// With more than one cluster, each writes its sums to device memory and
// takes an integer ticket per slice; the cluster that arrives last at a
// slice's ticket adds the clusters' sums of that slice in cluster order.
// The last block to arrive resets the ticket, so the ticket buffer is all
// zeros between launches; launches that share it must not run concurrently
// (the port launches on one stream).

#pragma once

#include <cooperative_groups.h>

#include "gmh_common.cuh"

namespace grad {

namespace cg = cooperative_groups;
using gmh::cdiv;
using gmh::ld4;
using gmh::odd;
using gmh::round4;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

constexpr int kThreads = 256;
constexpr int kCluster = 8;  // blocks of a cluster (at most 8, the portable maximum)

// Stage ablation, for scripts/grad_stage_times.py: a build with
// -DGRAD_ABLATE=<mask of the stages below> puts a zero fill of what a masked
// stage writes in its place (kReduce: the sums are not taken; the outputs
// they give are not written).  The default, 0, removes nothing.
#ifndef GRAD_ABLATE
#define GRAD_ABLATE 0
#endif
enum Stage : unsigned {
  kLoads = 1,       // the cp.async staging of the inputs
  kRecompute = 2,   // gmh: NX = norm X and [Q | K] = NX W + b
  kScores = 4,      // gmh: the head sums and gS
  kGradQK = 8,      // gmh: gQ and gK
  kGradW = 16,      // the block's dW and db
  kGradNX = 32,     // gmh: gNX = gP W^T
  kGradX = 64,      // dX (gmh: this channel's share)
  kGradAdj = 128,   // gN (gcn: with Y = X W)
  kReduce = 256,    // the cluster and ticket sums (gmh: dX over channels too)
  kGradY = 512,     // gcn: dY = norm^T G
  kGradV = 1024,    // gmh, N > 64: the row-tile kernel's V = A'[:, R]^T (d o gP);
                    // gcn, N > 64: the fold of V's chunk partials
};
// In gmh_attention_bwd.cu's designs above N = 64, kScores is the dots and
// tanh of gmh_score_grad, kGradQK its two products, kReduce also its sum of
// gK's partials after the cluster barrier; kGradNX is the row-tile
// kernel's U and gNX, kGradAdj its P1 and dA products, kGradX its dX rows,
// kRecompute its whole P1 role (loads, row sums, product), kGradY its
// whole dA pass (loads, product, stores).
__device__ constexpr bool ablated(Stage s) { return (GRAD_ABLATE & s) != 0; }

__device__ __forceinline__ void zero_fill(float* p, int n) { gmh::zero_fill(p, n); }

// dst[r * ldd + c] <- src[r * srow + c * scol] by cp.async
// (gmh::copy_tile_async), not committed; a zero fill where the loads are
// ablated.
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, long long srow,
                                      long long scol, int rows, int cols) {
  if (ablated(kLoads))
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
      dst[(i / cols) * ldd + i % cols] = 0.f;
  else
    gmh::copy_tile_async(dst, ldd, src, srow, scol, rows, cols);
}

// ------------------------------------------------------------ f32 products
//
// Each function computes patch p of a product, TM x TN outputs, for a loop
// over patches that the caller spreads over the block's threads.  As in
// gmh::tiled_product, patch p owns rows pm + i * RT and columns pn + j * CT
// (RT = cdiv(M, TM), CT = cdiv(Ncol, TN), pm = p / CT, pn = p % CT), so the
// threads of a warp take consecutive columns and distinct rows; every
// output's FMAs run in k order, and epi(r, c, v) receives each output once.

template <int TM, int TN>
__host__ __device__ constexpr int patches(int M, int Ncol) {
  return cdiv(M, TM) * cdiv(Ncol, TN);
}

// out(r, c) = sum_{k < K} a(r, k) b(k, c) through accessors: TM + TN shared
// loads for TM * TN FMAs a k (a transposed operand is an accessor that reads
// down a column).
template <int TM, int TN, typename FA, typename FB, typename Epi>
__device__ __forceinline__ void patch(int p, int M, int Ncol, int K, FA a, FB b, Epi epi) {
  const int RT = cdiv(M, TM), CT = cdiv(Ncol, TN);
  const int pm = p / CT, pn = p - pm * CT;
  int r[TM], c[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) r[i] = min(pm + i * RT, M - 1);
#pragma unroll
  for (int j = 0; j < TN; ++j) c[j] = min(pn + j * CT, Ncol - 1);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a(r[i], k);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b(k, c[j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (pm + i * RT >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (pn + j * CT < Ncol) epi(pm + i * RT, pn + j * CT, acc[i][j]);
  }
}

// out(r, c) = sum_{k0 <= k < k1} A[r lda + k] B[c ldb + k]: both operands
// read along k (A B^T), in 16-byte loads of four k where k0, k1 - k0, lda
// and ldb are multiples of 4 (rows of ld4 strides: the distinct rows of a
// quarter-warp fall in distinct banks), TM + TN loads for 4 TM TN FMAs;
// else one k at a time.  The forward's head-sum patch (sum_patch_f32) with
// an epilogue.
template <int TM, int TN, typename Epi>
__device__ __forceinline__ void patch_nt(int p, const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int ldb, int M, int Ncol,
                                         int k0, int k1, Epi epi) {
  const int RT = cdiv(M, TM), CT = cdiv(Ncol, TN);
  const int pm = p / CT, pn = p - pm * CT;
  int ra[TM], rb[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) ra[i] = min(pm + i * RT, M - 1) * lda;
#pragma unroll
  for (int j = 0; j < TN; ++j) rb[j] = min(pn + j * CT, Ncol - 1) * ldb;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int k = k0;
  if (((k0 | (k1 - k0) | lda | ldb) & 3) == 0)
    for (; k < k1; k += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(A + ra[i] + k);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(B + rb[j] + k);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  for (; k < k1; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[ra[i] + k];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[rb[j] + k];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (pm + i * RT >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (pn + j * CT < Ncol) epi(pm + i * RT, pn + j * CT, acc[i][j]);
  }
}

// out(r, c) = sum_{k < K} A[r lda + k] B[k ldb + c] (A B), for lda and ldb
// multiples of 4, 16-byte aligned operands and Ncol a multiple of 4: as
// gmh::tiled_product4, patch p owns rows pm + i * RT and the four columns
// 4 pn.. (CT = Ncol / 4): four k cost TM + 4 loads of 16 bytes for 16 TM
// FMAs.
template <int TM>
__host__ __device__ constexpr int patches4(int M, int Ncol) {
  return cdiv(M, TM) * (Ncol / 4);
}

template <int TM, typename Epi>
__device__ __forceinline__ void patch_nn4(int p, const float* __restrict__ A, int lda,
                                          const float* __restrict__ B, int ldb, int M, int Ncol,
                                          int K, Epi epi) {
  const int RT = cdiv(M, TM), CT = Ncol / 4;
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
    if (pm + i * RT >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) epi(pm + i * RT, c0 + j, acc[i][j]);
  }
}

// out(r, c) = sum_{k < K} At[k ldat + r] B[k ldb + c] (A^T stored, A B),
// for ldb a multiple of 4, a 16-byte aligned B and Ncol a multiple of 4:
// patch p owns rows pm + i * RT and the four columns 4 pn.. (as
// patch_nn4), each k TM 4-byte loads of A^T (the warp's rows on
// consecutive addresses) and one 16-byte load of B for 4 TM FMAs.
template <int TM, typename Epi>
__device__ __forceinline__ void patch_tn4(int p, const float* __restrict__ At, int ldat,
                                          const float* __restrict__ B, int ldb, int M, int Ncol,
                                          int K, Epi epi) {
  const int RT = cdiv(M, TM), CT = Ncol / 4;
  const int pm = p / CT, c0 = 4 * (p - pm * CT);
  int r[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) r[i] = min(pm + i * RT, M - 1);
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + c0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a = At[k * ldat + r[i]];
      acc[i][0] = fmaf(a, b.x, acc[i][0]);
      acc[i][1] = fmaf(a, b.y, acc[i][1]);
      acc[i][2] = fmaf(a, b.z, acc[i][2]);
      acc[i][3] = fmaf(a, b.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (pm + i * RT >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) epi(pm + i * RT, c0 + j, acc[i][j]);
  }
}

// -------------------------------------------------- degrees and dA

// d and slope of rows lane and lane + 32 (N <= 64) of the staged N x N
// adjacency (row stride lda; the diagonal taken as `loop` where add_loop),
// by every warp for itself, each row summed in column order; rows past N
// get d = 1, slope = 0.
__device__ __forceinline__ void warp_degrees(const float* __restrict__ A, int lda, int N,
                                             bool add_loop, float loop, float d[2],
                                             float sl[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    d[h] = 1.f;
    sl[h] = 0.f;
    if (r >= N) continue;
    const float* row = A + r * lda;
    float s = 0.f;
    for (int j = 0; j < N; ++j) s += (add_loop && j == r) ? loop : row[j];
    const float dn = 1.0f / sqrtf(fmaxf(s, 1.0f));
    d[h] = dn;
    sl[h] = s > 1.0f ? -0.5f * dn * dn * dn : (s == 1.0f ? -0.25f : 0.0f);
  }
}

// d of row r (< 64) from a warp's warp_degrees registers.
__device__ __forceinline__ float shfl_d(const float d[2], int r) {
  const float v0 = __shfl_sync(0xffffffffu, d[0], r & 31);
  const float v1 = __shfl_sync(0xffffffffu, d[1], r & 31);
  return r < 32 ? v0 : v1;
}

// dA of rows [r0, r1) from gN (N x N, row stride ldg), the staged
// adjacency A (row stride lda; A' read with the diagonal `loop` where
// add_loop), d and slope: one warp a row; the row's degree term dr is a
// sum over the lanes' columns (lane, lane + 32), added in a fixed butterfly
// order.  Written to out[n * os_n + m * os_m].
__device__ __forceinline__ void adj_grad_rows(const float* __restrict__ gN, int ldg,
                                              const float* __restrict__ A, int lda,
                                              const float* __restrict__ d,
                                              const float* __restrict__ slope, int N, int r0,
                                              int r1, bool add_loop, float loop,
                                              float* __restrict__ out, long long os_n,
                                              long long os_m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = r0 + warp; n < r1; n += blockDim.x >> 5) {
    float s = 0.f;
    for (int m = lane; m < N; m += 32) {
      const float anm = (add_loop && n == m) ? loop : A[n * lda + m];
      const float amn = (add_loop && n == m) ? loop : A[m * lda + n];
      s = fmaf(fmaf(gN[n * ldg + m], anm, gN[m * ldg + n] * amn), d[m], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float dr = slope[n] * s, dn = d[n];
    for (int m = lane; m < N; m += 32)
      out[n * os_n + m * os_m] = (add_loop && n == m) ? 0.f : fmaf(gN[n * ldg + m] * dn, d[m], dr);
  }
}

// ------------------------------------------------ tiled designs (N > 64)
//
// Above N = 64 a block holds one row tile R = [r0, r0 + nr) of kTile rows
// of a graph (and channel) and reads d of every row from gcn_degrees.cu.
// Its products over all N rows (norm^T times a matrix, P1 below) run over
// chunks of kTile rows, double-buffered (chunk_loop).  dA of the tile's
// rows needs each row's degree term, a sum over all columns; with
// gN = Lf Rf^T (gcn: G Y^T; gmh: gNX X^T) it regroups into products of the
// tile's rows alone:
//   sum_m gN[n, m] A'[n, m] d_m = Lf[n] . P1[n],  P1 = A'[R, :] (d o Rf)
//   sum_m gN[m, n] A'[m, n] d_m = Rf[n] . U[n],   U  = A'[:, R]^T (d o Lf)
// so no sum crosses a row tile, and dA[n, m] = d_n d_m Lf[n] . Rf[m] + dr[n].

constexpr int kTile = gmh::kTile;  // rows of a row tile and of a chunk

// s = sum_m A'[n, m] of one row (row[m * sm], the diagonal `loop` where
// add_loop), by one warp, in gcn_degrees.cu's order (lanes over m, then a
// xor butterfly), so that it is the sum behind that launch's d[n]; every
// lane gets it.
__device__ __forceinline__ float warp_row_sum(const float* row, long long sm, int N, int n,
                                              bool add_loop, float loop) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int m = lane; m < N; m += 32) s += (add_loop && m == n) ? loop : row[m * sm];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// dd/ds at the row sum s (the top of this file), as warp_degrees takes it.
__device__ __forceinline__ float degree_slope(float s) {
  const float dn = 1.0f / sqrtf(fmaxf(s, 1.0f));
  return s > 1.0f ? -0.5f * dn * dn * dn : (s == 1.0f ? -0.25f : 0.0f);
}

// The double-buffered loop over n steps: load(k, buf) issues step k's
// copies into buffer buf (0 or 1), not committed; body(k, buf) runs once
// every copy of step k, and every copy committed before the loop, has
// landed.  All threads call it; it ends with a barrier.
template <typename Load, typename Body>
__device__ __forceinline__ void ring_loop(int n, Load load, Body body) {
  load(0, 0);
  gmh::cp_async_commit();
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      load(k + 1, (k + 1) & 1);  // buffer (k + 1) & 1 was freed by body(k - 1)
      gmh::cp_async_commit();
      gmh::cp_async_wait<1>();
    } else {
      gmh::cp_async_wait<0>();
    }
    __syncthreads();
    body(k, k & 1);
    __syncthreads();
  }
}

// ring_loop over the cdiv(N, kTile) chunks of kTile rows.
template <typename Load, typename Body>
__device__ __forceinline__ void chunk_loop(int N, Load load, Body body) {
  ring_loop(cdiv(N, kTile), load, body);
}

// Let `kernel` take as much dynamic shared memory as the card leaves beside
// its static shared memory (last_arrival's flag); returns those bytes, or
// -1 where the runtime refuses (its error is then pending).
template <typename Kernel>
inline int allow_dynamic_smem(Kernel kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  const int bytes = gmh::kMaxSmem - static_cast<int>(attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// ------------------------------------------------------ sums over blocks

// True in the block that arrives last at `ticket` of `total` arrivals, once
// every block's writes before its arrival are visible to it; that block
// resets the ticket.  All threads of the block call it.
__device__ __forceinline__ bool last_arrival(int* ticket, int total) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == total - 1;
    if (last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// sum_{k < n} p[k * stride] in k order, the terms read from L2 (__ldcg:
// written by other blocks of this launch) eight at a time, so that their
// latencies overlap.
__device__ __forceinline__ float ordered_sum_l2(const float* p, long long stride, int n) {
  float s = 0.f;
  for (int k0 = 0; k0 < n; k0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = k0 + u < n ? __ldcg(p + (k0 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < n) s += v[u];
  }
  return s;
}

// The sum over a channel's blocks of the T-float partial each holds at
// `local` in its shared memory (zeros in a padding block), in a fixed order
// (see the top of this file).  part + k * cstride holds cluster k's sums
// (nclusters > 1), tickets[r] is slice r's ticket; out(e, v) receives each
// of the T sums once.  All threads of every block of the cluster call it.
// cid is the cluster's index among the channel's clusters (by default
// blockIdx.x / kCluster: clusters laid along x).
template <typename Out>
__device__ __forceinline__ void batch_sum(float* local, int T, int nclusters, float* part,
                                          long long cstride, int* tickets, Out out,
                                          int cid = -1) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  if (cid < 0) cid = static_cast<int>(blockIdx.x) / kCluster;
  const int lo = T * rank / kCluster, hi = T * (rank + 1) / kCluster;
  const float* rem[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) rem[q] = cluster.map_shared_rank(local, q);
  cluster.sync();
  for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    float s = rem[0][e];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) s += rem[q][e];
    if (nclusters == 1)
      out(e, s);
    else
      part[cid * cstride + e] = s;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
  if (nclusters == 1 || !last_arrival(tickets + rank, nclusters)) return;
  for (int e = lo + threadIdx.x; e < hi; e += blockDim.x)
    out(e, ordered_sum_l2(part + e, cstride, nclusters));
}

}  // namespace grad
