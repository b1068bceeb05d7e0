// Device code shared by channel_agg.cu, gcn_aggregate.cu and
// gcn_degrees.cu: the loop assignment, the degrees and their inverse square
// roots, the product of staged rows with a 16-byte-wide right operand, and
// the copy of a row at any alignment in 16-byte pieces.
//
// Both kernels apply the symmetric GCN normalisation of gcn_norm
// (ccsd_tpu/models/gcn.py:23-35) to one N x N matrix at a time:
//   A'[n, m] = loop if add_loop and n == m, else A[n, m]
//   d[n]     = max(sum_m A'[n, m], 1)^-1/2
//   norm     = d[n] A'[n, m] d[m]
// A block holds `rows` consecutive rows of A' (every column) in shared
// memory.  Where those are all N rows it sums them itself; otherwise the
// column degrees d[m] need rows the block does not hold, and gcn_degrees.cu
// computes d once per row in a launch before, which the block reads.
//
// Stage ablation, for scripts/gcn_stage_times.py: a build with
// -DGCN_ABLATE=<mask of the stages below> removes a stage: the loads become
// a zero fill of the staged buffers, the degree sums become d = 1 (and d
// is not applied), a removed product or projection leaves zeros, a removed
// store writes nothing.  The default, 0, removes nothing.

#pragma once

#include "gmh_common.cuh"

namespace gcn {

using gmh::cdiv;
using gmh::ld4;
using gmh::round4;

constexpr int kMaxThreads = 256;

#ifndef GCN_ABLATE
#define GCN_ABLATE 0
#endif
enum Stage : unsigned { kLoads = 1, kDegrees = 2, kProduct = 4, kProjection = 8, kStore = 16 };
__device__ constexpr bool ablated(Stage s) { return (GCN_ABLATE & s) != 0; }

// Lanes that sum one row of a whole graph (prepare_rows).
constexpr int kRowLanes = 8;

// Threads of a block over `rows` rows whose widest stage gives a row
// `per_row` work items (four outputs each): whole warps, at least kRowLanes
// a row for the degree sums and two warps, at most kMaxThreads.
constexpr int block_threads(int rows, int per_row) {
  const int items = rows * (per_row > kRowLanes ? per_row : kRowLanes);
  return items > kMaxThreads - 32 ? kMaxThreads : items < 64 ? 64 : cdiv(items, 32) * 32;
}

// Copy rows x cols of src (row stride srow, column stride scol) into dst
// (row stride ldd) with cp.async (T = float; bf16 widened by plain loads,
// gmh::copy_tile), or zero-fill dst where the loads are ablated.  Not
// committed.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ldd, const T* src, long long srow,
                                      long long scol, int rows, int cols) {
  if (ablated(kLoads)) {
    gmh::zero_fill(dst, rows * ldd);
  } else {
    gmh::copy_tile(dst, ldd, src, srow, scol, rows, cols);
  }
}

// Zero columns [cols, ld) of each row: the padding a 16-byte product reads.
__device__ __forceinline__ void zero_pad(float* p, int ld, int rows, int cols) {
  const int pad = ld - cols;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
    const int r = i / pad;
    p[r * ld + cols + (i - r * pad)] = 0.f;
  }
}

__device__ __forceinline__ float inv_sqrt_degree(float s) {
  return ablated(kDegrees) ? 1.0f : 1.0f / sqrtf(fmaxf(s, 1.0f));
}

__device__ __forceinline__ float4 inv_sqrt_degree(float4 s) {
  return make_float4(inv_sqrt_degree(s.x), inv_sqrt_degree(s.y), inv_sqrt_degree(s.z),
                     inv_sqrt_degree(s.w));
}

// The sum of a row's kRowLanes consecutive lanes of a warp, three shuffles.

template <typename T>
__device__ __forceinline__ T lane_sum(T s);

template <>
__device__ __forceinline__ float lane_sum(float s) {
#pragma unroll
  for (int o = kRowLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <>
__device__ __forceinline__ float4 lane_sum(float4 s) {
  return make_float4(lane_sum(s.x), lane_sum(s.y), lane_sum(s.z), lane_sum(s.w));
}

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// After the copies' wait and a barrier, over `rows` staged rows of T
// entries (float, or float4 for four channels; row r of the tile is graph
// row r0 + r): set each row's diagonal to `loop` (when add_loop) and, where
// the block holds all rows (whole), sum each row into d[r] =
// max(sum, 1)^-1/2, kRowLanes lanes a row.  The lane that reads a diagonal
// entry also writes it and no other thread touches it, so no barrier is
// needed between the two; the next barrier publishes both.  The loop over
// rows has the same trip count in every thread, so whole warps shuffle.
template <typename T>
__device__ __forceinline__ void prepare_rows(T* A, int lda, int r0, int rows, int N, bool whole,
                                             bool add_loop, T loop, T* d) {
  if (!whole) {
    if (add_loop)
      for (int r = threadIdx.x; r < rows; r += blockDim.x) A[r * lda + r0 + r] = loop;
    return;
  }
  for (int base = 0; base < rows * kRowLanes; base += blockDim.x) {
    const int i = base + threadIdx.x, r = i / kRowLanes, j = i % kRowLanes;
    T s = T{};
    if (r < rows) {
      T* row = A + r * lda;
      for (int m = j; m < N; m += kRowLanes) {
        T v = row[m];
        if (add_loop && m == r) row[m] = v = loop;
        s = s + v;
      }
    }
    s = lane_sum(s);
    if (r < rows && j == 0) d[r] = inv_sqrt_degree(s);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sum_k a[k] s[k] X[k, c0 .. c0 + 3] for k < K (s[k] = 1 unless kScale),
// each output's FMAs in k order.  a, s and each row of X (stride ldx) are
// 16-byte aligned; ldx % 4 == 0.  Four k cost a 16-byte load of a (and of
// s) and four of X for 16 FMAs.
template <bool kScale>
__device__ __forceinline__ float4 row_times4(const float* __restrict__ a,
                                             const float* __restrict__ sc,
                                             const float* __restrict__ X, int ldx, int c0,
                                             int K) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= K; k += 4) {
    float4 av = *reinterpret_cast<const float4*>(a + k);
    if (kScale) {
      const float4 sv = *reinterpret_cast<const float4*>(sc + k);
      av = make_float4(av.x * sv.x, av.y * sv.y, av.z * sv.z, av.w * sv.w);
    }
    const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(X + (k + u) * ldx + c0);
      acc.x = fmaf(ak[u], x.x, acc.x);
      acc.y = fmaf(ak[u], x.y, acc.y);
      acc.z = fmaf(ak[u], x.z, acc.z);
      acc.w = fmaf(ak[u], x.w, acc.w);
    }
  }
  for (; k < K; ++k) {
    const float ak = kScale ? a[k] * sc[k] : a[k];
    const float4 x = *reinterpret_cast<const float4*>(X + k * ldx + c0);
    acc.x = fmaf(ak, x.x, acc.x);
    acc.y = fmaf(ak, x.y, acc.y);
    acc.z = fmaf(ak, x.z, acc.z);
    acc.w = fmaf(ak, x.w, acc.w);
  }
  return acc;
}

// Write four outputs c0 .. c0 + 3 of a row of `cols` outputs of type T
// (float, or bf16: rounded once): one store where the row allows it (16
// bytes of f32, 8 of bf16), else the columns below `cols` one by one.
template <typename T>
__device__ __forceinline__ void store4(T* row, int c0, int cols, float4 v) {
  if (ablated(kStore)) return;
  const float o[4] = {v.x, v.y, v.z, v.w};
  if ((cols & 3) == 0) {
    gmh::store_run4(row + c0, o);
  } else {
    for (int j = 0; j < 4 && c0 + j < cols; ++j) row[c0 + j] = gmh::from_f32<T>(o[j]);
  }
}

// n contiguous floats from src (any 4-byte alignment) into dst (16-byte
// aligned) by the lanes of a warp, in the 16-byte pieces that cover them:
// src[i] lands at dst[run_shift(src) + i]; dst takes n + 6 floats at most.
__device__ __forceinline__ int run_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void copy_run_async(float* dst, const float* src, int n, int lane) {
  const int sh = run_shift(src);
  for (int p = lane; p < (sh + n + 3) >> 2; p += 32) gmh::cp_async16(dst + 4 * p, src - sh + 4 * p);
}

}  // namespace gcn
