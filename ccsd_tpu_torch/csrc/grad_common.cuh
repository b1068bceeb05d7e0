// Device code shared by the backward kernels gcn_aggregate_bwd.cu and
// gmh_attention_bwd.cu: staging, a plain shared-memory product, the
// degrees with their slope, the gradient of the adjacency through the GCN
// normalisation, and the deterministic sum of per-block partials.
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
// Weight and bias gradients sum over the batch: each block writes its own
// partial and strided_sum adds them in a fixed order, so the result is the
// same on every run (no float atomics).

#pragma once

#include "gmh_common.cuh"

namespace grad {

using gmh::cdiv;

constexpr int kThreads = 256;

// dst[r * ldd + c] = src[r * srow + c * scol] for r < rows, c < cols, by all
// threads of the block (plain loads; a barrier must follow).
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ldd,
                                          const float* __restrict__ src, long long srow,
                                          long long scol, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ldd + c] = src[r * srow + c * scol];
  }
}

// out(r, c) = sum_{k < K} a(r, k) b(k, c), the FMAs in k order, for r < M,
// c < Ncol: one output a thread, by all threads of the block; epi(r, c, v)
// receives every output once.
template <typename FA, typename FB, typename Epi>
__device__ __forceinline__ void product(int M, int Ncol, int K, FA a, FB b, Epi epi) {
  for (int i = threadIdx.x; i < M * Ncol; i += blockDim.x) {
    const int r = i / Ncol, c = i - r * Ncol;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(a(r, k), b(k, c), s);
    epi(r, c, s);
  }
}

// Over the staged N x N adjacency A (row stride ld, complete behind a
// barrier): set the diagonal to `loop` (add_loop), then d[n] and slope[n]
// of each row.  One thread a row, which reads and writes only its row; a
// barrier must follow.
__device__ __forceinline__ void degrees(float* A, int ld, int N, bool add_loop, float loop,
                                        float* d, float* slope) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float* row = A + n * ld;
    if (add_loop) row[n] = loop;
    float r = 0.f;
    for (int m = 0; m < N; ++m) r += row[m];
    const float dn = 1.0f / sqrtf(fmaxf(r, 1.0f));
    d[n] = dn;
    slope[n] = r > 1.0f ? -0.5f * dn * dn * dn : (r == 1.0f ? -0.25f : 0.0f);
  }
}

// dA from gN (see the top of this file), gN and A' (N x N, row stride ld),
// d and slope complete behind a barrier; written to out[n * os_n + m *
// os_m].  dr is scratch of N floats.  Ends without a barrier.
__device__ __forceinline__ void adj_grad(const float* __restrict__ gN,
                                         const float* __restrict__ A, int ld,
                                         const float* __restrict__ d,
                                         const float* __restrict__ slope, int N, bool add_loop,
                                         float* __restrict__ dr, float* __restrict__ out,
                                         long long os_n, long long os_m) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < N; ++m)
      s = fmaf(fmaf(gN[n * ld + m], A[n * ld + m], gN[m * ld + n] * A[m * ld + n]), d[m], s);
    dr[n] = slope[n] * s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    const float v = (add_loop && n == m) ? 0.f : fmaf(gN[n * ld + m] * d[n], d[m], dr[n]);
    out[n * os_n + m * os_m] = v;
  }
}

// out[i] = sum_{k < K} in[(i / group) * group_stride + i % group + k * stride]
// for i < len, the terms in k order: the batch (or channel) sum of per-block
// partials, one output a thread.
__global__ void __launch_bounds__(kThreads)
strided_sum(const float* __restrict__ in, float* __restrict__ out, int len, int K,
            long long stride, int group, long long group_stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  const float* p = in + (i / group) * group_stride + i % group;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += p[k * stride];
  out[i] = s;
}

// Launch strided_sum on `stream`; returns the cudaError_t of the launch.
inline int launch_strided_sum(const float* in, float* out, int len, int K, long long stride,
                              int group, long long group_stride, cudaStream_t stream) {
  strided_sum<<<cdiv(len, kThreads), kThreads, 0, stream>>>(in, out, len, K, stride, group,
                                                             group_stride);
  return (int)cudaGetLastError();
}

}  // namespace grad
