// Inverse square-root degrees of the GCN normalisation, one warp per row:
//
//   deg[b, c, n] = max(sum_m A'[b, c, n, m], 1)^-1/2
//   A'           = A with the diagonal set to `loop` (when add_loop)
//
// Replaces the degree stage of _gcn_kernel (ccsd_tpu/ops/pallas/gcn.py:
// 34-38) for graphs whose rows are spread over several blocks of
// gcn_aggregate.cu or channel_agg.cu (N > 64, grid's N = 361): a block
// there holds some rows of A' but needs the degree of every column.  This
// launch sums each row once, and the blocks after it read the B*C*N
// degrees back (1.4 KB a graph-channel at N = 361) instead of each summing
// all N rows again.  At N <= 64 a block holds the whole matrix and sums it
// itself; this kernel does not run.
//
// What bounds it on H100: one read of the adjacency (B*C*N*N floats:
// 33 MB at B = 8, C = 8, N = 361, ~10 us at 3.35 TB/s) against one add per
// element: bytes.  A warp takes one row: of one channel, with consecutive
// lanes on consecutive m (coalesced where the row is dense), or, for a
// channels-last adjacency of C = 4 or 8 channels, of every channel at once
// (gcn_degrees_quad_kernel): the row's (m, c) entries are then one
// contiguous run, read in 16-byte loads, and each channel is summed in the
// per-row order.  Read a channel at a time, that layout had a warp touch 4
// bytes of every 32-byte sector (and took 34 us on an H100 at grid's
// C = 8).  The adjacency is read through its four strides, so no layout
// needs a copy.

#include "gcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kBatch = 4;  // columns of a row a lane loads before it sums them

__global__ void __launch_bounds__(kThreads)
gcn_degrees_kernel(const float* __restrict__ adj, float* __restrict__ deg, int C, int N,
                   long long rows, long long sb, long long sc, long long sn, long long sm,
                   int add_loop, float loop) {
  const long long i = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= rows) return;
  const int lane = threadIdx.x & 31;
  const int n = (int)(i % N);
  const long long bc = i / N;
  const int c = (int)(bc % C), b = (int)(bc / C);
  const float* row = adj + b * sb + c * sc + n * sn;
  float s = 0.f;
  for (int m = lane; m < N; m += 32) s += (add_loop && m == n) ? loop : row[m * sm];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) deg[i] = gcn::inv_sqrt_degree(s);
}

// One warp a row n of graph b for all C = 4 kQ channels of a channels-last
// adjacency (channel stride 1, strides and base 16-byte aligned): lane l
// reads the C channels of columns m = l, l + 32, ... (a warp 32 C
// contiguous floats a step) and sums each channel as gcn_degrees_kernel
// sums a row, in the same order, so the degrees are bit for bit the same.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
gcn_degrees_quad_kernel(const float* __restrict__ adj, float* __restrict__ deg, int N,
                        long long rows, long long sb, long long sn, long long sm, int add_loop,
                        float loop) {
  const long long i = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= rows) return;  // i = b * N + n
  const int lane = threadIdx.x & 31;
  const int n = (int)(i % N), b = (int)(i / N);
  const float* row = adj + b * sb + n * sn;
  float s[4 * kQ] = {};
  for (int m0 = lane; m0 < N; m0 += 32 * kBatch) {
    float4 v[kBatch][kQ];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + 32 * u;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        v[u][q] = m < N ? *reinterpret_cast<const float4*>(row + m * sm + 4 * q)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        if (add_loop && m == n) v[u][q] = make_float4(loop, loop, loop, loop);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (m0 + 32 * u >= N) break;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        s[4 * q] += v[u][q].x;
        s[4 * q + 1] += v[u][q].y;
        s[4 * q + 2] += v[u][q].z;
        s[4 * q + 3] += v[u][q].w;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4 * kQ; ++c)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], o);
  if (lane == 0) {
    float* d = deg + (long long)b * 4 * kQ * N + n;
#pragma unroll
    for (int c = 0; c < 4 * kQ; ++c) d[c * N] = gcn::inv_sqrt_degree(s[c]);
  }
}

// The row-of-all-channels kernel takes C = 4 or 8 channels-last, 16-byte
// aligned.
bool takes_quad(const float* adj, int C, long long sb, long long sc, long long sn,
                long long sm) {
  return sc == 1 && (C == 4 || C == 8) && sm % 4 == 0 && sn % 4 == 0 && sb % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(adj) & 15) == 0;
}

}  // namespace

// adj (B, C, N, N) in strides (sb, sc, sn, sm) -> deg (B, C, N), contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gcn_degrees_run(const float* adj, float* deg, int B, int C, int N,
                               long long sb, long long sc, long long sn, long long sm,
                               int add_loop, float loop, void* stream) {
  const bool quad = takes_quad(adj, C, sb, sc, sn, sm);
  const long long rows = (long long)B * (quad ? 1 : C) * N;
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (quad && C == 8)
    gcn_degrees_quad_kernel<2><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        adj, deg, N, rows, sb, sn, sm, add_loop, loop);
  else if (quad)
    gcn_degrees_quad_kernel<1><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        adj, deg, N, rows, sb, sn, sm, add_loop, loop);
  else
    gcn_degrees_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        adj, deg, C, N, rows, sb, sc, sn, sm, add_loop, loop);
  return (int)cudaGetLastError();
}
