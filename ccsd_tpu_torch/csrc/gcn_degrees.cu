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
// element: bytes.  A warp reads its row with consecutive lanes on
// consecutive m (coalesced where the row is dense; a channels-last
// adjacency has the row at stride C, and the other channels' warps find
// the rest of each sector in L2).  The adjacency is read through its four
// strides, so no layout needs a copy.

#include "gcn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

}  // namespace

// adj (B, C, N, N) in strides (sb, sc, sn, sm) -> deg (B, C, N), contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gcn_degrees_run(const float* adj, float* deg, int B, int C, int N,
                               long long sb, long long sc, long long sn, long long sm,
                               int add_loop, float loop, void* stream) {
  const long long rows = (long long)B * C * N;
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  gcn_degrees_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      adj, deg, C, N, rows, sb, sc, sn, sm, add_loop, loop);
  return (int)cudaGetLastError();
}
