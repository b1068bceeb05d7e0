// Channel-folded GCN aggregation of the fused AttentionLayer, one block per
// graph and 16 folded rows.
//
// Replaces: agg_pallas, tools/probe_pallas_agg.py:43-51 (body _agg_kernel
// :34-40), and agg_pallas_2d, tools/probe_pallas_agg.py:64-73 (body
// _agg_kernel_2d :54-61).  Both compute the same sum and differ only in how
// the TPU lays out the loop (batch in lanes; (c, n) folded into rows in the
// second).  Here the batch is outermost and the rows are always folded:
//
//   out[b, r, f] = sum_m norm[b, r, m] * x[b, m, f]     r = c * N + n
//
// so norm (B, C, N, N) and its (B, C*N, N) view are the same input.
//
// What bounds it on H100: at the sampler's widest layer (B=128, C=8, N=20,
// F=32) one launch reads 1.6 MB of norm and 0.33 MB of x and writes 2.6 MB,
// ~1.4 us at 3.35 TB/s, against 26 MFLOP (0.4 us at 67 TFLOP/s of f32):
// bytes bound it.  At these sizes the launch and the block's two serial
// phases (load, then sum) are what it waits on in practice.
// What the design does about it: the grid is (B, ceil(C*N / 16)), 1,280
// blocks at C=8, so every SM has blocks in flight (one block per graph,
// 128 blocks, took 11.0 us against cuBLAS's 8.0 us on an H100 SXM at
// 700 W, chip_smoke.py).  A block holds its
// 16 norm rows and the graph's x (2.5 KB at F=32) in shared memory; each
// norm element is read from device memory once and x once per block (the
// repeats hit L2), each x column serves 16 rows and each norm row F
// outputs, and consecutive threads write consecutive outputs.  Plain f32
// FMAs in order of m; tensor cores are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // folded rows (c, n) per block
constexpr int kMaxSmem = 232448;

__global__ void __launch_bounds__(kThreads)
channel_agg_kernel(const float* __restrict__ norm, const float* __restrict__ x,
                   float* __restrict__ out, int R, int N, int F) {
  extern __shared__ float smem[];
  float* sN = smem;            // rows*N  this block's norm rows of graph b
  float* sX = sN + kRows * N;  // N*F     x of graph b

  const int b = blockIdx.x, r0 = blockIdx.y * kRows;
  const int rows = min(kRows, R - r0);
  const float* nb = norm + ((size_t)b * R + r0) * N;
  const float* xb = x + (size_t)b * N * F;
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) sN[i] = nb[i];
  for (int i = threadIdx.x; i < N * F; i += blockDim.x) sX[i] = xb[i];
  __syncthreads();

  float* ob = out + ((size_t)b * R + r0) * F;
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
    const int r = i / F, f = i - r * F;
    const float* row = sN + r * N;
    float s = 0.f;
    for (int m = 0; m < N; ++m) s = fmaf(row[m], sX[m * F + f], s);
    ob[i] = s;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int channel_agg_f32(const float* norm, const float* x, float* out,
                               int B, int R, int N, int F, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        channel_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = sizeof(float) * ((size_t)kRows * N + (size_t)N * F);
  dim3 grid(B, (R + kRows - 1) / kRows);
  channel_agg_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(norm, x, out, R, N, F);
  return (int)cudaGetLastError();
}
