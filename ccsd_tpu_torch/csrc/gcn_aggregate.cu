// Degree-normalised dense GCN aggregation, one block per graph.
//
// Replaces: gcn_aggregate_pallas, ccsd_tpu/ops/pallas/gcn.py:45-85 (body
// _gcn_kernel :31-42), whose Pallas grid (B,) becomes the CUDA grid (B,).
//
//   A'  = A with the diagonal set to `loop` (when add_loop)
//   d   = max(rowsum A', 1)^-1/2
//   out = (d * A' * d^T) (X W) + bias
//
// What bounds it on H100: at the sampler's shapes (B=128, N=20, F<=32) one
// call moves ~0.9 MB and does ~9 MFLOP, about 0.26 us at 3.35 TB/s (bytes
// bound it; 0.13 us at 67 TFLOP/s of f32), so in practice the launch and
// the block's serial phases bound it.
// What the design does about it: one launch per layer; the graph's A', d,
// X and XW live in shared memory, so nothing between the two products
// touches device memory, as in the Pallas kernel's VMEM.  Plain f32 FMAs;
// tensor cores, TMA and wgmma are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

__global__ void __launch_bounds__(kThreads)
gcn_aggregate_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     float* __restrict__ out, int N, int Fi, int Fo,
                     int add_loop, float loop) {
  extern __shared__ float smem[];
  float* sA = smem;            // N*N   A' with the diagonal set
  float* sD = sA + N * N;      // N     d
  float* sX = sD + N;          // N*Fi  X
  float* sXW = sX + N * Fi;    // N*Fo  X W

  const int b = blockIdx.x;
  const float* ab = adj + (size_t)b * N * N;
  const float* xb = x + (size_t)b * N * Fi;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N, c = i - r * N;
    sA[i] = (add_loop && r == c) ? loop : ab[i];
  }
  for (int i = threadIdx.x; i < N * Fi; i += blockDim.x) sX[i] = xb[i];
  __syncthreads();

  // degree: one warp per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < N; r += nwarps) {
    float s = 0.f;
    for (int c = lane; c < N; c += 32) s += sA[r * N + c];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sD[r] = 1.0f / sqrtf(fmaxf(s, 1.0f));
  }
  // X W: neighbouring threads read neighbouring columns of W
  for (int i = threadIdx.x; i < N * Fo; i += blockDim.x) {
    const int r = i / Fo, f = i - r * Fo;
    float s = 0.f;
    for (int k = 0; k < Fi; ++k) s = fmaf(sX[r * Fi + k], __ldg(w + k * Fo + f), s);
    sXW[i] = s;
  }
  __syncthreads();

  float* ob = out + (size_t)b * N * Fo;
  for (int i = threadIdx.x; i < N * Fo; i += blockDim.x) {
    const int r = i / Fo, f = i - r * Fo;
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(sA[r * N + j] * sD[j], sXW[j * Fo + f], s);
    float v = sD[r] * s;
    if (bias != nullptr) v += __ldg(bias + f);
    ob[i] = v;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int gcn_aggregate_f32(const float* x, const float* adj, const float* w,
                                 const float* bias, float* out, int B, int N,
                                 int Fi, int Fo, int add_loop, float loop,
                                 void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gcn_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = sizeof(float) * ((size_t)N * N + N + (size_t)N * Fi + (size_t)N * Fo);
  gcn_aggregate_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, w, bias, out, N, Fi, Fo, add_loop, loop);
  return (int)cudaGetLastError();
}
