// Head scores of the fused AttentionLayer, one block per (graph, channel).
//
// Replaces: make_pallas_reg(dtype, nc), tools/pallas_scores_probe.py:85-104
// (body _scores_reg_kernel :66-82), and make_pallas(dtype),
// tools/pallas_scores_probe.py:127-146 (body _scores_kernel :109-124).  Both
// compute the same scores and differ only in how the TPU walks the rows (NC
// rows held in registers, or one row per fori_loop step); the batch sat in
// lanes there and is outermost here.  Per graph b and channel c:
//
//   att[n, m] = (1/H) sum_h tanh(s_h[n, m] / score_div)
//   s_h[n, m] = sum_{d < ds} Q[b, c, n, h*ds + d] * K[b, c, m, h*ds + d]
//   out[b, n, m, c] = (att[n, m] + att[m, n]) / 2
//
// score_div is sqrt(F_out) of the layer, not sqrt(ds).  The store folds the
// symmetrisation and the channels-last layout of the JAX layer
// (ccsd_tpu/models/attention.py:327, :332) into the write.
//
// Product type T:
//   float          everything in f32 (scores_impl mulreduce / mulreduce_h /
//                  dot).
//   __nv_bfloat16  the rounding points of scores_impl="mulreduce_h_bf16"
//                  (attention.py:310-318) as XLA compiles it: Q and K are
//                  rounded to bf16 (round to nearest even), their products
//                  are exact in f32 and summed in f32, s_h is rounded to bf16
//                  once, and tanh and the head mean are f32.  The Pallas
//                  probes' bf16 variants round at every add instead; this
//                  kernel follows the model path.
//
// Q and K may be strided views (the Q and K column blocks of one projected
// tensor): strides of b, c and n are given, the feature stride is 1.
//
// What bounds it on H100: at the sampler's widest layer (B=128, C=8, N=20,
// attn=32) one launch reads 5.2 MB of Q and K and writes 1.6 MB, ~2.1 us at
// 3.35 TB/s, against ~32 MFLOP and 51 K tanh per graph-channel (0.5 us at
// 67 TFLOP/s of f32): bytes bound it.  At N=20 the launch and the block's
// serial phases are what it waits on in practice.
// What the design does about it: Q and K of a (graph, channel) are read once
// into shared memory (rows padded to attn+1 floats, so the 32 threads of a
// warp reading 32 K rows hit 32 banks), one thread per (n, m) keeps the
// head loop in registers, and the N x N map is symmetrised from shared
// memory before the one store.  Plain f32 FMAs and tanhf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

// A value as the product type T holds it, back in f32.
template <typename T>
__device__ __forceinline__ float as_product_type(float v);

template <>
__device__ __forceinline__ float as_product_type<float>(float v) { return v; }

template <>
__device__ __forceinline__ float as_product_type<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmh_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  float* __restrict__ out, int C, int N, int A, int H, int ds,
                  long long qsb, long long qsc, long long qsn,
                  long long ksb, long long ksc, long long ksn, float score_div) {
  extern __shared__ float smem[];
  const int ld = A + 1;          // padded row stride of sQ and sK
  float* sQ = smem;              // N*ld
  float* sK = sQ + N * ld;       // N*ld
  float* sS = sK + N * ld;       // N*N  att before symmetrisation

  const int b = blockIdx.x, c = blockIdx.y;
  const float* qb = q + b * qsb + c * qsc;
  const float* kb = k + b * ksb + c * ksc;
  for (int i = threadIdx.x; i < N * A; i += blockDim.x) {
    const int n = i / A, a = i - n * A;
    sQ[n * ld + a] = as_product_type<T>(qb[n * qsn + a]);
    sK[n * ld + a] = as_product_type<T>(kb[n * ksn + a]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    const float* qr = sQ + n * ld;
    const float* kr = sK + m * ld;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) {
      float s = 0.f;
      for (int d = h * ds; d < (h + 1) * ds; ++d) s = fmaf(qr[d], kr[d], s);
      acc += tanhf(as_product_type<T>(s) / score_div);
    }
    sS[i] = acc / (float)H;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    out[(((size_t)b * N + n) * N + m) * C + c] = (sS[i] + sS[m * N + n]) * 0.5f;
  }
}

template <typename T>
int launch(const float* q, const float* k, float* out, int B, int C, int N,
           int A, int H, int ds, long long qsb, long long qsc, long long qsn,
           long long ksb, long long ksc, long long ksn, float score_div,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gmh_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = sizeof(float) * (2 * (size_t)N * (A + 1) + (size_t)N * N);
  dim3 grid(B, C);
  gmh_scores_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, k, out, C, N, A, H, ds, qsb, qsc, qsn, ksb, ksc, ksn, score_div);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0 selects the bf16 product type.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int gmh_scores_run(const float* q, const float* k, float* out,
                              int B, int C, int N, int A, int H, int ds,
                              long long qsb, long long qsc, long long qsn,
                              long long ksb, long long ksc, long long ksn,
                              float score_div, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(q, k, out, B, C, N, A, H, ds, qsb, qsc, qsn,
                                      ksb, ksc, ksn, score_div, s)
              : launch<float>(q, k, out, B, C, N, A, H, ds, qsb, qsc, qsn,
                              ksb, ksc, ksn, score_div, s);
}
