// Head scores of the fused AttentionLayer, one block per graph and group of
// channels.
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
// Product type:
//   f32   everything in f32 (scores_impl mulreduce / mulreduce_h / dot):
//         register-tiled FMAs, 4 x 4 head sums a thread (gmh_common.cuh).
//   bf16  the rounding points of scores_impl="mulreduce_h_bf16"
//         (attention.py:310-318) as XLA compiles it: Q and K are rounded to
//         bf16 (round to nearest even), their products are exact in f32 and
//         summed in f32, s_h is rounded to bf16 once, and tanh and the head
//         mean are f32.  Here the head products run on the tensor cores:
//         mma.sync m16n8k8 bf16 tiles with f32 accumulators, one warp a
//         strip of 16 rows of one head, its operands rounded to bf16 as they
//         are packed into registers from the f32 rows in shared memory (a
//         separate pass writing bf16 tiles for ldmatrix, and its barrier,
//         cost more than the products at these sizes).  The tensor core's
//         f32 accumulation order may move a head sum by a few f32 ulps,
//         which at a bf16 rounding boundary moves the rounded sum by one
//         bf16 ulp.
//
// Q and K may be strided views (the Q and K column blocks of one projected
// tensor): strides of b, c and n are given, the feature stride is 1.
//
// What bounds it on H100: at the sampler's widest layer (B=128, C=8, N=20,
// attn=32) one launch reads 5.2 MB of Q and K and writes 1.6 MB, ~2.1 us at
// 3.35 TB/s, against ~32 MFLOP and 51 K tanh per graph-channel: bytes bound
// it.  In practice a launch of this size waits on the launch itself, each
// block's chain of load, barrier, products, barrier and store, and the
// instructions of the tanh stage (PERF.md, scripts/gmh_stage_times.py).
// What this design does about it: a block takes one graph and a group of G
// channels (the wrapper picks G: all C while the grid keeps a block on
// every SM, fewer otherwise).  It issues the cp.async copies of every
// channel's Q and K at once (16-byte copies into rows padded for
// conflict-free reads) and, past one barrier, works on all of them
// together: the head sums of all channels go to shared memory, and one pass
// takes the tanh, head mean and symmetrisation of each pair n <= m once and
// writes (n, m) and (m, n) for the group's channels as runs of G floats in
// 16-byte stores (with G = C, C consecutive floats).  The tanh of the
// padding of a tensor-core tile is never taken.

#include "gmh_common.cuh"

namespace {

using namespace gmh;

constexpr int kSumTM = 4, kSumTN = 4;  // register patch of the f32 head sums

// Shared-memory layout of one block over G channels, in floats.
struct ScoresLayout {
  int ld;     // row stride of Q and K: 16-byte copies, and conflict-free
              // reads by the products (ld8 for bf16 fragments, ld4 for f32)
  int plane;  // one channel's Q (or K)
  int k;      // offset of the K planes (Q planes at 0)
  int raw;    // each channel's raw head sums, H * raw_plane(N)
  int total;
  __host__ __device__ ScoresLayout(int N, int A, int H, int G, bool bf16) {
    ld = bf16 ? ld8(A) : ld4(A);
    plane = round4(N * ld);
    k = G * plane;
    raw = 2 * G * plane;
    total = raw + G * H * raw_plane(N);
  }
};

// T: the type of q, k and out (float, or bf16: staged as f32, each map
// entry rounded once as it is stored); kBf16: the product type above
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
gmh_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  T* __restrict__ out, int C, int N, int A, int H, int ds, int G,
                  long long qsb, long long qsc, long long qsn,
                  long long ksb, long long ksc, long long ksn, float score_div) {
  extern __shared__ __align__(16) float smem[];
  const ScoresLayout L(N, A, H, G, kBf16);
  float* sQ = smem;
  float* sK = smem + L.k;
  float* sR = smem + L.raw;
  const int rstride = H * raw_plane(N);
  const int b = blockIdx.x, c0 = blockIdx.y * G;
  const int nch = min(G, C - c0);

  for (int g = 0; g < nch; ++g) {
    const int c = c0 + g;
    copy_tile(sQ + g * L.plane, L.ld, q + b * qsb + c * qsc, qsn, 1, N, A);
    copy_tile(sK + g * L.plane, L.ld, k + b * ksb + c * ksc, ksn, 1, N, A);
  }
  cp_async_commit();

  cp_async_wait<0>();
  __syncthreads();
  if (ablated(kHeadSums)) {
    zero_fill(sR, nch * rstride);
  } else if constexpr (kBf16) {
    // items: (channel, head, strip of 16 rows), one warp each
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int per = cdiv(N, 16);
    for (int w = warp; w < nch * H * per; w += nwarps) {
      const int gh = w / per, g = gh / H;
      sum_strip_bf16(w - gh * per, gh - g * H, sQ + g * L.plane, sK + g * L.plane, L.ld,
                     sR + g * rstride, N, ds);
    }
  } else {
    const int per = sum_patches<kSumTM, kSumTN>(N);  // items: (channel, head, patch)
    for (int i = threadIdx.x; i < nch * H * per; i += blockDim.x) {
      const int gh = i / per, g = gh / H;
      sum_patch_f32<kSumTM, kSumTN>(i - gh * per, gh - g * H, sQ + g * L.plane,
                                    sK + g * L.plane, L.ld, sR + g * rstride, N, ds);
    }
  }
  __syncthreads();
  if (!ablated(kStore))
    store_pairs(out + (static_cast<size_t>(b) * N * N) * C + c0, sR, rstride, N, C, nch, H,
                score_div);
}

template <typename T, bool kBf16>
int launch(const T* q, const T* k, T* out, int B, int C, int N, int A,
           int H, int ds, int G, long long qsb, long long qsc, long long qsn,
           long long ksb, long long ksc, long long ksn, float score_div,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gmh_scores_kernel<T, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = static_cast<int>(sizeof(float)) * ScoresLayout(N, A, H, G, kBf16).total;
  if (G < 1 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid(B, cdiv(C, G));
  gmh_scores_kernel<T, kBf16><<<grid, kThreads, smem, stream>>>(
      q, k, out, C, N, A, H, ds, G, qsb, qsc, qsn, ksb, ksc, ksn, score_div);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of one block over G channels: the kernel's layout,
// for the wrapper's choice of G.
extern "C" int gmh_scores_smem(int N, int A, int H, int G, int bf16) {
  return static_cast<int>(sizeof(float)) * ScoresLayout(N, A, H, G, bf16 != 0).total;
}

// G: channels per block.  bf16 != 0 selects the bf16 product type.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int gmh_scores_run(const float* q, const float* k, float* out,
                              int B, int C, int N, int A, int H, int ds, int G,
                              long long qsb, long long qsc, long long qsn,
                              long long ksb, long long ksc, long long ksn,
                              float score_div, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<float, true>(q, k, out, B, C, N, A, H, ds, G, qsb, qsc, qsn,
                                    ksb, ksc, ksn, score_div, s)
              : launch<float, false>(q, k, out, B, C, N, A, H, ds, G, qsb, qsc, qsn,
                                     ksb, ksc, ksn, score_div, s);
}

// The same launch over bf16 q, k and map (N <= 64); bf16 != 0 selects the
// bf16 product type, whose packing of the (already bf16) operands leaves
// their bits as they are.
extern "C" int gmh_scores_bf16_run(const gmh::bf16* q, const gmh::bf16* k, gmh::bf16* out,
                                   int B, int C, int N, int A, int H, int ds, int G,
                                   long long qsb, long long qsc, long long qsn,
                                   long long ksb, long long ksc, long long ksn,
                                   float score_div, int bf16, void* stream) {
  if (N > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<gmh::bf16, true>(q, k, out, B, C, N, A, H, ds, G, qsb, qsc, qsn, ksb,
                                        ksc, ksn, score_div, s)
              : launch<gmh::bf16, false>(q, k, out, B, C, N, A, H, ds, G, qsb, qsc, qsn, ksb,
                                         ksc, ksn, score_div, s);
}

// ------------------------------------------------------ tiled (N > 64)
//
// Above N = 64 a graph's Q, K and N x N head sums do not fit one block: the
// tile-pair stage of gmh_common.cuh takes over, a block per (tile pair,
// channel group, graph) of the wrapper's plan, in f32 or with the bf16
// path's rounding points.  What bounds it on H100 at grid's widest layer
// (B = 8, C = 8, N = 361, attn 32, 4 heads): 5.9 MB of Q and K read and
// 33.4 MB of maps written (11.7 us at 3.35 TB/s), 0.53 GFLOP of products
// (8 us at 67 TFLOP/s), and 33.4 M tanhf, each a sequence of instructions
// with two multi-function-unit operations (exp and reciprocal) on its
// exp branch: the tanh, not the bytes, sets the floor (gmh_tanh_rate_run
// measures its rate on the card: 19.6 us for these 33.4 M on an NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md).  What the design does about it: each
// tanh is taken once, for kept entries only, by the lane that holds both
// directions of the entry, so nothing but the tanh (in bf16 a branch-free
// one of two multi-function-unit operations), the few products (bf16 on
// the tensor cores) and one 32-byte store of each side of an entry
// (C = 8) stand beside it.

// Shared bytes of a block of G channels in the larger of its two layouts
// (bf16's rows are wider), for the wrapper's choice of G.
extern "C" int gmh_tiled_scores_smem(int A, int G) {
  return gmh::tiled_scores_smem<true>(A, G);
}

// pairs: npairs x (I, J), the wrapper's plan; bf16 != 0 selects the bf16
// rounding points.  Returns the cudaError_t of the launch (0 on success).
extern "C" int gmh_tiled_scores_run(const float* q, const float* k, const int* pairs,
                                    float* out, int B, int C, int N, int A, int H, int ds,
                                    int G, int npairs, long long qsb, long long qsc,
                                    long long qsn, long long ksb, long long ksc,
                                    long long ksn, float score_div, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? gmh::tiled_scores_launch<true>(q, k, pairs, out, B, C, N, A, H, ds, G, npairs,
                                               qsb, qsc, qsn, ksb, ksc, ksn, score_div, s)
              : gmh::tiled_scores_launch<false>(q, k, pairs, out, B, C, N, A, H, ds, G,
                                                npairs, qsb, qsc, qsn, ksb, ksc, ksn,
                                                score_div, s);
}

// ------------------------------------------------- the tanhf rate probe
//
// Not a kernel of the path: a measurement of what one tanhf costs on the
// card, for the floor the tanh sets under the score kernels.  Each thread
// runs eight independent chains of v = 1.5 tanhf(v) + 0.1 (one FMA beside
// each tanhf), whose values settle near 1.45: the exp branch of tanhf,
// which the score kernels' larger arguments take.  tanhf calls:
// blocks x 256 x iters x 8.

namespace {

__global__ void __launch_bounds__(256) tanh_rate_kernel(float* out, int iters) {
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = 1e-3f * static_cast<float>(threadIdx.x + 37 * u);
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = fmaf(1.5f, tanhf(v[u]), 0.1f);
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) sum += v[u];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// out: blocks x 256 floats.  Returns the cudaError_t of the launch.
extern "C" int gmh_tanh_rate_run(float* out, int blocks, int iters, void* stream) {
  tanh_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
