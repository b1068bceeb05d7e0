// Graph multi-head (GMH) attention of every channel of a layer, one block
// per (graph, channel).
//
// Replaces: gmh_attention_pallas, ccsd_tpu/ops/pallas/gmh_attention.py:62-114
// (body _gmh_kernel :30-59).  The Pallas grid (B,) ran one channel per call;
// here the grid is (B, C), so one launch covers a whole AttentionLayer.
//
//   norm    = D^-1/2 A'_c D^-1/2            (A'_c: diagonal set to `loop`)
//   Q, K, V = norm (X W_{q,k,v}[c]) + b_{q,k,v}[c]
//   S_h     = Q_h K_h^T / sqrt(F_out)       (head h = columns [h*ds,(h+1)*ds))
//   A       = mean_h tanh(S_h)
//   outputs   V into v_out[b, n, c*F_out + o]   (the channel concat)
//             (A + A^T)/2 into a_out[b, n, m, c] (channels last)
//
// What bounds it on H100: at the sampler's widest layer (B=128, C=8, N=20,
// F_in = attn = F_out = 32) one launch moves ~6 MB and does ~230 MFLOP of
// f32 FMA work (projection, aggregation, scores) plus ~1.6 M tanh: 1.9 us
// of bytes at 3.35 TB/s against 3.4 us of operations at 67 TFLOP/s, so
// operations bound it.  Each block is small (N=20), so the block's serial
// phases (load, project, aggregate, score, symmetrise) and the launch are
// what it waits on in practice.
// What the design does about it: one launch per layer instead of one per
// channel; the normalised adjacency is built once and used for Q, K and V;
// X, XW, Q, K and the N x N score accumulator stay in shared memory, and
// the map is symmetrised only once the whole accumulator is there.  Plain
// f32 FMAs and tanhf; tensor cores are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

__global__ void __launch_bounds__(kThreads)
gmh_attention_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                     const float* __restrict__ wq, const float* __restrict__ bq,
                     const float* __restrict__ wk, const float* __restrict__ bk,
                     const float* __restrict__ wv, const float* __restrict__ bv,
                     float* __restrict__ v_out, float* __restrict__ a_out,
                     int C, int N, int Fi, int A, int O, int H, int ds,
                     float score_div, int add_loop, float loop) {
  extern __shared__ float smem[];
  const int P = 2 * A + O;           // projected width: [q | k | v]
  float* sA = smem;                  // N*N   A' with the diagonal set
  float* sD = sA + N * N;            // N     d
  float* sX = sD + N;                // N*Fi  X
  float* sT = sX + N * Fi;           // N*P   X [Wq | Wk | Wv]
  float* sQ = sT + N * P;            // N*A
  float* sK = sQ + N * A;            // N*A
  float* sS = sK + N * A;            // N*N   mean_h tanh(S_h)

  const int b = blockIdx.x, c = blockIdx.y;
  const float* ab = adj + ((size_t)b * C + c) * N * N;
  const float* xb = x + (size_t)b * N * Fi;
  const float* wqc = wq + (size_t)c * Fi * A;
  const float* wkc = wk + (size_t)c * Fi * A;
  const float* wvc = wv + (size_t)c * Fi * O;

  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N, col = i - r * N;
    sA[i] = (add_loop && r == col) ? loop : ab[i];
  }
  for (int i = threadIdx.x; i < N * Fi; i += blockDim.x) sX[i] = xb[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < N; r += nwarps) {
    float s = 0.f;
    for (int col = lane; col < N; col += 32) s += sA[r * N + col];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sD[r] = 1.0f / sqrtf(fmaxf(s, 1.0f));
  }
  for (int i = threadIdx.x; i < N * P; i += blockDim.x) {
    const int r = i / P, p = i - r * P;
    const float* wcol;
    int stride;
    if (p < A) { wcol = wqc + p; stride = A; }
    else if (p < 2 * A) { wcol = wkc + (p - A); stride = A; }
    else { wcol = wvc + (p - 2 * A); stride = O; }
    float s = 0.f;
    for (int k = 0; k < Fi; ++k) s = fmaf(sX[r * Fi + k], __ldg(wcol + k * stride), s);
    sT[i] = s;
  }
  __syncthreads();

  // Q, K into shared memory; V straight to its slot of the channel concat
  for (int i = threadIdx.x; i < N * P; i += blockDim.x) {
    const int r = i / P, p = i - r * P;
    float s = 0.f;
    for (int j = 0; j < N; ++j) s = fmaf(sA[r * N + j] * sD[j], sT[j * P + p], s);
    s *= sD[r];
    if (p < A) {
      sQ[r * A + p] = s + (bq ? __ldg(bq + c * A + p) : 0.f);
    } else if (p < 2 * A) {
      sK[r * A + (p - A)] = s + (bk ? __ldg(bk + c * A + (p - A)) : 0.f);
    } else {
      const int o = p - 2 * A;
      v_out[((size_t)b * N + r) * C * O + (size_t)c * O + o] =
          s + (bv ? __ldg(bv + c * O + o) : 0.f);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) {
      const float* q = sQ + n * A + h * ds;
      const float* k = sK + m * A + h * ds;
      float s = 0.f;
      for (int d = 0; d < ds; ++d) s = fmaf(q[d], k[d], s);
      acc += tanhf(s / score_div);
    }
    sS[i] = acc / (float)H;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    a_out[(((size_t)b * N + n) * N + m) * C + c] = (sS[i] + sS[m * N + n]) * 0.5f;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int gmh_attention_f32(const float* x, const float* adj,
                                 const float* wq, const float* bq,
                                 const float* wk, const float* bk,
                                 const float* wv, const float* bv,
                                 float* v_out, float* a_out, int B, int C, int N,
                                 int Fi, int A, int O, int H, int ds,
                                 float score_div, int add_loop, float loop,
                                 void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gmh_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = sizeof(float) *
      (2 * (size_t)N * N + N + (size_t)N * Fi + (size_t)N * (2 * A + O) + 2 * (size_t)N * A);
  dim3 grid(B, C);
  gmh_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, wq, bq, wk, bk, wv, bv, v_out, a_out, C, N, Fi, A, O, H, ds,
      score_div, add_loop, loop);
  return (int)cudaGetLastError();
}
