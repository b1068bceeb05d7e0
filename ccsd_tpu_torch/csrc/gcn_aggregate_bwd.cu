// Backward of the degree-normalised GCN aggregation (gcn_aggregate.cu), one
// block per graph, then a deterministic sum of the weight and bias partials
// over the batch.
//
// Replaces: the gradient of gcn_aggregate_pallas (ccsd_tpu/ops/pallas/
// gcn.py:45-85).  The Pallas kernel has no backward of its own: the JAX
// package trains through jax.grad of the plain layer it computes,
// DenseGCNConv.apply (ccsd_tpu/models/gcn.py:51-67).  This is the backward
// of the port's kernel of that function.
//
//   forward    Y = X W;  out = norm Y + bias      (norm: grad_common.cuh)
//   backward   G = dL/dout
//              dY = norm^T G;   dX = dY W^T;   dW = sum_b X^T dY;
//              dbias = sum_{b, n} G;   gN = G Y^T -> dA (grad_common.cuh)
//
// Nothing of the forward is saved: the block recomputes d, norm and Y from
// X, A and W, which it stages anyway.
//
// What bounds it on H100: at community_small's training shapes (B = 80,
// N = 20, F <= 32) one call moves ~0.6 MB and does ~10 MFLOP, about 0.2 us
// of either (bytes bound it), so the block's chain of short phases between
// barriers bounds it in practice.  This first design is plain: one output
// a thread in every product, operands read from shared memory (W and Y,
// read down a column across a warp, at an odd stride: no bank conflicts),
// the per-graph partials of dW and dbias written to device memory and
// summed over the batch by a second, small launch (strided_sum), in graph
// order.  dA is computed only when asked for (a null pointer skips it), as
// is dX.  One graph a block, so N is at most 64 (the wrapper raises above).

#include "grad_common.cuh"

namespace {

// Shared layout (floats): A' N x N | X N x Fi | W Fi x ldw | G N x Fo |
// Y N x ldw | dY N x Fo | gN N x N | d, slope, dr N each.  W (in dX = dY
// W^T) and Y (in gN = G Y^T) are read down a column by a warp: their odd
// row stride puts 32 rows in 32 banks.
struct Layout {
  int ldw, x, w, g, y, dy, gn, d, slope, dr, total;
  __host__ __device__ Layout(int N, int Fi, int Fo) {
    ldw = Fo | 1;
    x = N * N;
    w = x + N * Fi;
    g = w + Fi * ldw;
    y = g + N * Fo;
    dy = y + N * ldw;
    gn = dy + N * Fo;
    d = gn + N * N;
    slope = d + N;
    dr = slope + N;
    total = dr + N;
  }
};

__global__ void __launch_bounds__(grad::kThreads)
gcn_aggregate_bwd_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                         const float* __restrict__ w, const float* __restrict__ g,
                         float* __restrict__ dx, float* __restrict__ dadj,
                         float* __restrict__ part, int N, int Fi, int Fo, int add_loop,
                         float loop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, Fi, Fo);
  const int ldw = L.ldw;
  float* sA = smem;
  float* sX = smem + L.x;
  float* sW = smem + L.w;
  float* sG = smem + L.g;
  float* sY = smem + L.y;
  float* sDY = smem + L.dy;
  float* sGN = smem + L.gn;
  float* sD = smem + L.d;
  float* sS = smem + L.slope;
  const int b = blockIdx.x;

  grad::load_tile(sA, N, adj + static_cast<size_t>(b) * N * N, N, 1, N, N);
  grad::load_tile(sX, Fi, x + static_cast<size_t>(b) * N * Fi, Fi, 1, N, Fi);
  grad::load_tile(sW, ldw, w, Fo, 1, Fi, Fo);
  grad::load_tile(sG, Fo, g + static_cast<size_t>(b) * N * Fo, Fo, 1, N, Fo);
  __syncthreads();
  grad::degrees(sA, N, N, add_loop, loop, sD, sS);
  __syncthreads();

  // Y = X W;  dY[m] = d_m sum_n A'[n, m] d_n G[n]
  grad::product(
      N, Fo, Fi, [&](int r, int k) { return sX[r * Fi + k]; },
      [&](int k, int c) { return sW[k * ldw + c]; },
      [&](int r, int c, float v) { sY[r * ldw + c] = v; });
  grad::product(
      N, Fo, N, [&](int m, int n) { return sA[n * N + m] * sD[n]; },
      [&](int n, int c) { return sG[n * Fo + c]; },
      [&](int m, int c, float v) { sDY[m * Fo + c] = sD[m] * v; });
  __syncthreads();

  // dX = dY W^T;  this graph's dW = X^T dY and dbias = sum_n G[n]
  if (dx != nullptr) {
    float* out = dx + static_cast<size_t>(b) * N * Fi;
    grad::product(
        N, Fi, Fo, [&](int r, int k) { return sDY[r * Fo + k]; },
        [&](int k, int c) { return sW[c * ldw + k]; },
        [&](int r, int c, float v) { out[r * Fi + c] = v; });
  }
  float* pb = part + static_cast<size_t>(b) * (Fi * Fo + Fo);
  grad::product(
      Fi, Fo, N, [&](int f, int n) { return sX[n * Fi + f]; },
      [&](int n, int c) { return sDY[n * Fo + c]; },
      [&](int f, int c, float v) { pb[f * Fo + c] = v; });
  for (int c = threadIdx.x; c < Fo; c += blockDim.x) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += sG[n * Fo + c];
    pb[Fi * Fo + c] = s;
  }
  if (dadj == nullptr) return;

  // gN = G Y^T, then dA
  grad::product(
      N, N, Fo, [&](int n, int k) { return sG[n * Fo + k]; },
      [&](int k, int m) { return sY[m * ldw + k]; },
      [&](int n, int m, float v) { sGN[n * N + m] = v; });
  __syncthreads();
  grad::adj_grad(sGN, sA, N, sD, sS, N, add_loop, smem + L.dr,
                 dadj + static_cast<size_t>(b) * N * N, N, 1);
}

}  // namespace

// Shared bytes of a block (one graph).
extern "C" int gcn_aggregate_bwd_smem(int N, int Fi, int Fo) {
  return static_cast<int>(sizeof(float)) * Layout(N, Fi, Fo).total;
}

// x (B, N, F_in), adj (B, N, N), w (F_in, F_out), g = dL/dout (B, N, F_out),
// all contiguous -> dx (B, N, F_in) or null, dadj (B, N, N) or null, and
// out_w (F_in * F_out + F_out): dW then dbias.  part (B, F_in * F_out +
// F_out) is scratch for the per-graph partials.  Two launches on `stream`
// (the graphs, then the batch sum); returns the first non-zero cudaError_t
// (0 on success).
extern "C" int gcn_aggregate_bwd_run(const float* x, const float* adj, const float* w,
                                     const float* g, float* dx, float* dadj, float* part,
                                     float* out_w, int B, int N, int Fi, int Fo, int add_loop,
                                     float loop, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gcn_aggregate_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gmh::kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = gcn_aggregate_bwd_smem(N, Fi, Fo);
  if (smem > gmh::kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  gcn_aggregate_bwd_kernel<<<B, grad::kThreads, smem, s>>>(x, adj, w, g, dx, dadj, part, N, Fi,
                                                          Fo, add_loop, loop);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int len = Fi * Fo + Fo;
  return grad::launch_strided_sum(part, out_w, len, B, len, len, 0, s);
}
