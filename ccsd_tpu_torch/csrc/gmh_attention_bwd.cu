// Backward of the GMH attention of every channel of a layer
// (gmh_attention.cu), one block per (graph, channel), then deterministic
// sums of the per-block partials: the weight and bias gradients over the
// graphs, the input's gradient over the channels.
//
// Replaces: the gradient of gmh_attention_pallas (ccsd_tpu/ops/pallas/
// gmh_attention.py:62-114).  The Pallas kernel has no backward of its own:
// the JAX package trains through jax.grad of the plain layer it computes,
// Attention.apply (ccsd_tpu/models/attention.py:63-93).  This is the
// backward of the port's kernel of that function.
//
//   forward    NX = norm X (norm: grad_common.cuh);  [Q | K | V] = NX W + b
//              S_h = s Q_h K_h^T (s = 1 / score_div);  M = mean_h tanh(S_h)
//              outputs V and (M + M^T) / 2
//   backward   gM = (gA + gA^T) / 2
//              gS_h = s gM (1 - tanh(S_h)^2) / H
//              gQ_h = gS_h K_h;  gK_h = gS_h^T Q_h;  gP = [gQ | gK | gV]
//              dW = sum_b NX^T gP;  db = sum_{b, n} gP;  gNX = gP W^T
//              dX = sum_c norm^T gNX;  gN = gNX X^T -> dA (grad_common.cuh)
//
// Nothing of the forward is saved: the block recomputes d, norm, NX, Q, K
// and the head scores from X, A and the weights (saving the tanh of every
// head would cost B C H N^2 floats a layer).
//
// What bounds it on H100: at community_small's widest training layer
// (B = 80, C = 8, N = 20, F_in = attn = F_out = 32) the call reads and
// writes ~5.3 MB (1.6 us at 3.35 TB/s) and does ~0.32 GFLOP (4.8 us of f32
// operations), so operations bound it.  This first design is plain: one output a
// thread in every product, each FMA two loads from shared memory, so the
// shared-memory pipe and the nine phases between barriers bound it in
// practice; 8 MB of per-block weight partials go to device memory and
// back, summed by two small launches of strided_sum in a fixed order.
// The products that read a matrix down a column across a warp (W in gNX,
// X in gN, K in the head scores, the gS planes) see it at an odd stride:
// with the stride a multiple of 32 floats those reads were 32-way bank
// conflicts (PERF.md).  dX and dA are computed only when asked for
// (null pointers skip them).  The
// adjacency is read, and its gradient written, through their strides, so
// a later layer's channels-last adjacency gets a channels-last gradient.
// One (graph, channel) a block holds N <= 64 (the wrapper raises above).

#include "grad_common.cuh"

namespace {

// Shared layout (floats): A' N x N | X N x ldx | W Fi x ldw | bias P |
// norm N x N | NX N x Fi | Q, K N x ldq each | gM (then gN) N x N |
// gS H planes of gs_plane (plane 0 first holds the raw gA) | gP N x P |
// gNX N x Fi | d, slope, dr.  The matrices a warp reads down a column
// (W in gNX = gP W^T, X in gN = gNX X^T, K in the head scores) and the gS
// planes have odd strides, so that 32 rows fall in 32 banks.
struct Layout {
  int P, ldx, ldw, ldq, gs_plane;
  int x, w, bias, norm, nx, q, k, gm, gs, gp, gnx, d, slope, dr, total;
  __host__ __device__ Layout(int N, int Fi, int A, int O, int H) {
    P = 2 * A + O;
    ldx = Fi | 1;
    ldw = P | 1;
    ldq = A | 1;
    gs_plane = (N * N) | 1;
    x = N * N;
    w = x + N * ldx;
    bias = w + Fi * ldw;
    norm = bias + P;
    nx = norm + N * N;
    q = nx + N * Fi;
    k = q + N * ldq;
    gm = k + N * ldq;
    gs = gm + N * N;
    gp = gs + H * gs_plane;
    gnx = gp + N * P;
    d = gnx + N * Fi;
    slope = d + N;
    dr = slope + N;
    total = dr + N;
  }
};

// Offsets (floats) of the six gradients in a graph's partial, and in the
// summed output: dWq (C, Fi, A) | dWk (C, Fi, A) | dWv (C, Fi, O) |
// dbq (C, A) | dbk (C, A) | dbv (C, O).
struct Grads {
  int wq, wk, wv, bq, bk, bv, total;
  __host__ __device__ Grads(int C, int Fi, int A, int O) {
    wq = 0;
    wk = C * Fi * A;
    wv = 2 * C * Fi * A;
    bq = wv + C * Fi * O;
    bk = bq + C * A;
    bv = bk + C * A;
    total = bv + C * O;
  }
};

__global__ void __launch_bounds__(grad::kThreads)
gmh_attention_bwd_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                         const float* __restrict__ wq, const float* __restrict__ bq,
                         const float* __restrict__ wk, const float* __restrict__ bk,
                         const float* __restrict__ wv, const float* __restrict__ bv,
                         const float* __restrict__ gv, const float* __restrict__ ga,
                         float* __restrict__ dadj, float* __restrict__ part_x,
                         float* __restrict__ part_w, int C, int N, int Fi, int A, int O, int H,
                         int ds, long long as_b, long long as_c, long long as_n,
                         long long as_m, long long gs_b, long long gs_n, long long gs_m,
                         long long gs_c, long long ds_b, long long ds_c, long long ds_n,
                         long long ds_m, float score_div, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, Fi, A, O, H);
  const Grads G(C, Fi, A, O);
  const int P = L.P, ldx = L.ldx, ldw = L.ldw, ldq = L.ldq;
  float* sA = smem;
  float* sX = smem + L.x;
  float* sW = smem + L.w;
  float* sBias = smem + L.bias;
  float* sNorm = smem + L.norm;
  float* sNX = smem + L.nx;
  float* sQ = smem + L.q;
  float* sK = smem + L.k;
  float* sGM = smem + L.gm;
  float* sGS = smem + L.gs;
  float* sGP = smem + L.gp;
  float* sGNX = smem + L.gnx;
  float* sD = smem + L.d;
  float* sS = smem + L.slope;
  const int b = blockIdx.x, c = blockIdx.y;
  const float s = 1.0f / score_div;

  // the adjacency of (b, c) and the raw gA (into gS) through their
  // strides; X of the graph; [Wq | Wk | Wv] of channel c and its bias; gV
  // of channel c into the V columns of gP
  grad::load_tile(sA, N, adj + b * as_b + c * as_c, as_n, as_m, N, N);
  grad::load_tile(sGS, N, ga + b * gs_b + c * gs_c, gs_n, gs_m, N, N);
  grad::load_tile(sX, ldx, x + static_cast<size_t>(b) * N * Fi, Fi, 1, N, Fi);
  const float* w[3] = {wq + static_cast<size_t>(c) * Fi * A,
                       wk + static_cast<size_t>(c) * Fi * A,
                       wv + static_cast<size_t>(c) * Fi * O};
  const float* bias[3] = {bq ? bq + c * A : nullptr, bk ? bk + c * A : nullptr,
                          bv ? bv + c * O : nullptr};
  for (int m = 0; m < 3; ++m) {
    const int off = m * A, width = m < 2 ? A : O;
    grad::load_tile(sW + off, ldw, w[m], width, 1, Fi, width);
    for (int i = threadIdx.x; i < width; i += blockDim.x)
      sBias[off + i] = bias[m] ? bias[m][i] : 0.f;
  }
  grad::load_tile(sGP + 2 * A, P, gv + static_cast<size_t>(b) * N * C * O + c * O, C * O, 1,
                  N, O);
  __syncthreads();

  // degrees of A' (the diagonal set to `loop`), and gM = (gA + gA^T) / 2
  grad::degrees(sA, N, N, add_loop, loop, sD, sS);
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    sGM[i] = 0.5f * (sGS[n * N + m] + sGS[m * N + n]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int n = i / N, m = i - n * N;
    sNorm[i] = sD[n] * sA[i] * sD[m];
  }
  __syncthreads();

  // NX = norm X
  grad::product(
      N, Fi, N, [&](int r, int k) { return sNorm[r * N + k]; },
      [&](int k, int f) { return sX[k * ldx + f]; },
      [&](int r, int f, float v) { sNX[r * Fi + f] = v; });
  __syncthreads();

  // Q, K = NX [Wq | Wk] + bias
  grad::product(
      N, 2 * A, Fi, [&](int r, int k) { return sNX[r * Fi + k]; },
      [&](int k, int p) { return sW[k * ldw + p]; },
      [&](int r, int p, float v) {
        v += sBias[p];
        if (p < A)
          sQ[r * ldq + p] = v;
        else
          sK[r * ldq + p - A] = v;
      });
  __syncthreads();

  // gS_h[n, m] = s gM[n, m] (1 - tanh(S_h[n, m])^2) / H
  const float gscale = s / static_cast<float>(H);
  for (int i = threadIdx.x; i < H * N * N; i += blockDim.x) {
    const int h = i / (N * N), nm = i - h * N * N, n = nm / N, m = nm - n * N;
    const float* q = sQ + n * ldq + h * ds;
    const float* k = sK + m * ldq + h * ds;
    float dot = 0.f;
    for (int j = 0; j < ds; ++j) dot = fmaf(q[j], k[j], dot);
    const float t = tanhf(dot * s);
    sGS[h * L.gs_plane + nm] = gscale * sGM[nm] * (1.0f - t * t);
  }
  __syncthreads();

  // gQ[n, h ds + j] = sum_m gS_h[n, m] K[m, h ds + j];
  // gK[m, h ds + j] = sum_n gS_h[n, m] Q[n, h ds + j]
  for (int i = threadIdx.x; i < 2 * N * A; i += blockDim.x) {
    const int which = i / (N * A), r = (i - which * N * A) / A, col = i % A;
    const float* g = sGS + (col / ds) * L.gs_plane;
    float acc = 0.f;
    if (which == 0) {
      for (int m = 0; m < N; ++m) acc = fmaf(g[r * N + m], sK[m * ldq + col], acc);
    } else {
      for (int n = 0; n < N; ++n) acc = fmaf(g[n * N + r], sQ[n * ldq + col], acc);
    }
    sGP[r * P + which * A + col] = acc;
  }
  __syncthreads();

  // this block's dW = NX^T gP and db = sum_n gP, into the graph's partial
  // at channel c; gNX = gP W^T
  float* pw = part_w + static_cast<size_t>(b) * G.total;
  grad::product(
      Fi, P, N, [&](int f, int n) { return sNX[n * Fi + f]; },
      [&](int n, int p) { return sGP[n * P + p]; },
      [&](int f, int p, float v) {
        if (p < A)
          pw[G.wq + (c * Fi + f) * A + p] = v;
        else if (p < 2 * A)
          pw[G.wk + (c * Fi + f) * A + p - A] = v;
        else
          pw[G.wv + (c * Fi + f) * O + p - 2 * A] = v;
      });
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc += sGP[n * P + p];
    if (p < A)
      pw[G.bq + c * A + p] = acc;
    else if (p < 2 * A)
      pw[G.bk + c * A + p - A] = acc;
    else
      pw[G.bv + c * O + p - 2 * A] = acc;
  }
  grad::product(
      N, Fi, P, [&](int r, int p) { return sGP[r * P + p]; },
      [&](int p, int f) { return sW[f * ldw + p]; },
      [&](int r, int f, float v) { sGNX[r * Fi + f] = v; });
  __syncthreads();

  // this channel's dX = norm^T gNX; gN = gNX X^T (into gM's place)
  if (part_x != nullptr) {
    float* px = part_x + (static_cast<size_t>(b) * C + c) * N * Fi;
    grad::product(
        N, Fi, N, [&](int m, int n) { return sNorm[n * N + m]; },
        [&](int n, int f) { return sGNX[n * Fi + f]; },
        [&](int m, int f, float v) { px[m * Fi + f] = v; });
  }
  if (dadj == nullptr) return;
  grad::product(
      N, N, Fi, [&](int n, int f) { return sGNX[n * Fi + f]; },
      [&](int f, int m) { return sX[m * ldx + f]; },
      [&](int n, int m, float v) { sGM[n * N + m] = v; });
  __syncthreads();
  grad::adj_grad(sGM, sA, N, sD, sS, N, add_loop, smem + L.dr, dadj + b * ds_b + c * ds_c,
                 ds_n, ds_m);
}

}  // namespace

// Shared bytes of a block (one graph, one channel).
extern "C" int gmh_attention_bwd_smem(int N, int Fi, int A, int O, int H) {
  return static_cast<int>(sizeof(float)) * Layout(N, Fi, A, O, H).total;
}

// x (B, N, F_in) contiguous; adj (B, C, N, N) through strides as_*;
// w* (C, F_in, .), b* (C, .) or null, contiguous; gv = dL/dV (B, N, C F_out)
// contiguous; ga = dL/dA (B, N, N, C) through strides gs_* (b, n, m, c).
// Writes dx (B, N, F_in) or skips it (null), dadj (B, C, N, N) through
// strides ds_* or skips it (null), and out_w: dWq, dWk, dWv, dbq, dbk, dbv
// one after another, each contiguous (biases' gradients also where a bias
// is null).  part_x (B, C, N, F_in) (null with dx) and part_w (B, size of
// out_w) are scratch for the per-block partials.  Up to three launches on
// `stream` (the blocks, the sum over graphs, the sum over channels);
// returns the first non-zero cudaError_t (0 on success).
extern "C" int gmh_attention_bwd_run(const float* x, const float* adj, const float* wq,
                                     const float* bq, const float* wk, const float* bk,
                                     const float* wv, const float* bv, const float* gv,
                                     const float* ga, float* dx, float* dadj, float* part_x,
                                     float* part_w, float* out_w, int B, int C, int N, int Fi,
                                     int A, int O, int H, int ds, long long as_b,
                                     long long as_c, long long as_n, long long as_m,
                                     long long gs_b, long long gs_n, long long gs_m,
                                     long long gs_c, long long ds_b, long long ds_c,
                                     long long ds_n, long long ds_m, float score_div,
                                     int add_loop, float loop, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gmh_attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gmh::kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = gmh_attention_bwd_smem(N, Fi, A, O, H);
  if (smem > gmh::kMaxSmem || (dx == nullptr) != (part_x == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  gmh_attention_bwd_kernel<<<dim3(B, C), grad::kThreads, smem, s>>>(
      x, adj, wq, bq, wk, bk, wv, bv, gv, ga, dadj, part_x, part_w, C, N, Fi, A, O, H, ds, as_b,
      as_c, as_n, as_m, gs_b, gs_n, gs_m, gs_c, ds_b, ds_c, ds_n, ds_m, score_div, add_loop,
      loop);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int len = Grads(C, Fi, A, O).total;
  e = grad::launch_strided_sum(part_w, out_w, len, B, len, len, 0, s);
  if (e != 0 || dx == nullptr) return e;
  // dx[b, n, f] = sum_c part_x[b, c, n, f]
  const int plane = N * Fi;
  return grad::launch_strided_sum(part_x, dx, B * plane, C, plane, plane,
                                  static_cast<long long>(C) * plane, s);
}
