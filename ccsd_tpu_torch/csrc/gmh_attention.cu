// Graph multi-head (GMH) attention of every channel of a layer, one block
// per (graph, channel).
//
// Replaces: gmh_attention_pallas, ccsd_tpu/ops/pallas/gmh_attention.py:62-114
// (body _gmh_kernel :30-59).  The Pallas grid (B,) ran one channel per call;
// here one launch covers a whole AttentionLayer.
//
//   norm    = D^-1/2 A'_c D^-1/2            (A'_c: diagonal set to `loop`)
//   Q, K, V = (norm X) W_{q,k,v}[c] + b_{q,k,v}[c]
//   S_h     = Q_h K_h^T / sqrt(F_out)       (head h = columns [h*ds,(h+1)*ds))
//   A       = mean_h tanh(S_h)
//   outputs   V into v_out[b, n, c*F_out + o]   (the channel concat)
//             (A + A^T)/2 into a_out[b, n, m, c] (channels last)
//
// norm (X W) is taken as (norm X) W, as the fused layer takes it: the same
// function in fewer FMAs when F_in < 2 attn + F_out, rounded in another
// order.  The adjacency is read through its four strides (b, c, n, m): the
// first layer's is (B, C, N, N)-contiguous, a later layer's the
// channels-last view the previous layer's MLP leaves.
//
// What bounds it on H100: at the sampler's widest layer (B=128, C=8, N=20,
// F_in = attn = F_out = 32) one launch moves ~6 MB and does ~89 M FMAs
// (norm X, the projection, the head sums) plus ~1.6 M tanh: 1.9 us of bytes
// at 3.35 TB/s against 2.7 us of operations at 67 TFLOP/s, so operations
// bound it.  The first design (one block per (graph, channel), one output
// per thread) was bound by its load/store pipe instead: a 20-way bank
// conflict in the score loop (K rows 32 floats apart), two loads per FMA in
// the projection (W re-read through L1 on every FMA), three shared loads and
// a multiply per FMA in the aggregation, and a global load of the bias for
// every output.  What is left is the block's chain of short phases between
// barriers, the instructions around the FMAs, and the strided accesses of
// the channels-last layouts: the maps leave one float per (n, m) at stride
// C, and a later layer's adjacency arrives the same way (PERF.md,
// scripts/gmh_stage_times.py).
// What this design does about it:
//  * a block takes one (graph, channel), B x C blocks of 256 threads, up to
//    four resident an SM: at the sampler's B = 128 and C = 8 the 1,024
//    blocks fill the 132 SMs about twice.  A block that walked several
//    channels of a graph would make the map store contiguous, but leaves
//    fewer blocks to hide one another's latencies, and no batch the port
//    runs gives enough graphs for that (PERF.md);
//  * [Wq | Wk | Wv], its bias, the adjacency and X arrive by cp.async, in
//    16-byte copies where the rows allow (the weights, X as one run, a
//    contiguous adjacency), behind one barrier; the bias is read from
//    shared memory;
//  * every warp computes the degrees for itself (16-byte row loads), then
//    d_r A'_rj d_j is built once per channel in shared memory, so the
//    product norm X reads one value per FMA;
//  * norm X and (norm X) [Wq | Wk | Wv] are register-tiled: 2 x 2 outputs
//    a thread for norm X, and for the projection 2 rows x 4 columns with
//    16-byte loads (4 k of an A row, 4 columns of a W row: 6 loads per 32
//    FMAs); the scores are the f32 stage of gmh_common.cuh (2 x 2 head sums
//    a thread, 16-byte loads along the head, then one thread a pair n <= m
//    for the tanh and the symmetrised store); rows are padded so that no
//    loop has a bank conflict;
//  * V leaves as coalesced rows of F_out floats, the maps from the pairs'
//    threads, one float at stride C each.
// Plain f32 FMAs and tanhf throughout; no TF32.

#include "agg_tile.cuh"

namespace {

using namespace gmh;

// register patches of the three f32 products
constexpr int kAggTM = 2, kAggTN = 2;    // norm X        (N x F_in)
constexpr int kProjTM = 2, kProjTN = 4;  // (norm X) W    (N x P; 16-byte loads: TM x 4)
constexpr int kSumTM = 2, kSumTN = 2;    // head sums   (N x N)

// Shared-memory layout of one block, in floats.
struct AttnLayout {
  int P;         // projected width 2A + O: [q | k | v]
  int bias;      // [Wq | Wk | Wv] (F_in x P) at 0, then its bias (P)
  int adj, lda;  // the adjacency (ld4: 16-byte copies and rows)
  int x;         // X, dense (F_in a row): one 16-byte copy run
  int ldn, norm;
  int ldnx, nx;  // norm X (ld4: 16-byte rows)
  int ldq, q, k; // Q, K (ld4: 16-byte rows)
  int raw;       // raw head sums, H * raw_plane(N)
  int total;
  __host__ __device__ AttnLayout(int N, int Fi, int A, int O, int H) {
    P = 2 * A + O;
    bias = round4(Fi * P);
    adj = round4(bias + P);
    lda = ld4(N);
    x = round4(adj + N * lda);
    ldn = odd(N);
    norm = x + round4(N * Fi);
    ldnx = ld4(Fi);
    nx = norm + round4(N * ldn);
    ldq = ld4(A);
    q = nx + N * ldnx;
    k = q + N * ldq;
    raw = k + N * ldq;
    total = raw + H * raw_plane(N);
  }
};

// at most 64 registers a thread, so that four blocks fit an SM's registers;
// T, the type of every input and output: float, or bf16 (staged as f32,
// V and the maps rounded once as they are stored)
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
gmh_attention_kernel(const T* __restrict__ x, const T* __restrict__ adj,
                     const T* __restrict__ wq, const T* __restrict__ bq,
                     const T* __restrict__ wk, const T* __restrict__ bk,
                     const T* __restrict__ wv, const T* __restrict__ bv,
                     T* __restrict__ v_out, T* __restrict__ a_out,
                     int C, int N, int Fi, int A, int O, int H, int ds,
                     long long as_b, long long as_c, long long as_n, long long as_m,
                     float score_div, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const AttnLayout L(N, Fi, A, O, H);
  const int P = L.P;
  const float* sW = smem;
  const float* sBias = smem + L.bias;
  const float* sA = smem + L.adj;
  float* sX = smem + L.x;
  float* sNorm = smem + L.norm;
  float* sNX = smem + L.nx;
  float* sQ = smem + L.q;
  float* sK = smem + L.k;
  float* sR = smem + L.raw;
  const int b = blockIdx.x, c = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // [Wq | Wk | Wv] of channel c and its bias, the adjacency of (b, c), and X
  // of the graph (one dense run of N F_in floats)
  const T* w[3] = {wq + static_cast<size_t>(c) * Fi * A, wk + static_cast<size_t>(c) * Fi * A,
                   wv + static_cast<size_t>(c) * Fi * O};
  const T* bias[3] = {bq ? bq + c * A : nullptr, bk ? bk + c * A : nullptr,
                      bv ? bv + c * O : nullptr};
  for (int m = 0; m < 3; ++m) {
    const int off = m * A, width = m < 2 ? A : O;
    copy_tile(smem + off, P, w[m], width, 1, Fi, width);
    if (bias[m])
      copy_tile(smem + L.bias + off, width, bias[m], width, 1, 1, width);
    else
      zero_fill(smem + L.bias + off, width);
  }
  copy_tile(smem + L.adj, L.lda, adj + b * as_b + c * as_c, as_n, as_m, N, N);
  copy_tile(sX, N * Fi, x + static_cast<size_t>(b) * N * Fi, N * Fi, 1, 1, N * Fi);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // d = max(rowsum A', 1)^-1/2 (diagonal assigned `loop` when add_loop),
  // every warp for itself: lane r holds the rows r and r + 32; then
  // norm = d_r A'_rj d_j, one warp a row
  float d0 = 1.f, d1 = 1.f;  // rows lane and lane + 32
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    if (r >= N) continue;
    const float* row = sA + r * L.lda;
    float s = 0.f;
    int j = 0;
    if ((N & 3) == 0)  // 16-byte rows; eight lanes' rows in distinct banks
      for (; j < N; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(row + j);
        s += (add_loop && j == r) ? loop : a.x;
        s += (add_loop && j + 1 == r) ? loop : a.y;
        s += (add_loop && j + 2 == r) ? loop : a.z;
        s += (add_loop && j + 3 == r) ? loop : a.w;
      }
    for (; j < N; ++j) s += (add_loop && j == r) ? loop : row[j];
    (h ? d1 : d0) = 1.0f / sqrtf(fmaxf(s, 1.0f));
  }
  for (int r = warp; r < N; r += nwarps) {
    const float dr = __shfl_sync(0xffffffffu, r < 32 ? d0 : d1, r & 31);
    for (int j = lane; j < N; j += 32) {
      const float a = (add_loop && r == j) ? loop : sA[r * L.lda + j];
      sNorm[r * L.ldn + j] = dr * a * (j < 32 ? d0 : d1);
    }
  }
  __syncthreads();

  if (ablated(kNormX))
    zero_fill(sNX, N * L.ldnx);
  else
    tiled_product<kAggTM, kAggTN>(sNorm, L.ldn, sX, Fi, N, Fi, N,
                                  [&](int r, int f, float v) { sNX[r * L.ldnx + f] = v; });
  __syncthreads();

  // Q, K = (norm X) W + bias into shared memory; V straight to its slot of
  // the channel concat
  T* vo = v_out + static_cast<size_t>(b) * N * C * O + static_cast<size_t>(c) * O;
  auto qkv = [&](int r, int p, float v) {
    v += sBias[p];
    if (p < A) {
      sQ[r * L.ldq + p] = v;
    } else if (p < 2 * A) {
      sK[r * L.ldq + (p - A)] = v;
    } else {
      vo[static_cast<size_t>(r) * C * O + (p - 2 * A)] = from_f32<T>(v);
    }
  };
  if (ablated(kProjection))
    zero_fill(sQ, 2 * N * L.ldq);  // Q and K; V is not written
  else if ((P & 3) == 0)  // 16-byte rows of W (smem and P are 16-byte aligned)
    tiled_product4<kProjTM>(sNX, L.ldnx, sW, P, N, P, Fi, qkv);
  else
    tiled_product<kProjTM, kProjTN>(sNX, L.ldnx, sW, P, N, P, Fi, qkv);
  __syncthreads();

  if (ablated(kHeadSums)) {
    zero_fill(sR, H * raw_plane(N));
  } else {
    const int per = sum_patches<kSumTM, kSumTN>(N);  // items: (head, patch)
    for (int i = threadIdx.x; i < H * per; i += blockDim.x)
      sum_patch_f32<kSumTM, kSumTN>(i % per, i / per, sQ, sK, L.ldq, sR, N, ds);
  }
  __syncthreads();
  if (!ablated(kStore))
    store_pairs(a_out + (static_cast<size_t>(b) * N * N) * C + c, sR, 0, N, C, 1, H,
                score_div);
}

// ------------------------------------------------------ tiled (N > 64)
//
// A graph whose channel does not fit one block (N > 64; grid: N = 361) is
// taken in three launches: gcn_degrees.cu computes d of every row; the
// projection below computes Q, K and V a row tile at a time; the tile-pair
// score stage of gmh_common.cuh (tiled_scores_kernel<false>) takes the
// maps from Q and K.  The GCN-conv Q, K and V of a row need norm X over all
// N rows, which is why the projection and the scores are two launches.
//
// Projection, a block per (group of G channels, row tile of agg::kRows = 16
// rows, graph b; graphs in reverse order, so that the first blocks find in
// L2 what the gcn_degrees launch before read last):
//   NX[c, n, :]       = d_cn sum_m A'[c, n, m] d_cm X[m, :]
//   [Q | K | V][c, n] = NX[c, n, :] [Wq | Wk | Wv][c] + bias[c]
// in the order of the one-block kernel ((norm X) W, then the bias).  NX is
// the normalised aggregation tile of agg_tile.cuh (3xTF32 on the tensor
// cores), kept in shared memory; the product with [Wq | Wk | Wv] (read
// from L2, which keeps two blocks an SM) is in f32 FMAs, into shared memory
// (see below why).  Then Q | K go to the scratch qk[b, c, n, 0 : 2A] the
// score launch reads, V to v_out[b, n, c F_out + o], rows at a time.
//
// What bounds it on H100 at grid's widest layer (B = 8, C = 8, N = 361,
// F_in = 32): 33 MB of adjacency read once (~10 us at 3.35 TB/s) against
// ~0.7 GFLOP (0.53 of them the aggregation, on the tensor cores; the
// projection's 0.18 in f32 FMAs, ~3 us at 67 TFLOP/s).

// the ring: three chunks of two k-steps a warp
constexpr int kProjStages = 3, kProjSteps = 2;
constexpr unsigned kProjAblate = ((GMH_ABLATE & kNormX) ? agg::kNoProduct : 0u) |
                                 ((GMH_ABLATE & kLoads) ? agg::kNoLoads : 0u);

// Shared floats of a projection block: the aggregation tile's region
// (after the tile: [Q | K | V] of the block, rows of ldo floats, 8 mod 32)
// and degrees | NX (G x kRows rows of ld4(F_in) floats).  [Wq | Wk | Wv]
// and the biases are read from device memory (L2), which keeps two blocks
// an SM.
struct ProjLayout {
  agg::Geometry geo;
  int P, ldo, ldn;
  int region, d, nx, total;
  __host__ __device__ ProjLayout(int N, int Fi, int A, int O, int G, bool quad)
      : geo(N, Fi, G, quad, kProjStages, kProjSteps) {
    P = 2 * A + O;
    const int p8 = 8 * cdiv(P, 8);
    ldo = p8 + (40 - p8 % 32) % 32;
    ldn = ld4(Fi);
    const int outs = G * agg::kRows * ldo;
    region = geo.region > outs ? geo.region : outs;
    d = region;
    nx = d + geo.deg;
    total = nx + G * agg::kRows * ldn;
  }
};

template <bool kQuad, int kNT>
__global__ void __launch_bounds__(agg::kThreads, 2)
gmh_projection_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                      const float* __restrict__ deg, const float* __restrict__ wq,
                      const float* __restrict__ bq, const float* __restrict__ wk,
                      const float* __restrict__ bk, const float* __restrict__ wv,
                      const float* __restrict__ bv, float* __restrict__ qk,
                      float* __restrict__ v_out, int C, int N, int Fi, int A, int O, int G,
                      long long as_b, long long as_c, long long as_n, long long as_m,
                      int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const ProjLayout L(N, Fi, A, O, G, kQuad);
  const int P = L.P, ldo = L.ldo, ldn = L.ldn;
  float* sD = smem + L.d;
  float* sNX = smem + L.nx;
  const int c0 = blockIdx.x * G, r0 = blockIdx.y * agg::kRows;
  const int b = gridDim.z - 1 - blockIdx.z;
  const agg::Tile t{adj + b * as_b + c0 * as_c + r0 * as_n, as_c, as_n, as_m,
                    x + static_cast<size_t>(b) * N * Fi, N, Fi, r0,
                    min(agg::kRows, N - r0), min(G, C - c0), add_loop != 0, loop};

  agg::stage_degrees<kProjAblate>(sD, deg + (static_cast<size_t>(b) * C + c0) * N, N, t.nch,
                                  G);
  for (int f0 = 0; f0 < Fi; f0 += 8 * agg::kPassNT) {
    agg::aggregate<kProjStages, kNT, kQuad, false, kProjAblate>(
        L.geo, t, smem, sD, f0, min(8 * agg::kPassNT, Fi - f0),
        [&](int g, int r, int f, float v) { sNX[(g * agg::kRows + r) * ldn + f0 + f] = v; });
  }
  if (ablated(kProjection)) return;

  // [Q | K | V] = NX [Wq | Wk | Wv] + bias into the region in f32 FMAs, each
  // output's in k order, then the bias (the one-block kernel's order): a
  // thread a (channel, column), its 16 rows in registers, each weight read
  // once from L2.  On the tensor cores (3xTF32) this product moved grid's
  // full-loss gradient against float64 (which f32 holds only to its own
  // rounding, the degree clamp's kink amplifying it) far past the smoke's
  // bound of 4x the CPU f32 copy's distance.
  float* sOut = smem;
  const int A2 = 2 * A;
  for (int i = threadIdx.x; i < t.nch * P; i += blockDim.x) {
    const int g = i / P, p = i - g * P, c = c0 + g;
    const float* wc = p < A    ? wq + static_cast<size_t>(c) * Fi * A + p
                      : p < A2 ? wk + static_cast<size_t>(c) * Fi * A + (p - A)
                               : wv + static_cast<size_t>(c) * Fi * O + (p - A2);
    const int ld = p < A2 ? A : O;
    const float* nx = sNX + g * agg::kRows * ldn;
    float acc[agg::kRows];
#pragma unroll
    for (int r = 0; r < agg::kRows; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < Fi; k0 += 8) {  // eight k a step: two 16-byte loads of NX a row
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = k0 + u < Fi ? __ldg(wc + (k0 + u) * ld) : 0.f;
#pragma unroll
      for (int r = 0; r < agg::kRows; ++r) {
        const float* nr = nx + r * ldn + k0;
        if (k0 + 8 <= Fi) {
          const float4 a = *reinterpret_cast<const float4*>(nr);
          const float4 b = *reinterpret_cast<const float4*>(nr + 4);
          const float e[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[r] = fmaf(e[u], w[u], acc[r]);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (k0 + u < Fi) acc[r] = fmaf(nr[u], w[u], acc[r]);
        }
      }
    }
    const float* bp = p < A ? bq : p < A2 ? bk : bv;
    const float bias = bp ? __ldg(bp + (p < A ? c * A + p : p < A2 ? c * A + p - A
                                                               : c * O + p - A2))
                          : 0.f;
#pragma unroll
    for (int r = 0; r < agg::kRows; ++r) sOut[(g * agg::kRows + r) * ldo + p] = acc[r] + bias;
  }
  __syncthreads();

  // Q | K rows (2A floats each) and the tile's rows of the channel concat
  // (nch F_out floats each), lanes along the row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gr = warp; gr < t.nch * agg::kRows; gr += agg::kWarps) {
    const int g = gr / agg::kRows, r = gr % agg::kRows;
    if (r >= t.nr) continue;
    float* dst = qk + ((static_cast<size_t>(b) * C + c0 + g) * N + r0 + r) * A2;
    for (int p = lane; p < A2; p += 32) dst[p] = sOut[gr * ldo + p];
  }
  for (int r = warp; r < t.nr; r += agg::kWarps) {
    float* dst = v_out + (static_cast<size_t>(b) * N + r0 + r) * C * O +
                 static_cast<size_t>(c0) * O;
    for (int g = 0; g < t.nch; ++g)
      for (int o = lane; o < O; o += 32)
        dst[g * O + o] = sOut[(g * agg::kRows + r) * ldo + A2 + o];
  }
}

template <bool kQuad, int kNT>
int launch_projection(const float* x, const float* adj, const float* deg, const float* wq,
                      const float* bq, const float* wk, const float* bk, const float* wv,
                      const float* bv, float* qk, float* v_out, int B, int C, int N, int Fi,
                      int A, int O, int G, long long as_b, long long as_c, long long as_n,
                      long long as_m, int add_loop, float loop, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(gmh_projection_kernel<kQuad, kNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = static_cast<int>(sizeof(float)) * ProjLayout(N, Fi, A, O, G, kQuad).total;
  if (smem > kMaxSmem || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(C, G), cdiv(N, agg::kRows), B);
  gmh_projection_kernel<kQuad, kNT><<<grid, agg::kThreads, smem, stream>>>(
      x, adj, deg, wq, bq, wk, bk, wv, bv, qk, v_out, C, N, Fi, A, O, G, as_b, as_c, as_n,
      as_m, add_loop, loop);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of one block of the one-block kernel: the kernel's
// layout, for the wrapper.
extern "C" int gmh_attention_smem(int N, int Fi, int A, int O, int H) {
  return static_cast<int>(sizeof(float)) * AttnLayout(N, Fi, A, O, H).total;
}

// as_*: strides of adj in elements.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int gmh_attention_f32(const float* x, const float* adj,
                                 const float* wq, const float* bq,
                                 const float* wk, const float* bk,
                                 const float* wv, const float* bv,
                                 float* v_out, float* a_out, int B, int C, int N,
                                 int Fi, int A, int O, int H, int ds,
                                 long long as_b, long long as_c, long long as_n,
                                 long long as_m, float score_div, int add_loop,
                                 float loop, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gmh_attention_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = gmh_attention_smem(N, Fi, A, O, H);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid(B, C);
  gmh_attention_kernel<float><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, wq, bq, wk, bk, wv, bv, v_out, a_out, C, N, Fi, A, O, H, ds,
      as_b, as_c, as_n, as_m, score_div, add_loop, loop);
  return (int)cudaGetLastError();
}

// The same launch over bf16 tensors (N <= 64), V and the maps in bf16.
extern "C" int gmh_attention_bf16(const bf16* x, const bf16* adj, const bf16* wq,
                                  const bf16* bq, const bf16* wk, const bf16* bk,
                                  const bf16* wv, const bf16* bv, bf16* v_out, bf16* a_out,
                                  int B, int C, int N, int Fi, int A, int O, int H, int ds,
                                  long long as_b, long long as_c, long long as_n,
                                  long long as_m, float score_div, int add_loop, float loop,
                                  void* stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      gmh_attention_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int smem = gmh_attention_smem(N, Fi, A, O, H);
  if (smem > kMaxSmem || N > 64) return (int)cudaErrorInvalidValue;
  gmh_attention_kernel<bf16><<<dim3(B, C), kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, wq, bq, wk, bk, wv, bv, v_out, a_out, C, N, Fi, A, O, H, ds, as_b, as_c, as_n,
      as_m, score_div, add_loop, loop);
  return (int)cudaGetLastError();
}

// Shared memory (bytes) of one projection block over G channels, in the
// larger of the tile's two layouts, or INT_MAX where G is out of range.
extern "C" int gmh_projection_smem(int N, int Fi, int A, int O, int G) {
  if (G < 1 || G > agg::kMaxGroup) return 0x7fffffff;
  const int rowwise = ProjLayout(N, Fi, A, O, G, false).total;
  const int quad = (G == 4 || G == 8) ? ProjLayout(N, Fi, A, O, G, true).total : 0;
  return static_cast<int>(sizeof(float)) * (rowwise > quad ? rowwise : quad);
}

// deg: (B, C, N) of gcn_degrees; qk: (B, C, N, 2A) scratch; v_out: (B, N,
// C F_out).  as_*: strides of adj in elements.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int gmh_projection_run(const float* x, const float* adj, const float* deg,
                                  const float* wq, const float* bq, const float* wk,
                                  const float* bk, const float* wv, const float* bv,
                                  float* qk, float* v_out, int B, int C, int N, int Fi,
                                  int A, int O, int G, long long as_b, long long as_c,
                                  long long as_n, long long as_m, int add_loop, float loop,
                                  void* stream) {
  if (G < 1 || G > agg::kMaxGroup) return (int)cudaErrorInvalidValue;
  const bool quad = agg::takes_quad(adj, C, G, as_b, as_c, as_n, as_m);
  const auto launch = quad ? (Fi <= 8 ? launch_projection<true, 1> : launch_projection<true, 4>)
                           : (Fi <= 8 ? launch_projection<false, 1>
                                      : launch_projection<false, 4>);
  return launch(x, adj, deg, wq, bq, wk, bk, wv, bv, qk, v_out, B, C, N, Fi, A, O, G, as_b,
                as_c, as_n, as_m, add_loop, loop, (cudaStream_t)stream);
}

// The tile-pair score stage of gmh_common.cuh in f32, over Q and K of the
// projection's scratch: shared bytes of a block of G channels, and the
// launch over the wrapper's plan (pairs: npairs x (I, J)).
extern "C" int gmh_tiled_scores_smem(int A, int G) {
  return gmh::tiled_scores_smem<false>(A, G);
}

extern "C" int gmh_tiled_scores_run(const float* q, const float* k, const int* pairs,
                                    float* out, int B, int C, int N, int A, int H, int ds,
                                    int G, int npairs, long long qsb, long long qsc,
                                    long long qsn, long long ksb, long long ksc,
                                    long long ksn, float score_div, void* stream) {
  return gmh::tiled_scores_launch<false>(q, k, pairs, out, B, C, N, A, H, ds, G, npairs, qsb,
                                         qsc, qsn, ksb, ksc, ksn, score_div,
                                         (cudaStream_t)stream);
}
