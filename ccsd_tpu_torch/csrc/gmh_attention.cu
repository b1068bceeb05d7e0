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

#include "gmh_common.cuh"

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

// at most 64 registers a thread, so that four blocks fit an SM's registers
__global__ void __launch_bounds__(kThreads, 4)
gmh_attention_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                     const float* __restrict__ wq, const float* __restrict__ bq,
                     const float* __restrict__ wk, const float* __restrict__ bk,
                     const float* __restrict__ wv, const float* __restrict__ bv,
                     float* __restrict__ v_out, float* __restrict__ a_out,
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
  const float* w[3] = {wq + static_cast<size_t>(c) * Fi * A,
                       wk + static_cast<size_t>(c) * Fi * A,
                       wv + static_cast<size_t>(c) * Fi * O};
  const float* bias[3] = {bq ? bq + c * A : nullptr, bk ? bk + c * A : nullptr,
                          bv ? bv + c * O : nullptr};
  for (int m = 0; m < 3; ++m) {
    const int off = m * A, width = m < 2 ? A : O;
    copy_tile_async(smem + off, P, w[m], width, 1, Fi, width);
    if (bias[m])
      copy_tile_async(smem + L.bias + off, width, bias[m], width, 1, 1, width);
    else
      zero_fill(smem + L.bias + off, width);
  }
  copy_tile_async(smem + L.adj, L.lda, adj + b * as_b + c * as_c, as_n, as_m, N, N);
  copy_tile_async(sX, N * Fi, x + static_cast<size_t>(b) * N * Fi, N * Fi, 1, 1, N * Fi);
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
  float* vo = v_out + static_cast<size_t>(b) * N * C * O + static_cast<size_t>(c) * O;
  auto qkv = [&](int r, int p, float v) {
    v += sBias[p];
    if (p < A) {
      sQ[r * L.ldq + p] = v;
    } else if (p < 2 * A) {
      sK[r * L.ldq + (p - A)] = v;
    } else {
      vo[static_cast<size_t>(r) * C * O + (p - 2 * A)] = v;
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
// Projection, a block per (row tile of kTile rows, group of G channels,
// graph b):
//   NX[c, n, :]      = d_cn sum_m A'[c, n, m] d_cm X[m, :]
//   [Q | K | V][c, n] = NX[c, n, :] [Wq | Wk | Wv][c] + bias[c]
// in the order of the one-block kernel ((norm X) W, then the bias).  Q | K
// go to the scratch qk[b, c, n, 0 : 2A] the score launch reads, V straight
// to v_out[b, n, c F_out + o].  X of the graph (N x F_in: 46 KB at N = 361,
// F_in = 32), the group's degrees and [Wq | Wk | Wv] with its bias are
// staged whole; the adjacency rows of the tile arrive in chunks of kChunk
// columns for all G channels, [r][m][g] in shared memory, two chunks in
// flight (cp.async), read from device memory in its own order: for the
// channels-last adjacency of layers 2 and on, (m, g) runs of G floats a
// column (16-byte copies of four channels where the strides allow), for a
// contiguous one runs along m.  Thread (g, r, s), S = 256 / (32 G) threads
// a row of a channel, keeps the F_in sums of its row in float4 registers
// (quads s, s + S, ...), each m costing one shared read of A (conflict-free:
// row stride 33 G), the degree, and one 16-byte read of X per quad for
// four FMAs.  The product with W is the register-tiled one of the
// one-block kernel, channel by channel.
//
// What bounds it on H100 at grid's widest layer (B = 8, C = 8, N = 361,
// F_in = 32): 33 MB of adjacency read once (~10 us at 3.35 TB/s) against
// ~0.7 GFLOP (~10 us at 67 TFLOP/s of f32).

constexpr int kChunk = 32;    // adjacency columns a stage
constexpr int kMaxQuads = 8;  // float4 sums of a thread: F_in <= 32 S

__host__ __device__ constexpr int proj_row_ld(int G) { return (kChunk + 1) * G; }

struct ProjLayout {
  int P, ldx, ldr, ldnx;
  int d, w, bias, adj, nx, total;
  __host__ __device__ ProjLayout(int N, int Fi, int A, int O, int G) {
    P = 2 * A + O;
    ldx = round4(Fi);   // X rows, zero-padded to whole float4
    ldr = proj_row_ld(G);
    ldnx = ld4(Fi);
    d = round4(N * ldx);
    w = d + round4(G * N);
    bias = w + round4(G * Fi * P);
    adj = bias + round4(G * P);
    nx = adj + round4(2 * gmh::kTile * ldr);
    total = nx + G * gmh::kTile * ldnx;
  }
};

// threads a (channel, row) of the NX sums, and whether a group of G
// channels over F_in features fits the thread mapping
__host__ __device__ constexpr int proj_split(int G) {
  return G * gmh::kTile >= kThreads ? 1 : kThreads / (G * gmh::kTile);
}
__host__ __device__ constexpr bool proj_fits(int Fi, int G) {
  return G >= 1 && G * gmh::kTile <= kThreads && cdiv(Fi, 4) <= kMaxQuads * proj_split(G);
}

__global__ void __launch_bounds__(kThreads)
gmh_projection_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                      const float* __restrict__ deg, const float* __restrict__ wq,
                      const float* __restrict__ bq, const float* __restrict__ wk,
                      const float* __restrict__ bk, const float* __restrict__ wv,
                      const float* __restrict__ bv, float* __restrict__ qk,
                      float* __restrict__ v_out, int C, int N, int Fi, int A, int O, int G,
                      long long as_b, long long as_c, long long as_n, long long as_m,
                      int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const ProjLayout L(N, Fi, A, O, G);
  const int P = L.P;
  float* sX = smem;
  float* sD = smem + L.d;
  float* sW = smem + L.w;
  float* sBias = smem + L.bias;
  float* sA = smem + L.adj;
  float* sNX = smem + L.nx;
  const int r0 = blockIdx.x * kTile, nr = min(kTile, N - r0);
  const int c0 = blockIdx.y * G, nch = min(G, C - c0);
  const int b = blockIdx.z;

  // the graph's X, the group's degrees, weights and biases
  copy_tile_async(sX, L.ldx, x + static_cast<size_t>(b) * N * Fi, Fi, 1, N, Fi);
  copy_tile_async(sD, N, deg + (static_cast<size_t>(b) * C + c0) * N, N, 1, nch, N);
  for (int g = 0; g < nch; ++g) {
    const int c = c0 + g;
    const float* w[3] = {wq + static_cast<size_t>(c) * Fi * A,
                         wk + static_cast<size_t>(c) * Fi * A,
                         wv + static_cast<size_t>(c) * Fi * O};
    const float* bias[3] = {bq ? bq + c * A : nullptr, bk ? bk + c * A : nullptr,
                            bv ? bv + c * O : nullptr};
    for (int m = 0; m < 3; ++m) {
      const int off = m * A, width = m < 2 ? A : O;
      copy_tile_async(sW + g * Fi * P + off, P, w[m], width, 1, Fi, width);
      if (bias[m])
        copy_tile_async(sBias + g * P + off, width, bias[m], width, 1, 1, width);
      else
        zero_fill(sBias + g * P + off, width);
    }
  }

  // adjacency columns [m0, m0 + mc) of the tile's rows, the group's
  // channels, into stage `buf`, [r][m][g]
  const float* ab = adj + b * as_b + c0 * as_c + r0 * as_n;
  const bool cl = as_c < as_m;  // channels vary faster than columns
  const bool vec4 = cl && as_c == 1 && (nch & 3) == 0 && (G & 3) == 0 && (as_m & 3) == 0 &&
                    (as_n & 3) == 0 && (as_b & 3) == 0 && (c0 & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(adj) & 15) == 0;
  const int nchunks = cdiv(N, kChunk);
  auto stage = [&](int k) {
    float* dst = sA + (k & 1) * kTile * L.ldr;
    const int m0 = k * kChunk, mc = min(kChunk, N - m0);
    const float* src = ab + m0 * as_m;
    if (vec4) {
      const int gv = nch >> 2, cnt = nr * mc * gv;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
        const int g = (i % gv) << 2, rm = i / gv, m = rm % mc, r = rm / mc;
        cp_async16(dst + r * L.ldr + m * G + g, src + r * as_n + m * as_m + g);
      }
    } else {
      const int cnt = nr * mc * nch;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
        int g, m, r;
        if (cl) {
          g = i % nch;
          const int rm = i / nch;
          m = rm % mc;
          r = rm / mc;
        } else {
          m = i % mc;
          const int rg = i / mc;
          g = rg % nch;
          r = rg / nch;
        }
        cp_async4(dst + r * L.ldr + m * G + g, src + r * as_n + m * as_m + g * as_c);
      }
    }
  };
  stage(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < N * (L.ldx - Fi); i += blockDim.x) {  // X's padding
    const int m = i / (L.ldx - Fi);
    sX[m * L.ldx + Fi + (i - m * (L.ldx - Fi))] = 0.f;
  }

  // NX sums: thread (g, r, s) owns quads s, s + S, ... of row r of channel g
  const int S = proj_split(G), quads = cdiv(Fi, 4);
  const int s = threadIdx.x % S, gr = threadIdx.x / S, g = gr % G, r = gr / G;
  const bool active = gr < G * kTile && g < nch;
  const int n = r0 + r;
  float4 acc[kMaxQuads];
#pragma unroll
  for (int u = 0; u < kMaxQuads; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      stage(k + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active && !ablated(kNormX)) {
      const int m0 = k * kChunk, mc = min(kChunk, N - m0);
      const float* arow = sA + (k & 1) * kTile * L.ldr + r * L.ldr + g;
      const float* dcol = sD + g * N + m0;
      for (int m = 0; m < mc; ++m) {
        float a = (add_loop && m0 + m == n) ? loop : arow[m * G];
        a *= dcol[m];
        const float* xr = sX + (m0 + m) * L.ldx;
#pragma unroll
        for (int u = 0; u < kMaxQuads; ++u) {
          const int qd = s + u * S;
          if (qd >= quads) break;
          const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * qd);
          acc[u].x = fmaf(a, xv.x, acc[u].x);
          acc[u].y = fmaf(a, xv.y, acc[u].y);
          acc[u].z = fmaf(a, xv.z, acc[u].z);
          acc[u].w = fmaf(a, xv.w, acc[u].w);
        }
      }
    }
    __syncthreads();  // stage k & 1 free for chunk k + 2
  }
  if (active && r < nr) {
    const float dn = sD[g * N + n];
    float* row = sNX + (g * kTile + r) * L.ldnx;
#pragma unroll
    for (int u = 0; u < kMaxQuads; ++u) {
      const int qd = s + u * S;
      if (qd >= quads) break;
      *reinterpret_cast<float4*>(row + 4 * qd) =
          make_float4(dn * acc[u].x, dn * acc[u].y, dn * acc[u].z, dn * acc[u].w);
    }
  }
  __syncthreads();

  // [Q | K | V] = NX [Wq | Wk | Wv] + bias, channel by channel
  const int A2 = 2 * A;
  for (int gg = 0; gg < nch; ++gg) {
    const int c = c0 + gg;
    float* qkc = qk + ((static_cast<size_t>(b) * C + c) * N + r0) * A2;
    float* vo = v_out + (static_cast<size_t>(b) * N + r0) * C * O + static_cast<size_t>(c) * O;
    const float* bias = sBias + gg * P;
    auto epi = [&](int rr, int p, float v) {
      v += bias[p];
      if (p < A2)
        qkc[static_cast<size_t>(rr) * A2 + p] = v;
      else
        vo[static_cast<size_t>(rr) * C * O + (p - A2)] = v;
    };
    const float* nx = sNX + gg * kTile * L.ldnx;
    if (ablated(kProjection))
      continue;
    else if ((P & 3) == 0)
      tiled_product4<kProjTM>(nx, L.ldnx, sW + gg * Fi * P, P, nr, P, Fi, epi);
    else
      tiled_product<kProjTM, kProjTN>(nx, L.ldnx, sW + gg * Fi * P, P, nr, P, Fi, epi);
  }
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
        gmh_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = gmh_attention_smem(N, Fi, A, O, H);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid(B, C);
  gmh_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, wq, bq, wk, bk, wv, bv, v_out, a_out, C, N, Fi, A, O, H, ds,
      as_b, as_c, as_n, as_m, score_div, add_loop, loop);
  return (int)cudaGetLastError();
}

// Shared memory (bytes) of one projection block over G channels, or
// INT_MAX where G channels of F_in features do not fit its thread mapping.
extern "C" int gmh_projection_smem(int N, int Fi, int A, int O, int G) {
  if (!proj_fits(Fi, G)) return 0x7fffffff;
  return static_cast<int>(sizeof(float)) * ProjLayout(N, Fi, A, O, G).total;
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
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gmh_projection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int smem = gmh_projection_smem(N, Fi, A, O, G);
  if (smem > kMaxSmem || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(cdiv(N, kTile), cdiv(C, G), B);
  gmh_projection_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, deg, wq, bq, wk, bk, wv, bv, qk, v_out, C, N, Fi, A, O, G, as_b, as_c, as_n,
      as_m, add_loop, loop);
  return (int)cudaGetLastError();
}

// The tile-pair score stage of gmh_common.cuh in f32, over Q and K of the
// projection's scratch: shared bytes of a block of G channels, and the
// launch over the wrapper's plan (pairs: npairs x (I, J)).
extern "C" int gmh_tiled_scores_smem(int A, int G) {
  return static_cast<int>(sizeof(float)) * gmh::TiledScoresLayout(A, G).total;
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
