// Backward of the degree-normalised GCN aggregation (gcn_aggregate.cu) in
// one launch: each graph's rows split over a few blocks, the blocks in
// clusters of eight, which sum their weight and bias gradients in
// distributed shared memory; the last cluster to arrive takes the sum over
// the clusters, in a fixed order (grad_common.cuh).
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
// Nothing of the forward is saved: the block recomputes d and norm from A,
// and Y = X W only where dA is asked for (no ScoreNetworkX layer asks).
//
// What bounds it on H100: at community_small's training shapes (B = 80,
// N = 20, F <= 32) one call moves ~0.6 MB and does ~10 MFLOP, about 0.2 us
// of either (bytes bound it; chip_smoke.py, gcn_bwd_cost), so the chain of
// short phases between barriers bounds it in practice.  The first design
// (one block a graph, 80 blocks; one output a thread; Y recomputed on every
// call; the weight partials summed by a second launch) took 10.0 us at
// F_in 11 and 13.5 us at F_in 32 with dX; scripts/grad_stage_times.py found
// 4.2-5.1 us of skeleton (loads, degrees, barriers, stores), 2.7-2.8 us in
// the sum launch and 1-1.7 us for each product.  What this design does:
//  * a graph's rows are split over cdiv(N, 16) blocks (two at N = 20: 160
//    blocks at B = 80), each staging the graph by cp.async in two groups
//    (A and G, then W and X) and computing the degrees for itself, then its
//    rows' share of dY, dX, dW and dA;
//  * d is applied once: the block forms its rows of norm^T (d_m A'[n, m]
//    d_n), and dY = norm^T G, dX = dY W^T and dW = X^T dY are
//    register-tiled (16-byte loads where the widths allow);
//  * Y = X W and gN only where dA is asked for;
//  * the weight and bias partials are summed in the cluster's distributed
//    shared memory and over the clusters by the last to arrive: one
//    launch, no float atomics, the same result on every run.
// Measured on the same card in one call: 9.0-9.1 us at F_in 11 (the first
// design 10.0) and 10.3-10.4 us at F_in 32 (13.5).  The sums over blocks
// take 3.5-3.7 us of it (cluster barriers, the tickets and the last
// cluster's tail over 20 cluster partials) and the skeleton 4.4-4.9 us;
// the products 0.5-1.0 us each.
// A block's rows of a graph hold N <= 64; the blocks are padded to a
// multiple of the cluster size with blocks that contribute zeros.
//
// Above N = 64 (grid: N = 361) a second kernel of this file takes the
// graph in row tiles of kTile = 32 rows, after a gcn_degrees.cu launch
// (the row-tile scheme of grad_common.cuh): a block computes every
// gradient of its tile's rows,
//   V = A'[:, R]^T (d o G) over chunks of 32 rows (dY[R] = d_R V);
//   dX[R] = dY W^T; its dW partial X[R]^T dY and db partial sum_R G;
//   where dA is asked for, Y = X W of every row, P1 = A'[R, :] (d o Y),
//   dr[n] = slope[n] (G[n] . P1[n] + Y[n] . V[n]) and
//   dA[n, m] = d_n d_m G[n] . Y[m] + dr[n];
// then the clusters' ordered sums, as above.  What bounds it at grid's
// layers (B = 8, F 32 -> 32, no dA): ~5 MB of inputs, ~1.6 us at
// 3.35 TB/s; the design is the simple one (patches of plain f32 FMAs,
// 4-byte copies of the strided columns, one block an SM with dA).

#include "grad_common.cuh"

namespace {

using namespace grad;

constexpr int kMaxRows = 16;  // rows of a graph one block takes, at most

__host__ __device__ constexpr int row_groups(int N) { return cdiv(N, kMaxRows); }

// Shared layout (floats), each region 16-byte aligned: A' N x lda |
// G N x ldo | W Fi x ldo | X N x ldx | norm^T rows R x ldt | dY R x ldo |
// Y N x ldo and gN N x ldgn (where dA is asked for) | the block's partial
// dW, db (T) | d, slope N each.  R = cdiv(N, row_groups(N)).
struct Layout {
  int R, T, lda, ldo, ldx, ldt, ldgn;
  int adj, g, w, x, nt, dy, y, gn, part, d, slope, total;
  __host__ __device__ Layout(int N, int Fi, int Fo) {
    R = cdiv(N, row_groups(N));
    T = Fi * Fo + Fo;
    lda = ld4(N);
    ldo = ld4(Fo);   // rows read along o (dX) or 4 columns at a time (dY, Y)
    ldx = ld4(Fi);
    ldt = ld4(N);    // norm^T rows read along n (dY)
    ldgn = odd(N);   // gN read down a column (dA)
    adj = 0;
    g = round4(N * lda);
    w = g + N * ldo;
    x = w + Fi * ldo;
    nt = x + N * ldx;
    dy = nt + R * ldt;
    y = dy + R * ldo;
    gn = y + N * ldo;
    part = gn + round4(N * ldgn);
    d = part + round4(T);
    slope = d + N;
    total = slope + N;
  }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
gcn_aggregate_bwd_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                         const float* __restrict__ w, const float* __restrict__ g,
                         float* __restrict__ dx, float* __restrict__ dadj,
                         float* __restrict__ part, float* __restrict__ out_w,
                         int* __restrict__ tickets, int B, int N, int Fi, int Fo, int add_loop,
                         float loop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, Fi, Fo);
  float* sA = smem + L.adj;
  float* sG = smem + L.g;
  float* sW = smem + L.w;
  float* sX = smem + L.x;
  float* sNt = smem + L.nt;
  float* sDY = smem + L.dy;
  float* sY = smem + L.y;
  float* sGN = smem + L.gn;
  float* sPart = smem + L.part;
  float* sD = smem + L.d;
  float* sSl = smem + L.slope;
  const int S = row_groups(N);
  const int b = blockIdx.x / S, r0 = (blockIdx.x % S) * L.R;
  const int M = min(L.R, N - r0);  // this block's rows r0 .. r0 + M
  const bool need_x = dx != nullptr, need_adj = dadj != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  if (b < B) {  // else a padding block of the last cluster
    // two groups of copies: A and G first; W and X (needed first by dX and
    // dW, or by Y = X W where dA is asked for) arrive while d and dY are taken
    stage(sA, L.lda, adj + static_cast<size_t>(b) * N * N, N, 1, N, N);
    stage(sG, L.ldo, g + static_cast<size_t>(b) * N * Fo, Fo, 1, N, Fo);
    gmh::cp_async_commit();
    stage(sW, L.ldo, w, Fo, 1, Fi, Fo);
    stage(sX, L.ldx, x + static_cast<size_t>(b) * N * Fi, Fi, 1, N, Fi);
    gmh::cp_async_commit();
    if (need_adj)
      gmh::cp_async_wait<0>();
    else
      gmh::cp_async_wait<1>();
    __syncthreads();

    // d of every row, by each warp for itself; the block's rows of norm^T,
    // norm^T[m, n] = d_m A'[n, m] d_n, one warp a row; warp 0 keeps d and
    // slope for dA; db = sum of the block's rows of G; Y = X W for dA
    float d[2], sl[2];
    warp_degrees(sA, L.lda, N, add_loop, loop, d, sl);
    for (int i = warp; i < M; i += nwarps) {
      const int m = r0 + i;
      const float dm = shfl_d(d, m);
      for (int n = lane; n < N; n += 32) {
        const float a = (add_loop && n == m) ? loop : sA[n * L.lda + m];
        sNt[i * L.ldt + n] = dm * a * (n < 32 ? d[0] : d[1]);
      }
    }
    if (warp == 0)
      for (int h = 0; h < 2; ++h)
        if (lane + 32 * h < N) {
          sD[lane + 32 * h] = d[h];
          sSl[lane + 32 * h] = sl[h];
        }
    for (int o = threadIdx.x; o < Fo; o += blockDim.x) {
      float s = 0.f;
      if (!ablated(kGradW))
        for (int n = r0; n < r0 + M; ++n) s += sG[n * L.ldo + o];
      sPart[Fi * Fo + o] = s;
    }
    if (need_adj)
      for (int p = threadIdx.x; p < patches<2, 4>(N, Fo); p += blockDim.x)
        patch<2, 4>(
            p, N, Fo, ablated(kGradAdj) ? 0 : Fi, [&](int r, int k) { return sX[r * L.ldx + k]; },
            [&](int k, int o) { return sW[k * L.ldo + o]; },
            [&](int r, int o, float v) { sY[r * L.ldo + o] = v; });
    gmh::cp_async_wait<0>();
    __syncthreads();

    // dY = norm^T G (the block's rows); gN = G Y^T for dA
    auto dy = [&](int r, int o, float v) { sDY[r * L.ldo + o] = v; };
    const int n_dy = (Fo & 3) == 0 ? patches4<1>(M, Fo) : patches<2, 4>(M, Fo);
    const int n_gn = need_adj ? patches<2, 2>(N, N) : 0;
    for (int i = threadIdx.x; i < n_dy + n_gn; i += blockDim.x) {
      if (i >= n_dy)
        patch_nt<2, 2>(i - n_dy, sG, L.ldo, sY, L.ldo, N, N, 0, ablated(kGradAdj) ? 0 : Fo,
                       [&](int n, int m, float v) { sGN[n * L.ldgn + m] = v; });
      else if ((Fo & 3) == 0)
        patch_nn4<1>(i, sNt, L.ldt, sG, L.ldo, M, Fo, ablated(kGradY) ? 0 : N, dy);
      else
        patch<2, 4>(
            i, M, Fo, ablated(kGradY) ? 0 : N, [&](int r, int k) { return sNt[r * L.ldt + k]; },
            [&](int k, int o) { return sG[k * L.ldo + o]; }, dy);
    }
    __syncthreads();

    // dX = dY W^T (the block's rows); this block's dW = X^T dY; dA of its rows
    const int n_dx = need_x ? patches<2, 2>(M, Fi) : 0;
    float* out_x = need_x ? dx + (static_cast<size_t>(b) * N + r0) * Fi : nullptr;
    for (int i = threadIdx.x; i < n_dx + patches<2, 4>(Fi, Fo); i += blockDim.x) {
      if (i < n_dx)
        patch_nt<2, 2>(i, sDY, L.ldo, sW, L.ldo, M, Fi, 0, ablated(kGradX) ? 0 : Fo,
                       [&](int r, int f, float v) { out_x[r * Fi + f] = v; });
      else
        patch<2, 4>(
            i - n_dx, Fi, Fo, ablated(kGradW) ? 0 : M,
            [&](int f, int k) { return sX[(r0 + k) * L.ldx + f]; },
            [&](int k, int o) { return sDY[k * L.ldo + o]; },
            [&](int f, int o, float v) { sPart[f * Fo + o] = v; });
    }
    if (need_adj)
      adj_grad_rows(sGN, L.ldgn, sA, L.lda, sD, sSl, N, r0, r0 + M, add_loop, loop,
                    dadj + static_cast<size_t>(b) * N * N, N, 1);
  } else {
    zero_fill(sPart, L.T);
  }

  if (!ablated(kReduce))
    batch_sum(sPart, L.T, gridDim.x / kCluster, part, L.T, tickets,
              [&](int e, float v) { out_w[e] = v; });
}

// ------------------------------------------------------------ N > 64

// Shared layout of a row tile (floats), each region 16-byte aligned:
// W Fi x ldw | X N x ldx | G[R] kTile x ldo | two chunk buffers of A'
// columns R (kTile x ldc) and of G (kTile x ldo) | V, dY kTile x ldo |
// partial dW, db (T) | d N | where dA is asked for: Y N x ldo | A[R, :]
// kTile x lda | P1 kTile x ldo | dr kTile.
struct TiledLayout {
  int T, ldw, ldx, ldo, ldc, lda;
  int w, x, gr, ac, gc, v, dy, part, d, y, ar, p1, dr, total;
  __host__ __device__ TiledLayout(int N, int Fi, int Fo, bool need_adj) {
    T = Fi * Fo + Fo;
    ldw = ld4(Fo);  // W rows read along o (dX) and across o (Y)
    ldx = ld4(Fi);
    ldo = ld4(Fo);
    ldc = ld4(kTile);
    lda = ld4(N);
    w = 0;
    x = w + Fi * ldw;
    gr = x + N * ldx;
    ac = gr + kTile * ldo;
    gc = ac + 2 * kTile * ldc;
    v = gc + 2 * kTile * ldo;
    dy = v + kTile * ldo;
    part = dy + kTile * ldo;
    d = part + round4(T);
    y = d + round4(N);
    ar = y + (need_adj ? N * ldo : 0);
    p1 = ar + (need_adj ? kTile * lda : 0);
    dr = p1 + (need_adj ? kTile * ldo : 0);
    total = dr + (need_adj ? kTile : 0);
  }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
gcn_aggregate_bwd_tiled_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                               const float* __restrict__ deg, const float* __restrict__ w,
                               const float* __restrict__ g, float* __restrict__ dx,
                               float* __restrict__ dadj, float* __restrict__ part,
                               float* __restrict__ out_w, int* __restrict__ tickets, int B,
                               int N, int Fi, int Fo, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const bool need_x = dx != nullptr, need_adj = dadj != nullptr;
  const TiledLayout L(N, Fi, Fo, need_adj);
  float* sW = smem + L.w;
  float* sX = smem + L.x;
  float* sGR = smem + L.gr;
  float* sAc = smem + L.ac;
  float* sGc = smem + L.gc;
  float* sV = smem + L.v;
  float* sDY = smem + L.dy;
  float* sPart = smem + L.part;
  float* sD = smem + L.d;
  float* sY = smem + L.y;
  float* sAr = smem + L.ar;
  float* sP1 = smem + L.p1;
  float* sDr = smem + L.dr;
  const int nt = cdiv(N, kTile);
  const int b = blockIdx.x / nt, r0 = (blockIdx.x % nt) * kTile;
  const int nr = min(kTile, N - r0);  // this block's rows r0 .. r0 + nr
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  if (b < B) {  // else a padding block of the last cluster
    const float* ab = adj + static_cast<size_t>(b) * N * N;
    const float* gb = g + static_cast<size_t>(b) * N * Fo;
    stage(sW, L.ldw, w, Fo, 1, Fi, Fo);
    stage(sX, L.ldx, x + static_cast<size_t>(b) * N * Fi, Fi, 1, N, Fi);
    stage(sGR, L.ldo, gb + static_cast<size_t>(r0) * Fo, Fo, 1, nr, Fo);
    stage(sD, N, deg + static_cast<size_t>(b) * N, N, 1, 1, N);
    if (need_adj) stage(sAr, L.lda, ab + static_cast<size_t>(r0) * N, N, 1, nr, N);
    gmh::cp_async_commit();

    // V[r, o] = sum_n A'[n, r0 + r] d_n G[n, o], over chunks of rows n
    chunk_loop(
        N,
        [&](int k, int buf) {
          const int n0 = k * kTile, mc = min(kTile, N - n0);
          stage(sAc + buf * kTile * L.ldc, L.ldc, ab + static_cast<size_t>(n0) * N + r0, N, 1,
                mc, nr);
          stage(sGc + buf * kTile * L.ldo, L.ldo, gb + static_cast<size_t>(n0) * Fo, Fo, 1, mc,
                Fo);
        },
        [&](int k, int buf) {
          const int n0 = k * kTile, mc = min(kTile, N - n0);
          const float* ac = sAc + buf * kTile * L.ldc;
          const float* gc = sGc + buf * kTile * L.ldo;
          for (int p = threadIdx.x; p < patches<2, 2>(nr, Fo); p += blockDim.x)
            patch<2, 2>(
                p, nr, Fo, ablated(kGradY) ? 0 : mc,
                [&](int r, int j) {
                  const int n = n0 + j;
                  return ((add_loop && n == r0 + r) ? loop : ac[j * L.ldc + r]) * sD[n];
                },
                [&](int j, int o) { return gc[j * L.ldo + o]; },
                [&](int r, int o, float v) {
                  float* acc = sV + r * L.ldo + o;
                  *acc = k == 0 ? v : *acc + v;
                });
        });

    // dY = d_R V; db = sum of the tile's rows of G; where dA is asked for,
    // Y = X W of every row and the slope of the tile's rows
    for (int i = threadIdx.x; i < nr * Fo; i += blockDim.x) {
      const int r = i / Fo, o = i - r * Fo;
      sDY[r * L.ldo + o] = sD[r0 + r] * sV[r * L.ldo + o];
    }
    for (int o = threadIdx.x; o < Fo; o += blockDim.x) {
      float s = 0.f;
      if (!ablated(kGradW))
        for (int r = 0; r < nr; ++r) s += sGR[r * L.ldo + o];
      sPart[Fi * Fo + o] = s;
    }
    if (need_adj) {
      for (int p = threadIdx.x; p < patches<2, 4>(N, Fo); p += blockDim.x)
        patch<2, 4>(
            p, N, Fo, ablated(kGradAdj) ? 0 : Fi, [&](int r, int f) { return sX[r * L.ldx + f]; },
            [&](int f, int o) { return sW[f * L.ldw + o]; },
            [&](int r, int o, float v) { sY[r * L.ldo + o] = v; });
      for (int r = warp; r < nr; r += nwarps) {
        const float s = warp_row_sum(sAr + r * L.lda, 1, N, r0 + r, add_loop, loop);
        if (lane == 0) sDr[r] = degree_slope(s);
      }
    }
    __syncthreads();

    // dX[R] = dY W^T; the block's dW = X[R]^T dY; P1 = A'[R, :] (d o Y)
    const int n_dx = need_x ? patches<2, 2>(nr, Fi) : 0;
    const int n_dw = patches<2, 2>(Fi, Fo);
    const int n_p1 = need_adj ? patches<2, 2>(nr, Fo) : 0;
    float* out_x = need_x ? dx + (static_cast<size_t>(b) * N + r0) * Fi : nullptr;
    for (int i = threadIdx.x; i < n_dx + n_dw + n_p1; i += blockDim.x) {
      if (i < n_dx)
        patch_nt<2, 2>(i, sDY, L.ldo, sW, L.ldw, nr, Fi, 0, ablated(kGradX) ? 0 : Fo,
                       [&](int r, int f, float v) { out_x[r * Fi + f] = v; });
      else if (i < n_dx + n_dw)
        patch<2, 2>(
            i - n_dx, Fi, Fo, ablated(kGradW) ? 0 : nr,
            [&](int f, int j) { return sX[(r0 + j) * L.ldx + f]; },
            [&](int j, int o) { return sDY[j * L.ldo + o]; },
            [&](int f, int o, float v) { sPart[f * Fo + o] = v; });
      else
        patch<2, 2>(
            i - n_dx - n_dw, nr, Fo, ablated(kGradAdj) ? 0 : N,
            [&](int r, int m) {
              return ((add_loop && m == r0 + r) ? loop : sAr[r * L.lda + m]) * sD[m];
            },
            [&](int m, int o) { return sY[m * L.ldo + o]; },
            [&](int r, int o, float v) { sP1[r * L.ldo + o] = v; });
    }

    if (need_adj) {
      __syncthreads();
      // dr = slope (G . P1 + Y . V) of each of the tile's rows, one warp a row
      for (int r = warp; r < nr; r += nwarps) {
        float s = 0.f;
        for (int o = lane; o < Fo; o += 32)
          s = fmaf(sGR[r * L.ldo + o], sP1[r * L.ldo + o],
                   fmaf(sY[(r0 + r) * L.ldo + o], sV[r * L.ldo + o], s));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) sDr[r] *= s;
      }
      __syncthreads();
      // dA[n, m] = d_n d_m G[n] . Y[m] + dr[n] of the tile's rows
      float* out = dadj + (static_cast<size_t>(b) * N + r0) * N;
      for (int p = threadIdx.x; p < patches<2, 2>(nr, N); p += blockDim.x)
        patch_nt<2, 2>(p, sGR, L.ldo, sY, L.ldo, nr, N, 0, ablated(kGradAdj) ? 0 : Fo,
                       [&](int r, int m, float v) {
                         const int n = r0 + r;
                         out[static_cast<size_t>(r) * N + m] =
                             (add_loop && n == m) ? 0.f : fmaf(v * sD[n], sD[m], sDr[r]);
                       });
    }
  } else {
    zero_fill(sPart, L.T);
  }

  if (!ablated(kReduce))
    batch_sum(sPart, L.T, gridDim.x / kCluster, part, L.T, tickets,
              [&](int e, float v) { out_w[e] = v; });
}

}  // namespace

// Shared bytes of a block (one row group of a graph).
extern "C" int gcn_aggregate_bwd_smem(int N, int Fi, int Fo) {
  return static_cast<int>(sizeof(float)) * Layout(N, Fi, Fo).total;
}

// Clusters of a launch over B graphs of N nodes (its blocks: clusters x
// kCluster, the last cluster padded); part holds one partial of F_in *
// F_out + F_out floats for each.
extern "C" int gcn_aggregate_bwd_clusters(int B, int N) {
  return cdiv(B * row_groups(N), kCluster);
}

// x (B, N, F_in), adj (B, N, N), w (F_in, F_out), g = dL/dout (B, N, F_out),
// all contiguous -> dx (B, N, F_in) or null, dadj (B, N, N) or null, and
// out_w (F_in * F_out + F_out): dW then dbias.  part (clusters, F_in *
// F_out + F_out) is scratch; tickets: at least kCluster ints, zero, left
// zero.
// One launch on `stream`; returns its cudaError_t (0 on success).
extern "C" int gcn_aggregate_bwd_run(const float* x, const float* adj, const float* w,
                                     const float* g, float* dx, float* dadj, float* part,
                                     float* out_w, int* tickets, int B, int N, int Fi, int Fo,
                                     int add_loop, float loop, void* stream) {
  static int allowed = -1;  // dynamic shared bytes a block may take
  if (allowed < 0 && (allowed = allow_dynamic_smem(gcn_aggregate_bwd_kernel)) < 0)
    return (int)cudaGetLastError();
  const int smem = gcn_aggregate_bwd_smem(N, Fi, Fo);
  if (smem > allowed) return (int)cudaErrorInvalidValue;
  gcn_aggregate_bwd_kernel<<<gcn_aggregate_bwd_clusters(B, N) * kCluster, kThreads, smem,
                             (cudaStream_t)stream>>>(x, adj, w, g, dx, dadj, part, out_w, tickets,
                                                     B, N, Fi, Fo, add_loop, loop);
  return (int)cudaGetLastError();
}

// Above N = 64: shared bytes of a row-tile block, with or without dA.
extern "C" int gcn_aggregate_bwd_tiled_smem(int N, int Fi, int Fo, int need_adj) {
  return static_cast<int>(sizeof(float)) * TiledLayout(N, Fi, Fo, need_adj != 0).total;
}

// As gcn_aggregate_bwd_run, for N > 64, with deg (B, N) from
// gcn_degrees_run and `clusters` clusters of kCluster blocks (at least
// B * cdiv(N, kTile) blocks, one a row tile of a graph, the rest padding);
// part holds one partial for each cluster.
extern "C" int gcn_aggregate_bwd_tiled_run(const float* x, const float* adj, const float* deg,
                                           const float* w, const float* g, float* dx,
                                           float* dadj, float* part, float* out_w, int* tickets,
                                           int B, int N, int Fi, int Fo, int clusters,
                                           int add_loop, float loop, void* stream) {
  static int allowed = -1;  // dynamic shared bytes a block may take
  if (allowed < 0 && (allowed = allow_dynamic_smem(gcn_aggregate_bwd_tiled_kernel)) < 0)
    return (int)cudaGetLastError();
  const int smem = gcn_aggregate_bwd_tiled_smem(N, Fi, Fo, dadj != nullptr);
  if (smem > allowed || clusters * kCluster < B * cdiv(N, kTile))
    return (int)cudaErrorInvalidValue;
  gcn_aggregate_bwd_tiled_kernel<<<clusters * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, deg, w, g, dx, dadj, part, out_w, tickets, B, N, Fi, Fo, add_loop, loop);
  return (int)cudaGetLastError();
}
