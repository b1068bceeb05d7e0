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
// graph in row tiles and reads d from a gcn_degrees.cu launch (the
// forward's, which the wrapper keeps; the row-tile scheme of
// grad_common.cuh).  For a tile R the gradients are
//   V = A'[:, R]^T (d o G), a sum over all N rows n (dY[R] = d_R V);
//   dX[R] = dY W^T; the tile's dW partial X[R]^T dY and db partial sum_R G;
//   where dA is asked for, Y = X W of every row, P1 = A'[R, :] (d o Y),
//   dr[n] = slope[n] (G[n] . P1[n] + Y[n] . V[n]) and
//   dA[n, m] = d_n d_m G[n] . Y[m] + dr[n].
// What bounds it at grid's layers (B = 8, F 32 -> 32, no dA): ~5 MB of
// inputs, ~1.6 us at 3.35 TB/s.  The first tiled design (a block a 32-row
// tile, 96 blocks at grid; V's sum a serial chain of 12 double-buffered
// chunks of 32 rows; X of every row staged; the weight sums over clusters
// of 8 tiles) took 41.6 / 43.5 us a launch at F_in 5 / 32 on an NVIDIA
// H100 80GB HBM3 at 700 W, instruction-bound (scripts/grad_stage_times.py:
// its V chain 23 us, its cluster and ticket sums 15).  This design:
//  * tiles of gcn_aggregate's gcn_rows(N) rows (16 tiles of 23 at N = 361:
//    128 blocks for 132 SMs, not 96), a block each;
//  * the block forms the partials c_k of all 12 chunks of V's sum at once,
//    a thread a 4 x 4 patch of a chunk (A' d formed as it is read, then
//    FMAs in row order, as the first design formed them), and folds V =
//    ((c_0 + c_1) + c_2) + ... in chunk order: V, dY and dX keep the first
//    design's bits;
//  * A' and G arrive by copies with no index arithmetic beyond a row's
//    step; only X of the tile's rows is staged;
//  * the sums over tiles: tile partials in groups of 8 tiles, then the
//    groups', by tickets (no clusters, no float atomics).  dW and db are
//    summed over tiles of 23 rows, not 32, so their bits differ from the
//    first design's (PERF.md §6 PR 15).
// On the same card: 16.5 / 17.7 us a launch at F_in 5 / 32; without the
// products 13.0 / 14.2, without the sums over tiles (two levels of fences
// and tickets) 12.1 / 12.9, the skeleton (loads, barriers, stores) 7.6 /
// 8.1.  Tiles of 32 rows (96 blocks) took 17.9 / 19.5, the chunks in two
// passes 17.4 / 20.1.

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
//
// A block takes a row tile R = [r0, r0 + nr) of `rows` (<= kTile) rows of
// a graph; the grid is (tiles, B).  V's sum over n runs over the nk =
// cdiv(N, kTile) chunks of kTile rows, pc chunks at a time (a pass; all of
// them at grid's N = 361): each chunk's partial c_k by threads of its own,
// then folded into V in chunk order.

constexpr int kMaxThreads = 768;  // threads of a block, at most
constexpr int kGroup = 8;         // tile partials summed together (see the kernel's end)

// Threads of a block: one a 4 x 4 patch of each chunk of a pass (at least
// four warps, at most kMaxThreads).
__host__ __device__ inline int tiled_threads(int Fo, int rows, int pc) {
  const int t = 32 * cdiv(cdiv(rows, 4) * cdiv(Fo, 4) * pc, 32);
  return t < 128 ? 128 : (t > kMaxThreads ? kMaxThreads : t);
}

// Shared layout (floats), each region 16-byte aligned: W Fi x ldw | X
// rows x ldx (the tile's rows; every row, N x ldx, where dA is asked for)
// | d N | G of the tile's rows, rows x ldo | a ring of `slots` passes of A'
// columns R (pc x kTile x ldc) and of G (pc x kTile x ldg: a chunk's rows
// as they lie in memory where F_out % 4 == 0, so one run of copies) | the
// pass's chunk partials (pc x round4(rows) x ldo; none at one chunk a
// pass, whose partial goes straight into V) | V round4(rows) x ldo | dY
// rows x ldo | where dA is asked for: Y N x ldo, A' rows x lda, P1 rows x
// ldo, dr rows.
struct TiledLayout {
  int nk, slots, T, ldw, ldx, ldo, ldg, ldc, lda;
  int w, x, d, gt, ac, gc, c, v, dy, y, ar, p1, dr, total;
  __host__ __device__ TiledLayout(int N, int Fi, int Fo, int rows, int pc, bool need_adj) {
    nk = cdiv(N, kTile);
    slots = pc < nk ? 2 : 1;
    T = Fi * Fo + Fo;
    ldw = ld4(Fo);     // W rows read along o (dX) and 4 columns at a time (Y)
    ldx = ld4(Fi);
    ldo = ld4(Fo);     // 16-byte loads of 4 columns (the fold)
    ldg = round4(Fo);  // a warp reads a row of it (V)
    ldc = ld4(rows);   // 16-byte loads of 4 rows (V)
    lda = ld4(N);
    w = 0;
    x = w + Fi * ldw;
    d = x + (need_adj ? N : rows) * ldx;
    gt = d + round4(N);
    ac = gt + rows * ldo;
    gc = ac + slots * pc * kTile * ldc;
    c = gc + slots * pc * kTile * ldg;
    v = c + (pc > 1 ? pc * round4(rows) * ldo : 0);
    dy = v + round4(rows) * ldo;
    y = dy + rows * ldo;
    ar = y + (need_adj ? N * ldo : 0);
    p1 = ar + (need_adj ? rows * lda : 0);
    dr = p1 + (need_adj ? rows * ldo : 0);
    total = dr + (need_adj ? round4(rows) : 0);
  }
};

__global__ void __launch_bounds__(kMaxThreads, 1)
gcn_aggregate_bwd_tiled_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                               const float* __restrict__ deg, const float* __restrict__ w,
                               const float* __restrict__ g, float* __restrict__ dx,
                               float* __restrict__ dadj, float* __restrict__ part,
                               float* __restrict__ out_w, int* __restrict__ tickets, int B,
                               int N, int Fi, int Fo, int rows, int pc, int add_loop,
                               float loop) {
  extern __shared__ __align__(16) float smem[];
  const bool need_x = dx != nullptr, need_adj = dadj != nullptr;
  const TiledLayout L(N, Fi, Fo, rows, pc, need_adj);
  float* sW = smem + L.w;
  float* sX = smem + L.x;
  float* sD = smem + L.d;
  float* sGT = smem + L.gt;
  float* sAc = smem + L.ac;
  float* sGc = smem + L.gc;
  float* sC = smem + L.c;
  float* sV = smem + L.v;
  float* sDY = smem + L.dy;
  float* sY = smem + L.y;
  float* sAr = smem + L.ar;
  float* sP1 = smem + L.p1;
  float* sDr = smem + L.dr;
  const int t = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int r0 = t * rows, nr = min(rows, N - r0);
  const int T = L.T, FF = Fi * Fo, FG = cdiv(Fo, 4), RG = cdiv(rows, 4), P = RG * FG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const float* ab = adj + static_cast<size_t>(b) * N * N;
  const float* gb = g + static_cast<size_t>(b) * N * Fo;

  // read whole: W (for dX or dA), X of the tile's rows (of every row for
  // dA), d, G of the tile's rows; for dA the tile's rows of A
  if (need_x || need_adj) stage(sW, L.ldw, w, Fo, 1, Fi, Fo);
  stage(sX, L.ldx, x + (static_cast<size_t>(b) * N + (need_adj ? 0 : r0)) * Fi, Fi, 1,
        need_adj ? N : nr, Fi);
  stage(sD, N, deg + static_cast<size_t>(b) * N, N, 1, 1, N);
  stage(sGT, L.ldo, gb + static_cast<size_t>(r0) * Fo, Fo, 1, nr, Fo);
  if (need_adj) stage(sAr, L.lda, ab + static_cast<size_t>(r0) * N, N, 1, nr, N);
  gmh::cp_async_commit();

  // A'[n0 + j, r0 + c] (c < nr) for j < mc, as it stands: a warp a row,
  // a lane a column (4-byte copies: a row of N floats is rarely 16-byte
  // aligned), no index arithmetic beyond a row's step
  auto columns = [&](float* dst, int n0, int mc) {
    const float* src = ab + static_cast<size_t>(n0) * N + r0 + lane;
    for (int j = warp; j < mc && lane < nr; j += nwarps) {
      if (ablated(kLoads))
        dst[j * L.ldc + lane] = 0.f;
      else
        gmh::cp_async4(dst + j * L.ldc + lane, src + static_cast<size_t>(j) * N);
    }
  };
  // G[n0 + j, :] for j < mc: one run of 16-byte copies where F_out % 4 ==
  // 0 (the rows lie as in memory), else row by row
  auto g_rows = [&](float* dst, int n0, int mc) {
    const float* src = gb + static_cast<size_t>(n0) * Fo;
    if (L.ldg != Fo || ablated(kLoads) || (reinterpret_cast<uintptr_t>(src) & 15)) {
      stage(dst, L.ldg, src, Fo, 1, mc, Fo);
      return;
    }
    for (int i = 4 * tid; i < mc * Fo; i += 4 * blockDim.x) gmh::cp_async16(dst + i, src + i);
  };

  // c_k[r, o] = sum_{j < mc} (A'[n0 + j, r0 + r] d_{n0 + j}) G[n0 + j, o]
  // for the chunks k of a pass (n0 = k kTile, mc rows): a thread a 4 x 4
  // patch of one chunk (a warp's row groups share its G loads), A' d
  // formed as it is read (the assigned diagonal written in first), each
  // output's FMAs in j order; then V = ((c_0 + c_1) + c_2) + ... in chunk
  // order, by a thread four columns of a row
  const int nd0 = r0 / kTile, nd1 = (r0 + nr - 1) / kTile;  // chunks holding the diagonal
  ring_loop(
      cdiv(L.nk, pc),
      [&](int p, int buf) {
        for (int cc = 0; cc < pc && p * pc + cc < L.nk; ++cc) {
          const int n0 = (p * pc + cc) * kTile, mc = min(kTile, N - n0);
          columns(sAc + (buf * pc + cc) * kTile * L.ldc, n0, mc);
          g_rows(sGc + (buf * pc + cc) * kTile * L.ldg, n0, mc);
        }
      },
      [&](int p, int buf) {
        const int k0 = p * pc, nch = min(pc, L.nk - k0);
        float* ac = sAc + buf * pc * kTile * L.ldc;
        const float* gc = sGc + buf * pc * kTile * L.ldg;
        if (add_loop && nd1 >= k0 && nd0 < k0 + nch) {
          for (int r = tid; r < nr; r += blockDim.x) {
            const int n = r0 + r;
            if (n / kTile >= k0 && n / kTile < k0 + nch)
              ac[(n - k0 * kTile) * L.ldc + r] = loop;
          }
          __syncthreads();
        }
        for (int i = tid; i < nch * P; i += blockDim.x) {
          const int cc = i / P, pp = i - cc * P, rg = pp % RG, og = pp / RG;
          const int n0 = (k0 + cc) * kTile, mc = min(kTile, N - n0);
          const float* a = ac + cc * kTile * L.ldc + 4 * rg;
          const float* bb = gc + cc * kTile * L.ldg + 4 * og;
          const float* dn = sD + n0;
          float acc[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
          const int K = ablated(kGradY) ? 0 : mc;
#pragma unroll 4
          for (int j = 0; j < K; ++j) {
            const float4 av = *reinterpret_cast<const float4*>(a + j * L.ldc);
            const float4 bv = *reinterpret_cast<const float4*>(bb + j * L.ldg);
            const float d = dn[j];
            const float ar4[4] = {av.x * d, av.y * d, av.z * d, av.w * d};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[u][0] = fmaf(ar4[u], bv.x, acc[u][0]);
              acc[u][1] = fmaf(ar4[u], bv.y, acc[u][1]);
              acc[u][2] = fmaf(ar4[u], bv.z, acc[u][2]);
              acc[u][3] = fmaf(ar4[u], bv.w, acc[u][3]);
            }
          }
          float* out = (pc > 1 ? sC + cc * 4 * RG * L.ldo : sV) + 4 * rg * L.ldo + 4 * og;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float4 c = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
            float4* o4 = reinterpret_cast<float4*>(out + u * L.ldo);
            if (pc == 1 && k0 > 0 && !ablated(kGradV)) {  // V += c_k, this thread's own
              const float4 v = *o4;
              c = make_float4(v.x + c.x, v.y + c.y, v.z + c.z, v.w + c.w);
            }
            *o4 = c;
          }
        }
        if (pc == 1) return;
        __syncthreads();
        for (int i = tid; i < nr * FG; i += blockDim.x) {
          const int r = i / FG, o = 4 * (i - r * FG);
          float4* vr = reinterpret_cast<float4*>(sV + r * L.ldo + o);
          float4 v = *vr;
          for (int cc = 0; cc < nch; ++cc) {
            const float4 u = *reinterpret_cast<const float4*>(sC + (cc * 4 * RG + r) * L.ldo + o);
            if (k0 + cc == 0 || ablated(kGradV)) {
              v = u;
            } else {
              v.x += u.x;
              v.y += u.y;
              v.z += u.z;
              v.w += u.w;
            }
          }
          *vr = v;
        }
      });

  // dY = d_R V
  for (int i = tid; i < nr * FG; i += blockDim.x) {
    const int r = i / FG, o = 4 * (i - r * FG);
    const float4 v = *reinterpret_cast<const float4*>(sV + r * L.ldo + o);
    const float dn = sD[r0 + r];
    *reinterpret_cast<float4*>(sDY + r * L.ldo + o) =
        make_float4(dn * v.x, dn * v.y, dn * v.z, dn * v.w);
  }
  if (need_adj)  // the slope of each row of the tile, one warp a row
    for (int r = warp; r < nr; r += nwarps) {
      const float s = warp_row_sum(sAr + r * L.lda, 1, N, r0 + r, add_loop, loop);
      if (lane == 0) sDr[r] = degree_slope(s);
    }
  __syncthreads();

  // dX[R] = dY W^T; the tile's partial of dW = X[R]^T dY and db = the sum
  // of G's rows of R, each output's terms in row order; Y = X W of every
  // row where dA is asked for
  const int n_dx = need_x ? patches<2, 2>(nr, Fi) : 0;
  const int n_w = patches<2, 2>(Fi, Fo);
  const int n_y = need_adj ? patches<2, 4>(N, Fo) : 0;
  float* tpart = part + (static_cast<size_t>(b) * nt + t) * T;
  float* out_x = need_x ? dx + (static_cast<size_t>(b) * N + r0) * Fi : nullptr;
  const float* sXR = sX + (need_adj ? r0 : 0) * L.ldx;
  for (int i = tid; i < n_dx + n_w + Fo + n_y; i += blockDim.x) {
    if (i < n_dx) {
      patch_nt<2, 2>(i, sDY, L.ldo, sW, L.ldw, nr, Fi, 0, ablated(kGradX) ? 0 : Fo,
                     [&](int r, int f, float v) { out_x[r * Fi + f] = v; });
    } else if (i < n_dx + n_w) {
      patch<2, 2>(
          i - n_dx, Fi, Fo, ablated(kGradW) ? 0 : nr,
          [&](int f, int j) { return sXR[j * L.ldx + f]; },
          [&](int j, int o) { return sDY[j * L.ldo + o]; },
          [&](int f, int o, float v) { tpart[f * Fo + o] = v; });
    } else if (i < n_dx + n_w + Fo) {
      const int o = i - n_dx - n_w;
      float s = 0.f;
      for (int r = 0; r < (ablated(kGradW) ? 0 : nr); ++r) s += sGT[r * L.ldo + o];
      tpart[FF + o] = s;
    } else {
      patch<2, 4>(
          i - n_dx - n_w - Fo, N, Fo, ablated(kGradAdj) ? 0 : Fi,
          [&](int r, int f) { return sX[r * L.ldx + f]; },
          [&](int f, int o) { return sW[f * L.ldw + o]; },
          [&](int r, int o, float v) { sY[r * L.ldo + o] = v; });
    }
  }

  if (need_adj) {
    __syncthreads();
    // P1 = A'[R, :] (d o Y)
    for (int p = tid; p < patches<2, 2>(nr, Fo); p += blockDim.x)
      patch<2, 2>(
          p, nr, Fo, ablated(kGradAdj) ? 0 : N,
          [&](int r, int m) {
            return ((add_loop && m == r0 + r) ? loop : sAr[r * L.lda + m]) * sD[m];
          },
          [&](int m, int o) { return sY[m * L.ldo + o]; },
          [&](int r, int o, float v) { sP1[r * L.ldo + o] = v; });
    __syncthreads();
    // dr = slope (G . P1 + Y . V) of each row, one warp a row
    for (int r = warp; r < nr; r += nwarps) {
      float s = 0.f;
      for (int o = lane; o < Fo; o += 32)
        s = fmaf(sGT[r * L.ldo + o], sP1[r * L.ldo + o],
                 fmaf(sY[(r0 + r) * L.ldo + o], sV[r * L.ldo + o], s));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sDr[r] *= s;
    }
    __syncthreads();
    // dA[n, m] = d_n d_m G[n] . Y[m] + dr[n] of the tile's rows
    float* out = dadj + (static_cast<size_t>(b) * N + r0) * N;
    for (int p = tid; p < patches<2, 2>(nr, N); p += blockDim.x)
      patch_nt<2, 2>(p, sGT, L.ldo, sY, L.ldo, nr, N, 0, ablated(kGradAdj) ? 0 : Fo,
                     [&](int r, int m, float v) {
                       const int n = r0 + r;
                       out[static_cast<size_t>(r) * N + m] =
                           (add_loop && n == m) ? 0.f : fmaf(v * sD[n], sD[m], sDr[r]);
                     });
  }

  // The sums over the row tiles: the tiles' partials in groups of kGroup
  // consecutive (graph, tile) pairs, each group's summed from its first in
  // order (zeros past the last tile), then the groups' sums from zero in
  // group order (a single group's is the result), as the first tiled
  // design's cluster and ticket sums took them.  The last block to arrive
  // at a group's ticket takes its sums, the last at the groups' ticket
  // the result; no float atomics.
  if (!ablated(kReduce)) {
    const int tiles = B * nt, tl = b * nt + t, grp = tl / kGroup, ngrp = cdiv(tiles, kGroup);
    const int members = min(kGroup, tiles - grp * kGroup);
    float* gsum = part + static_cast<size_t>(tiles) * T;
    // a thread two elements e and e + blockDim.x at a time, every load of
    // a step in flight together
    const int step = 2 * blockDim.x;
    if (last_arrival(tickets + grp, members)) {
      const float* pg = part + static_cast<size_t>(grp) * kGroup * T;
      for (int e = tid; e < T; e += step) {
        float v[2][kGroup];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int m = 0; m < kGroup; ++m) {
            const int eh = e + h * blockDim.x;
            v[h][m] = m < members && eh < T ? __ldcg(pg + m * T + eh) : 0.f;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int eh = e + h * blockDim.x;
          float s = v[h][0];
#pragma unroll
          for (int m = 1; m < kGroup; ++m) s += v[h][m];
          if (eh >= T) continue;
          if (ngrp == 1)
            out_w[eh] = s;
          else
            gsum[static_cast<size_t>(grp) * T + eh] = s;
        }
      }
      if (ngrp > 1 && last_arrival(tickets + ngrp, ngrp))
        for (int e = tid; e < T; e += step) {
          float s[2] = {0.f, 0.f};
          for (int k0 = 0; k0 < ngrp; k0 += 2 * kGroup) {
            float v[2][2 * kGroup];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int u = 0; u < 2 * kGroup; ++u) {
                const int eh = e + h * blockDim.x;
                v[h][u] = k0 + u < ngrp && eh < T ? __ldcg(gsum + (k0 + u) * T + eh) : 0.f;
              }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int u = 0; u < 2 * kGroup; ++u)
                if (k0 + u < ngrp) s[h] += v[h][u];
          }
          for (int h = 0; h < 2; ++h)
            if (e + h * blockDim.x < T) out_w[e + h * blockDim.x] = s[h];
        }
    }
  }
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

// Above N = 64: shared bytes of a block of a row tile of `rows` rows
// that takes pc chunks a pass, with or without dA.
extern "C" int gcn_aggregate_bwd_tiled_smem(int N, int Fi, int Fo, int rows, int pc,
                                            int need_adj) {
  return static_cast<int>(sizeof(float)) * TiledLayout(N, Fi, Fo, rows, pc, need_adj != 0).total;
}

// As gcn_aggregate_bwd_run, for N > 64, with deg (B, N) from
// gcn_degrees_run, row tiles of `rows` (<= kTile) rows, each block taking
// pc chunks of kTile rows a pass; part holds a partial for each row tile,
// then one for each group of kGroup tiles; tickets: at least
// cdiv(B cdiv(N, rows), kGroup) + 1 ints, zero, left zero.
extern "C" int gcn_aggregate_bwd_tiled_run(const float* x, const float* adj, const float* deg,
                                           const float* w, const float* g, float* dx,
                                           float* dadj, float* part, float* out_w, int* tickets,
                                           int B, int N, int Fi, int Fo, int rows, int pc,
                                           int add_loop, float loop, void* stream) {
  static int allowed = -1;  // dynamic shared bytes a block may take
  if (allowed < 0 && (allowed = allow_dynamic_smem(gcn_aggregate_bwd_tiled_kernel)) < 0)
    return (int)cudaGetLastError();
  if (rows < 1 || rows > kTile || pc < 1 || pc > cdiv(N, kTile) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = gcn_aggregate_bwd_tiled_smem(N, Fi, Fo, rows, pc, dadj != nullptr);
  if (smem > allowed) return (int)cudaErrorInvalidValue;
  gcn_aggregate_bwd_tiled_kernel<<<dim3(cdiv(N, rows), B), tiled_threads(Fo, rows, pc), smem,
                                   (cudaStream_t)stream>>>(x, adj, deg, w, g, dx, dadj, part,
                                                           out_w, tickets, B, N, Fi, Fo, rows,
                                                           pc, add_loop, loop);
  return (int)cudaGetLastError();
}
