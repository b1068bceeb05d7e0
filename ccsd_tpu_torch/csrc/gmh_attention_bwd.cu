// Backward of the GMH attention of every channel of a layer
// (gmh_attention.cu) in one launch: a block per (graph, channel), the
// blocks of a channel in clusters of eight consecutive graphs, which sum
// their weight and bias gradients in distributed shared memory; the sums
// over the clusters and over a graph's channels (dX) are taken in the same
// launch by the last block to arrive, in a fixed order (grad_common.cuh).
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
// (B = 80, C = 8, N = 20, F_in = attn = F_out = 32, H = 4) the call reads
// and writes ~1.9 MB (0.6 us at 3.35 TB/s) and does ~0.32 GFLOP (4.8 us of
// f32 operations at 67 TFLOP/s), so operations bound it (chip_smoke.py,
// gmh_bwd_cost).  The first design (one output a thread in every product,
// two shared loads an FMA, plain 4-byte staging, the weight partials of
// every block, 8 MB, summed by a second launch and dX by a third) took
// 73.6 us there; scripts/grad_stage_times.py found 22.7 us of loads,
// degrees, barriers and stores, ~47 us in the products (dW 12.0, the
// recomputed NX, Q and K 9.6, gNX 9.2, gQ and gK 6.0, gN 4.2, the head sums
// 3.7, dX 2.5) and 5.0 us in the two sum launches.  What this design does:
//  * cp.async staging in two groups: the adjacency, gA and X first; W, its
//    bias and gV arrive while the degrees, norm and NX are taken.  Every
//    warp sums the degrees it needs itself, so d, norm and gM (symmetrised
//    in place) need one barrier;
//  * register-tiled products: dW 4 x 4 outputs a thread from 16-byte loads,
//    Q and K 2 x 4 (16-byte rows of W, NX read from NX^T), gNX 2 x 4 and the
//    head sums and gN 2 x 2 from 16-byte loads along k (the forward's
//    head-sum patch), the rest 2 x 4 or 2 x 2 patches of 4-byte loads, every
//    operand row at a stride with no bank conflicts; gNX only where dX or dA
//    is asked for (not in the first layer); dW, db, dX and gN in one pass;
//  * the weight partials summed over clusters of eight graphs in
//    distributed shared memory, so an eighth of them reach device memory
//    (1 MB at B = 80, C = 8, not 8), then over the clusters by the last
//    cluster to arrive at each slice's ticket; dX's channel partials by the
//    last channel of each graph.  One launch, no float atomics: results
//    repeat bit for bit.
// Measured on the same card in one call: 59.7-59.9 us at C = 8 (the first
// design 73.6), 18.1-18.2 at C = 2 (25.5).  It stays 12x its bound: the
// stage script finds 22.0 us of skeleton (loads, degrees, barriers, zero
// fills, stores), 12.4 us in the sums over blocks (cluster barriers,
// tickets and their tails) and 1-8 us for each product; at four blocks an
// SM (64 registers a thread, 44 KB) the 640 blocks take two waves of the
// card's 528 places, each wave a chain of ten barrier-separated phases.
// Five blocks an SM (192 threads) and smaller clusters (2, 4) measured
// slower (scripts/grad_stage_times.py, PERF.md).
// The matrices a warp reads down a column have odd row strides, those read
// in 16-byte pieces across rows ld4 strides (gmh_common.cuh).  dX and dA are
// computed only when asked for (null pointers skip them).  The adjacency is
// read, and its gradient written, through their strides, so a later
// layer's channels-last adjacency gets a channels-last gradient.  One
// (graph, channel) a block holds N <= 64; the batch is padded to a
// multiple of the cluster size with blocks that contribute zeros.
//
// Above N = 64 (grid: N = 361) the wrapper takes four launches instead:
// gcn_degrees.cu (d), the forward's gmh_projection (Q | K recomputed into
// a scratch; V discarded), then the two kernels at the end of this file:
//  * gmh_score_grad: a block per (graph, channel, row tile of 32 rows,
//    role): role 0 gives gQ of the tile's rows, role 1 gK, each a sum
//    over all N rows of the other operand in chunks of 32 (the tanh
//    recomputed in each role: 2 B C H N^2 calls), written to a scratch
//    (B, C, N, 2 attn) beside gV;
//  * gmh_attention_bwd_tiled: a block per (graph, row tile, channel), the
//    row-tile scheme of grad_common.cuh over gP = [gQ | gK | gV]:
//    V = A'[:, R]^T (d o gP) over chunks of 32 rows, Z = d_R V
//    (= norm^T gP), the block's dW partial X[R]^T Z and db partial
//    sum_R gP, this channel's dX rows Z W^T (into part_x), and where dA is
//    asked for gNX = gP[R] W^T, U = V W^T, P1 = A'[R, :] (d o X),
//    dr[n] = slope[n] (gNX[n] . P1[n] + X[n] . U[n]) and
//    dA[n, m] = d_n d_m gNX[n] . X[m] + dr[n]; then the sums over the
//    channel's blocks (clusters, tickets) and dX over channels, as above.
// What bounds it at grid's widest layer (B = 8, C = 8, N = 361, F_in =
// attn = F_out = 32, H = 4, with dA): ~3.2 GFLOP of f32 operations, ~48
// us at 67 TFLOP/s, and 2 x 33.4 M tanhf calls; the design is the simple
// one (plain FMA patches, 4-byte copies of strided columns, one block an
// SM in the second kernel).

#include "grad_common.cuh"

namespace {

using namespace grad;

// Shared layout (floats), each region 16-byte aligned:
//   W [Wq | Wk | Wv] Fi x ldw, bias P (then the block's partial, T) |
//   A' N x lda | gA (then gM, then gN) N x ldgn | X N x ldx |
//   norm N x ldn | NX^T Fi x ldt | Q, K N x ldq each (then gNX N x ldnx) |
//   gS H planes of N x ldg | gP N x ldp | d, slope N each
struct Layout {
  int P, T, ldw, lda, ldx, ldn, ldnx, ldt, ldq, ldg, ldp, ldgn, plane;
  int w, bias, adj, gn, x, norm, nxt, q, k, gs, gp, d, slope, total;
  __host__ __device__ Layout(int N, int Fi, int A, int O, int H) {
    P = 2 * A + O;
    T = Fi * P + P;      // dWq | dWk | dWv | dbq | dbk | dbv of one channel
    ldw = ld4(P);        // rows read in 16-byte pieces (Q, K and gNX)
    lda = ld4(N);
    ldx = ld4(Fi);       // rows read along f by gN
    ldn = odd(N);        // rows spread over a warp (NX), columns read by dX
    ldnx = ld4(Fi);      // gNX rows read along f (gN)
    ldt = ld4(N);        // NX^T: rows read along n (dW)
    ldq = ld4(A);        // rows read along the head (head sums)
    ldg = odd(N);        // gS rows spread over a warp (gQ)
    ldp = ld4(P);        // rows read along p (gNX), columns 4 at a time (dW)
    ldgn = odd(N);       // gN read down a column (dA)
    plane = N * ldg;
    w = 0;
    bias = Fi * ldw;     // Fi * ldw + P >= T: the partial fits over W and bias
    adj = round4(bias + P);
    gn = adj + N * lda;
    x = gn + round4(N * ldgn);
    norm = x + N * ldx;
    nxt = norm + round4(N * ldn);
    q = nxt + Fi * ldt;
    k = q + N * ldq;
    gs = q + imax(2 * N * ldq, N * ldnx);
    gp = gs + round4(H * plane);
    d = gp + N * ldp;
    slope = d + N;
    total = slope + N;
  }
};

// four blocks an SM (at most 64 registers a thread; 44 KB of shared memory
// a block at community_small's widest layer)
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 4)
gmh_attention_bwd_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                         const float* __restrict__ wq, const float* __restrict__ bq,
                         const float* __restrict__ wk, const float* __restrict__ bk,
                         const float* __restrict__ wv, const float* __restrict__ bv,
                         const float* __restrict__ gv, const float* __restrict__ ga,
                         float* __restrict__ dx, float* __restrict__ dadj,
                         float* __restrict__ part_x, float* __restrict__ part_w,
                         float* __restrict__ out_w, int* __restrict__ tickets, int B, int C,
                         int N, int Fi, int A, int O, int H, int ds, long long as_b,
                         long long as_c, long long as_n, long long as_m, long long gs_b,
                         long long gs_n, long long gs_m, long long gs_c, long long ds_b,
                         long long ds_c, long long ds_n, long long ds_m, float score_div,
                         int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, Fi, A, O, H);
  const int P = L.P;
  float* sW = smem + L.w;
  float* sPart = smem + L.w;  // over W and bias, once gNX is taken
  float* sBias = smem + L.bias;
  float* sA = smem + L.adj;
  float* sGM = smem + L.gn;  // the raw gA, symmetrised in place, then gN
  float* sGN = smem + L.gn;
  float* sX = smem + L.x;
  float* sNorm = smem + L.norm;
  float* sNXt = smem + L.nxt;
  float* sQ = smem + L.q;
  float* sK = smem + L.k;
  float* sGNX = smem + L.q;  // over Q and K, once gQ and gK are taken
  float* sGS = smem + L.gs;
  float* sGP = smem + L.gp;
  float* sD = smem + L.d;
  float* sSl = smem + L.slope;
  const int b = blockIdx.x, c = blockIdx.y;
  const bool real = b < B;  // else a padding block of the last cluster
  const bool need_x = dx != nullptr, need_adj = dadj != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  if (real) {
    // two groups of copies: first the adjacency of (b, c) and the raw gA
    // through their strides, and X of the graph; then [Wq | Wk | Wv] of
    // channel c and its bias, and gV of channel c into the V columns of gP,
    // which arrive while the degrees, norm and NX are taken
    stage(sA, L.lda, adj + b * as_b + c * as_c, as_n, as_m, N, N);
    stage(sGM, L.ldgn, ga + b * gs_b + c * gs_c, gs_n, gs_m, N, N);
    stage(sX, L.ldx, x + static_cast<size_t>(b) * N * Fi, Fi, 1, N, Fi);
    gmh::cp_async_commit();
    const float* w[3] = {wq + static_cast<size_t>(c) * Fi * A,
                         wk + static_cast<size_t>(c) * Fi * A,
                         wv + static_cast<size_t>(c) * Fi * O};
    const float* bias[3] = {bq ? bq + c * A : nullptr, bk ? bk + c * A : nullptr,
                            bv ? bv + c * O : nullptr};
    for (int m = 0; m < 3; ++m) {
      const int off = m * A, width = m < 2 ? A : O;
      stage(sW + off, L.ldw, w[m], width, 1, Fi, width);
      if (bias[m])
        stage(sBias + off, width, bias[m], width, 1, 1, width);
      else
        zero_fill(sBias + off, width);
    }
    stage(sGP + 2 * A, L.ldp, gv + static_cast<size_t>(b) * N * C * O + c * O, C * O, 1, N, O);
    gmh::cp_async_commit();
    gmh::cp_async_wait<1>();
    __syncthreads();

    // d of every row, by each warp for itself; norm = d A' d one warp a row;
    // gM = (gA + gA^T) / 2 in place, a thread a pair; warp 0 keeps d and
    // slope for dA
    float d[2], sl[2];
    warp_degrees(sA, L.lda, N, add_loop, loop, d, sl);
    for (int r = warp; r < N; r += nwarps) {
      const float dr = shfl_d(d, r);
      for (int j = lane; j < N; j += 32) {
        const float a = (add_loop && r == j) ? loop : sA[r * L.lda + j];
        sNorm[r * L.ldn + j] = dr * a * (j < 32 ? d[0] : d[1]);
      }
    }
    if (warp == 0)
      for (int h = 0; h < 2; ++h)
        if (lane + 32 * h < N) {
          sD[lane + 32 * h] = d[h];
          sSl[lane + 32 * h] = sl[h];
        }
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      const int n = i / N, m = i - n * N;
      if (n > m) continue;
      const float v = 0.5f * (sGM[n * L.ldgn + m] + sGM[m * L.ldgn + n]);
      sGM[n * L.ldgn + m] = sGM[m * L.ldgn + n] = v;
    }
    __syncthreads();

    // NX = norm X, kept as NX^T
    if (ablated(kRecompute))
      zero_fill(sNXt, Fi * L.ldt);
    else
      for (int p = threadIdx.x; p < patches<2, 2>(N, Fi); p += blockDim.x)
        patch<2, 2>(
            p, N, Fi, N, [&](int r, int k) { return sNorm[r * L.ldn + k]; },
            [&](int k, int f) { return sX[k * L.ldx + f]; },
            [&](int r, int f, float v) { sNXt[f * L.ldt + r] = v; });
    gmh::cp_async_wait<0>();  // W, its bias and gV (a thread waits for its own copies)
    __syncthreads();

    // Q, K = NX [Wq | Wk] + bias
    auto qk = [&](int r, int p, float v) {
      v += sBias[p];
      if (p < A)
        sQ[r * L.ldq + p] = v;
      else
        sK[r * L.ldq + p - A] = v;
    };
    if (ablated(kRecompute)) {
      zero_fill(sQ, 2 * N * L.ldq);
    } else if (((2 * A) & 3) == 0) {
      for (int p = threadIdx.x; p < patches4<2>(N, 2 * A); p += blockDim.x)
        patch_tn4<2>(p, sNXt, L.ldt, sW, L.ldw, N, 2 * A, Fi, qk);
    } else {
      for (int p = threadIdx.x; p < patches<2, 4>(N, 2 * A); p += blockDim.x)
        patch<2, 4>(
            p, N, 2 * A, Fi, [&](int r, int k) { return sNXt[k * L.ldt + r]; },
            [&](int k, int q) { return sW[k * L.ldw + q]; }, qk);
    }
    __syncthreads();

    // gS_h[n, m] = s gM[n, m] (1 - tanh(s Q_h[n] . K_h[m])^2) / H; the head
    // sums as the forward takes them (2 x 2 patches along the head)
    const float s = 1.0f / score_div, gscale = s / static_cast<float>(H);
    if (ablated(kScores)) {
      zero_fill(sGS, H * L.plane);
    } else {
      const int per = patches<2, 2>(N, N);
      for (int i = threadIdx.x; i < H * per; i += blockDim.x) {
        const int h = i / per;
        patch_nt<2, 2>(i - h * per, sQ, L.ldq, sK, L.ldq, N, N, h * ds, (h + 1) * ds,
                       [&](int n, int m, float raw) {
                         const float t = tanhf(raw * s);
                         sGS[h * L.plane + n * L.ldg + m] =
                             gscale * sGM[n * L.ldgn + m] * (1.0f - t * t);
                       });
      }
    }
    __syncthreads();

    // gQ[n, h ds + j] = sum_m gS_h[n, m] K[m, h ds + j];
    // gK[m, h ds + j] = sum_n gS_h[n, m] Q[n, h ds + j] (gS_h read down a
    // column: consecutive addresses across the warp)
    if (ablated(kGradQK)) {
      for (int i = threadIdx.x; i < N * 2 * A; i += blockDim.x)
        sGP[(i / (2 * A)) * L.ldp + i % (2 * A)] = 0.f;
    } else {
      const int per = patches<2, 4>(N, ds);
      for (int i = threadIdx.x; i < 2 * H * per; i += blockDim.x) {
        const int which = i / (H * per), h = (i - which * H * per) / per;
        const float* g = sGS + h * L.plane;
        const float* m = (which ? sQ : sK) + h * ds;
        float* out = sGP + which * A + h * ds;
        auto dot = [&](int r, int j, float v) { out[r * L.ldp + j] = v; };
        auto rhs = [&](int k, int j) { return m[k * L.ldq + j]; };
        if (which)
          patch<2, 4>(i % per, N, ds, N, [&](int r, int k) { return g[k * L.ldg + r]; }, rhs,
                      dot);
        else
          patch<2, 4>(i % per, N, ds, N, [&](int r, int k) { return g[r * L.ldg + k]; }, rhs,
                      dot);
      }
    }
    __syncthreads();

    // gNX = gP W^T, where dX or dA is asked for
    if (need_x || need_adj)
      for (int p = threadIdx.x; p < patches<2, 4>(N, Fi); p += blockDim.x)
        patch_nt<2, 4>(p, sGP, L.ldp, sW, L.ldw, N, Fi, 0, ablated(kGradNX) ? 0 : P,
                       [&](int r, int f, float v) { sGNX[r * L.ldnx + f] = v; });
    __syncthreads();

    // one pass: this block's dW = NX^T gP into its partial (over W), in the
    // order of the outputs (dWq | dWk | dWv, each Fi x width), db = sum_n gP
    // after them; this channel's dX = norm^T gNX into its partial in device
    // memory; gN = gNX X^T
    auto dw = [&](int f, int p, float v) {
      const int e = p < A ? f * A + p
                          : (p < 2 * A ? Fi * A + f * A + p - A : 2 * Fi * A + f * O + p - 2 * A);
      sPart[e] = v;
    };
    const bool nn4 = (P & 3) == 0;
    const int n_dw = nn4 ? patches4<4>(Fi, P) : patches<2, 4>(Fi, P);
    const int n_dx = need_x ? patches<2, 4>(N, Fi) : 0;
    const int n_gn = need_adj ? patches<2, 2>(N, N) : 0;
    float* px = need_x ? part_x + (static_cast<size_t>(b) * C + c) * N * Fi : nullptr;
    const int kw = ablated(kGradW) ? 0 : N;
    for (int i = threadIdx.x; i < n_dw + P + n_dx + n_gn; i += blockDim.x) {
      if (i < n_dw) {
        if (nn4)
          patch_nn4<4>(i, sNXt, L.ldt, sGP, L.ldp, Fi, P, kw, dw);
        else
          patch<2, 4>(
              i, Fi, P, kw, [&](int f, int k) { return sNXt[f * L.ldt + k]; },
              [&](int k, int q) { return sGP[k * L.ldp + q]; }, dw);
      } else if (i < n_dw + P) {
        const int p = i - n_dw;
        float acc = 0.f;
        for (int n = 0; n < kw; ++n) acc += sGP[n * L.ldp + p];
        sPart[Fi * P + p] = acc;
      } else if (i < n_dw + P + n_dx) {
        patch<2, 4>(
            i - n_dw - P, N, Fi, ablated(kGradX) ? 0 : N,
            [&](int m, int k) { return sNorm[k * L.ldn + m]; },
            [&](int k, int f) { return sGNX[k * L.ldnx + f]; },
            [&](int m, int f, float v) { px[m * Fi + f] = v; });
      } else {
        patch_nt<2, 2>(i - n_dw - P - n_dx, sGNX, L.ldnx, sX, L.ldx, N, N, 0,
                       ablated(kGradAdj) ? 0 : Fi,
                       [&](int n, int m, float v) { sGN[n * L.ldgn + m] = v; });
      }
    }
    if (need_adj) {
      __syncthreads();
      adj_grad_rows(sGN, L.ldgn, sA, L.lda, sD, sSl, N, 0, N, add_loop, loop,
                    dadj + b * ds_b + c * ds_c, ds_n, ds_m);
    }

    // dx[b] = sum_c part_x[b, c], by the graph's last channel to finish
    if (need_x && !ablated(kReduce) && last_arrival(tickets + C * kCluster + b, C)) {
      const float* pb = part_x + static_cast<size_t>(b) * C * N * Fi;
      for (int i = threadIdx.x; i < N * Fi; i += blockDim.x)
        dx[static_cast<size_t>(b) * N * Fi + i] =
            ordered_sum_l2(pb + i, static_cast<long long>(N) * Fi, C);
    }
  } else {
    zero_fill(sPart, L.T);
  }

  // dW and db of channel c over the batch, into their places in out_w
  // (dWq, dWk, dWv (C, Fi, .), then dbq, dbk, dbv (C, .))
  if (!ablated(kReduce)) {
    // element e of the partial lies in block j of [dWq | dWk | dWv | dbq |
    // dbk | dbv], which starts at start_j in the partial and at C start_j
    // in out_w, a channel's share width_j long
    const int fa = Fi * A, fo = Fi * O, wsz = 2 * fa + fo;
    batch_sum(sPart, L.T, gridDim.x / kCluster, part_w + static_cast<size_t>(c) * L.T,
              static_cast<long long>(C) * L.T, tickets + c * kCluster, [&](int e, float v) {
                int start, width;
                if (e < wsz) {
                  start = e < fa ? 0 : (e < 2 * fa ? fa : 2 * fa);
                  width = e < 2 * fa ? fa : fo;
                } else {
                  start = e < wsz + A ? wsz : (e < wsz + 2 * A ? wsz + A : wsz + 2 * A);
                  width = e < wsz + 2 * A ? A : O;
                }
                out_w[static_cast<size_t>(C) * start + c * width + e - start] = v;
              });
  }
}

// ------------------------------------------------------------ N > 64

// gmh_score_grad's shared layout (floats): this role's rows of the tile
// kTile x ldq | two chunk buffers of the other operand's rows (kTile x
// ldq) and of gA[R, chunk] and gA[chunk, R] (kTile x ldg each) | gS of
// the chunk, H planes of kTile x ldg | the sums kTile x ldq.  Rows read
// across a warp (the other operand's, gS's) have odd strides; a plane
// starts 8 banks after the last, so the four heads a warp reads at one
// column fall in distinct banks.
struct ScoreGradLayout {
  int ldq, ldg, plane, rows, gbuf, rs, ro, g1, g2, gs, out, total;
  __host__ __device__ ScoreGradLayout(int A, int H) {
    ldq = odd(A);
    ldg = odd(kTile);
    plane = kTile * ldg;
    plane += (40 - plane % 32) % 32;
    rows = round4(kTile * ldq);
    gbuf = round4(kTile * ldg);
    rs = 0;
    ro = rs + rows;
    g1 = ro + 2 * rows;
    g2 = g1 + 2 * gbuf;
    gs = g2 + 2 * gbuf;
    out = gs + round4(H * plane);
    total = out + rows;
  }
};

// Block (role, tile) x channel x graph: out[n, j] = sum_m gS_h[n, m]
// R'[m, j] for the tile's rows n, h = j / ds, with
//   gS_h[n, m] = s gM[n, m] (1 - tanh(s R_h[n] . R'_h[m])^2) / H,
//   gM = (gA + gA^T) / 2;
// role 0: R = Q, R' = K (out = gQ); role 1: R = K, R' = Q (out = gK: gM is
// symmetric and the dot the same).  qk and gqk: (B, C, N, 2A), Q then K.
__global__ void __launch_bounds__(kThreads)
gmh_score_grad_kernel(const float* __restrict__ qk, const float* __restrict__ ga,
                      float* __restrict__ gqk, int C, int N, int A, int H, int ds,
                      long long gs_b, long long gs_n, long long gs_m, long long gs_c,
                      float score_div) {
  extern __shared__ __align__(16) float smem[];
  const ScoreGradLayout L(A, H);
  float* sRs = smem + L.rs;
  float* sRo = smem + L.ro;
  float* sG1 = smem + L.g1;
  float* sG2 = smem + L.g2;
  float* sGS = smem + L.gs;
  float* sOut = smem + L.out;
  const int nt = cdiv(N, kTile);
  const int role = blockIdx.x / nt, r0 = (blockIdx.x % nt) * kTile;
  const int nr = min(kTile, N - r0);
  const int c = blockIdx.y, b = blockIdx.z;
  const int A2 = 2 * A;
  const float* base = qk + (static_cast<size_t>(b) * C + c) * N * A2;
  const float* other = base + (1 - role) * A;
  const float* gab = ga + b * gs_b + c * gs_c;
  stage(sRs, L.ldq, base + static_cast<size_t>(r0) * A2 + role * A, A2, 1, nr, A);
  gmh::cp_async_commit();
  const float s = 1.0f / score_div, gscale = s / static_cast<float>(H);

  chunk_loop(
      N,
      [&](int k, int buf) {
        const int m0 = k * kTile, mc = min(kTile, N - m0);
        stage(sRo + buf * L.rows, L.ldq, other + static_cast<size_t>(m0) * A2, A2, 1, mc, A);
        stage(sG1 + buf * L.gbuf, L.ldg, gab + r0 * gs_n + m0 * gs_m, gs_n, gs_m, nr, mc);
        stage(sG2 + buf * L.gbuf, L.ldg, gab + m0 * gs_n + r0 * gs_m, gs_n, gs_m, mc, nr);
      },
      [&](int k, int buf) {
        const int mc = min(kTile, N - k * kTile);
        const float* ro = sRo + buf * L.rows;
        const float* g1 = sG1 + buf * L.gbuf;
        const float* g2 = sG2 + buf * L.gbuf;
        // gS of the chunk: a thread an entry (h, r, m), m fastest
        for (int i = threadIdx.x; i < H * nr * mc; i += blockDim.x) {
          const int m = i % mc, hr = i / mc, r = hr % nr, h = hr / nr;
          const float* a = sRs + r * L.ldq + h * ds;
          const float* o = ro + m * L.ldq + h * ds;
          float dot = 0.f;
          if (!ablated(kScores))
            for (int j = 0; j < ds; ++j) dot = fmaf(a[j], o[j], dot);
          const float t = tanhf(dot * s);
          const float gm = 0.5f * (g1[r * L.ldg + m] + g2[m * L.ldg + r]);
          sGS[h * L.plane + r * L.ldg + m] = gscale * gm * (1.0f - t * t);
        }
        __syncthreads();
        // out[r, j] += sum_m gS_h[r, m] R'[m, j]: a thread an output
        for (int i = threadIdx.x; i < nr * A; i += blockDim.x) {
          const int r = i / A, j = i - r * A;
          const float* gsr = sGS + (j / ds) * L.plane + r * L.ldg;
          float acc = 0.f;
          if (!ablated(kGradQK))
            for (int m = 0; m < mc; ++m) acc = fmaf(gsr[m], ro[m * L.ldq + j], acc);
          float* sum = sOut + r * L.ldq + j;
          *sum = k == 0 ? acc : *sum + acc;
        }
      });

  float* dst = gqk + ((static_cast<size_t>(b) * C + c) * N + r0) * A2 + role * A;
  for (int i = threadIdx.x; i < nr * A; i += blockDim.x) {
    const int r = i / A, j = i - r * A;
    dst[static_cast<size_t>(r) * A2 + j] = sOut[r * L.ldq + j];
  }
}

// gmh_attention_bwd_tiled's shared layout (floats), each region 16-byte
// aligned: [Wq | Wk | Wv] Fi x ldw | X N x ldx | d N | two chunk buffers
// of A' columns R (kTile x ldc) and of gP (kTile x ldp) | V, gP[R], Z
// kTile x ldp | partial dW, db (T) | where dA is asked for: A[R, :] kTile x
// lda | gNX, P1, U kTile x ldx | dr kTile.
struct TiledLayout {
  int P, T, ldw, ldx, ldp, ldc, lda;
  int w, x, d, ac, gc, v, gpr, z, part, ar, gnx, p1, u, dr, total;
  __host__ __device__ TiledLayout(int N, int Fi, int A, int O, bool need_adj) {
    P = 2 * A + O;
    T = Fi * P + P;
    ldw = ld4(P);
    ldx = ld4(Fi);
    ldp = ld4(P);
    ldc = ld4(kTile);
    lda = ld4(N);
    w = 0;
    x = w + Fi * ldw;
    d = x + N * ldx;
    ac = d + round4(N);
    gc = ac + 2 * kTile * ldc;
    v = gc + 2 * kTile * ldp;
    gpr = v + kTile * ldp;
    z = gpr + kTile * ldp;
    part = z + kTile * ldp;
    ar = part + round4(T);
    gnx = ar + (need_adj ? kTile * lda : 0);
    p1 = gnx + (need_adj ? kTile * ldx : 0);
    u = p1 + (need_adj ? kTile * ldx : 0);
    dr = u + (need_adj ? kTile * ldx : 0);
    total = dr + (need_adj ? kTile : 0);
  }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
gmh_attention_bwd_tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ adj, const float* __restrict__ deg,
    const float* __restrict__ wq, const float* __restrict__ wk, const float* __restrict__ wv,
    const float* __restrict__ gqk, const float* __restrict__ gv, float* __restrict__ dx,
    float* __restrict__ dadj, float* __restrict__ part_x, float* __restrict__ part_w,
    float* __restrict__ out_w, int* __restrict__ tickets, int B, int C, int N, int Fi, int A,
    int O, long long as_b, long long as_c, long long as_n, long long as_m, long long ds_b,
    long long ds_c, long long ds_n, long long ds_m, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const bool need_x = dx != nullptr, need_adj = dadj != nullptr;
  const TiledLayout L(N, Fi, A, O, need_adj);
  const int P = L.P, A2 = 2 * A;
  float* sW = smem + L.w;
  float* sX = smem + L.x;
  float* sD = smem + L.d;
  float* sAc = smem + L.ac;
  float* sGc = smem + L.gc;
  float* sV = smem + L.v;
  float* sGPR = smem + L.gpr;
  float* sZ = smem + L.z;
  float* sPart = smem + L.part;
  float* sAr = smem + L.ar;
  float* sGNX = smem + L.gnx;
  float* sP1 = smem + L.p1;
  float* sU = smem + L.u;
  float* sDr = smem + L.dr;
  const int nt = cdiv(N, kTile);
  const int bt = blockIdx.x, c = blockIdx.y;
  const int b = bt / nt, r0 = (bt % nt) * kTile, nr = min(kTile, N - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  if (b < B) {  // else a padding block of the last cluster
    const float* w[3] = {wq + static_cast<size_t>(c) * Fi * A,
                         wk + static_cast<size_t>(c) * Fi * A,
                         wv + static_cast<size_t>(c) * Fi * O};
    for (int m = 0; m < 3; ++m) {
      const int width = m < 2 ? A : O;
      stage(sW + m * A, L.ldw, w[m], width, 1, Fi, width);
    }
    stage(sX, L.ldx, x + static_cast<size_t>(b) * N * Fi, Fi, 1, N, Fi);
    stage(sD, N, deg + (static_cast<size_t>(b) * C + c) * N, N, 1, 1, N);
    const float* gqb = gqk + (static_cast<size_t>(b) * C + c) * N * A2;
    const float* gvb = gv + static_cast<size_t>(b) * N * C * O + static_cast<size_t>(c) * O;
    stage(sGPR, L.ldp, gqb + static_cast<size_t>(r0) * A2, A2, 1, nr, A2);
    stage(sGPR + A2, L.ldp, gvb + static_cast<size_t>(r0) * C * O, C * O, 1, nr, O);
    const float* ab = adj + b * as_b + c * as_c;
    if (need_adj) stage(sAr, L.lda, ab + r0 * as_n, as_n, as_m, nr, N);
    gmh::cp_async_commit();

    // V[r, p] = sum_n A'[n, r0 + r] d_n gP[n, p], over chunks of rows n
    chunk_loop(
        N,
        [&](int k, int buf) {
          const int n0 = k * kTile, mc = min(kTile, N - n0);
          float* gc = sGc + buf * kTile * L.ldp;
          stage(sAc + buf * kTile * L.ldc, L.ldc, ab + n0 * as_n + r0 * as_m, as_n, as_m, mc,
                nr);
          stage(gc, L.ldp, gqb + static_cast<size_t>(n0) * A2, A2, 1, mc, A2);
          stage(gc + A2, L.ldp, gvb + static_cast<size_t>(n0) * C * O, C * O, 1, mc, O);
        },
        [&](int k, int buf) {
          const int n0 = k * kTile, mc = min(kTile, N - n0);
          const float* ac = sAc + buf * kTile * L.ldc;
          const float* gc = sGc + buf * kTile * L.ldp;
          for (int p = threadIdx.x; p < patches<2, 4>(nr, P); p += blockDim.x)
            patch<2, 4>(
                p, nr, P, ablated(kGradX) ? 0 : mc,
                [&](int r, int j) {
                  const int n = n0 + j;
                  return ((add_loop && n == r0 + r) ? loop : ac[j * L.ldc + r]) * sD[n];
                },
                [&](int j, int q) { return gc[j * L.ldp + q]; },
                [&](int r, int q, float v) {
                  float* acc = sV + r * L.ldp + q;
                  *acc = k == 0 ? v : *acc + v;
                });
        });

    // Z = d_R V (norm^T gP of the tile's rows); db = sum of the tile's
    // rows of gP; the slope of the tile's rows where dA is asked for
    for (int i = threadIdx.x; i < nr * P; i += blockDim.x) {
      const int r = i / P, q = i - r * P;
      sZ[r * L.ldp + q] = sD[r0 + r] * sV[r * L.ldp + q];
    }
    for (int q = threadIdx.x; q < P; q += blockDim.x) {
      float acc = 0.f;
      if (!ablated(kGradW))
        for (int r = 0; r < nr; ++r) acc += sGPR[r * L.ldp + q];
      sPart[Fi * P + q] = acc;
    }
    if (need_adj)
      for (int r = warp; r < nr; r += nwarps) {
        const float s = warp_row_sum(sAr + r * L.lda, 1, N, r0 + r, add_loop, loop);
        if (lane == 0) sDr[r] = degree_slope(s);
      }
    __syncthreads();

    // one pass: the block's dW = X[R]^T Z (dWq | dWk | dWv, each Fi x
    // width); this channel's dX rows Z W^T into part_x; where dA is asked
    // for gNX = gP[R] W^T, U = V W^T and P1 = A'[R, :] (d o X)
    auto dw = [&](int f, int q, float v) {
      const int e = q < A ? f * A + q
                          : (q < A2 ? Fi * A + f * A + q - A : 2 * Fi * A + f * O + q - A2);
      sPart[e] = v;
    };
    const int n_dw = patches<2, 4>(Fi, P);
    const int n_dx = need_x ? patches<2, 2>(nr, Fi) : 0;
    const int per = patches<2, 2>(nr, Fi);
    const int n_adj = need_adj ? 3 * per : 0;
    float* px = need_x ? part_x + ((static_cast<size_t>(b) * C + c) * N + r0) * Fi : nullptr;
    for (int i = threadIdx.x; i < n_dw + n_dx + n_adj; i += blockDim.x) {
      if (i < n_dw) {
        patch<2, 4>(
            i, Fi, P, ablated(kGradW) ? 0 : nr,
            [&](int f, int j) { return sX[(r0 + j) * L.ldx + f]; },
            [&](int j, int q) { return sZ[j * L.ldp + q]; }, dw);
      } else if (i < n_dw + n_dx) {
        patch_nt<2, 2>(i - n_dw, sZ, L.ldp, sW, L.ldw, nr, Fi, 0, ablated(kGradX) ? 0 : P,
                       [&](int r, int f, float v) { px[r * Fi + f] = v; });
      } else {
        const int j = i - n_dw - n_dx, which = j / per;
        if (which == 0)
          patch_nt<2, 2>(j - per * which, sGPR, L.ldp, sW, L.ldw, nr, Fi, 0,
                         ablated(kGradNX) ? 0 : P,
                         [&](int r, int f, float v) { sGNX[r * L.ldx + f] = v; });
        else if (which == 1)
          patch_nt<2, 2>(j - per * which, sV, L.ldp, sW, L.ldw, nr, Fi, 0,
                         ablated(kGradNX) ? 0 : P,
                         [&](int r, int f, float v) { sU[r * L.ldx + f] = v; });
        else
          patch<2, 2>(
              j - per * which, nr, Fi, ablated(kGradAdj) ? 0 : N,
              [&](int r, int m) {
                return ((add_loop && m == r0 + r) ? loop : sAr[r * L.lda + m]) * sD[m];
              },
              [&](int m, int f) { return sX[m * L.ldx + f]; },
              [&](int r, int f, float v) { sP1[r * L.ldx + f] = v; });
      }
    }

    if (need_adj) {
      __syncthreads();
      // dr = slope (gNX . P1 + X . U) of each of the tile's rows, one warp a row
      for (int r = warp; r < nr; r += nwarps) {
        float s = 0.f;
        for (int f = lane; f < Fi; f += 32)
          s = fmaf(sGNX[r * L.ldx + f], sP1[r * L.ldx + f],
                   fmaf(sX[(r0 + r) * L.ldx + f], sU[r * L.ldx + f], s));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) sDr[r] *= s;
      }
      __syncthreads();
      // dA[n, m] = d_n d_m gNX[n] . X[m] + dr[n] of the tile's rows
      float* out = dadj + b * ds_b + c * ds_c + r0 * ds_n;
      for (int p = threadIdx.x; p < patches<2, 2>(nr, N); p += blockDim.x)
        patch_nt<2, 2>(p, sGNX, L.ldx, sX, L.ldx, nr, N, 0, ablated(kGradAdj) ? 0 : Fi,
                       [&](int r, int m, float v) {
                         const int n = r0 + r;
                         out[r * ds_n + m * ds_m] =
                             (add_loop && n == m) ? 0.f : fmaf(v * sD[n], sD[m], sDr[r]);
                       });
    }

    // dx[b, R] = sum_c part_x[b, c, R], by the last of the C channels'
    // blocks of this row tile to finish
    if (need_x && !ablated(kReduce) && last_arrival(tickets + C * kCluster + bt, C)) {
      const float* pb = part_x + (static_cast<size_t>(b) * C * N + r0) * Fi;
      float* xb = dx + (static_cast<size_t>(b) * N + r0) * Fi;
      for (int i = threadIdx.x; i < nr * Fi; i += blockDim.x)
        xb[i] = ordered_sum_l2(pb + i, static_cast<long long>(N) * Fi, C);
    }
  } else {
    zero_fill(sPart, L.T);
  }

  // dW and db of channel c over the batch, as the one-block kernel takes them
  if (!ablated(kReduce)) {
    const int fa = Fi * A, fo = Fi * O, wsz = 2 * fa + fo;
    batch_sum(sPart, L.T, gridDim.x / kCluster, part_w + static_cast<size_t>(c) * L.T,
              static_cast<long long>(C) * L.T, tickets + c * kCluster, [&](int e, float v) {
                int start, width;
                if (e < wsz) {
                  start = e < fa ? 0 : (e < 2 * fa ? fa : 2 * fa);
                  width = e < 2 * fa ? fa : fo;
                } else {
                  start = e < wsz + A ? wsz : (e < wsz + 2 * A ? wsz + A : wsz + 2 * A);
                  width = e < wsz + 2 * A ? A : O;
                }
                out_w[static_cast<size_t>(C) * start + c * width + e - start] = v;
              });
  }
}

}  // namespace

// Shared bytes of a block (one graph, one channel).
extern "C" int gmh_attention_bwd_smem(int N, int Fi, int A, int O, int H) {
  return static_cast<int>(sizeof(float)) * Layout(N, Fi, A, O, H).total;
}

// Clusters of each channel's blocks over B graphs (the last one padded).
extern "C" int gmh_attention_bwd_clusters(int B) { return cdiv(B, kCluster); }

// x (B, N, F_in) contiguous; adj (B, C, N, N) through strides as_*;
// w* (C, F_in, .), b* (C, .) or null, contiguous; gv = dL/dV (B, N, C F_out)
// contiguous; ga = dL/dA (B, N, N, C) through strides gs_* (b, n, m, c).
// Writes dx (B, N, F_in) or skips it (null), dadj (B, C, N, N) through
// strides ds_* or skips it (null), and out_w: dWq, dWk, dWv, dbq, dbk, dbv
// one after another, each contiguous (biases' gradients also where a bias
// is null).  part_x (B, C, N, F_in) (null with dx) and part_w (clusters,
// size of out_w) are scratch; tickets: at least kCluster C + B ints, zero,
// left zero.  One launch on `stream`; returns its cudaError_t
// (0 on success).
extern "C" int gmh_attention_bwd_run(const float* x, const float* adj, const float* wq,
                                     const float* bq, const float* wk, const float* bk,
                                     const float* wv, const float* bv, const float* gv,
                                     const float* ga, float* dx, float* dadj, float* part_x,
                                     float* part_w, float* out_w, int* tickets, int B, int C,
                                     int N, int Fi, int A, int O, int H, int ds, long long as_b,
                                     long long as_c, long long as_n, long long as_m,
                                     long long gs_b, long long gs_n, long long gs_m,
                                     long long gs_c, long long ds_b, long long ds_c,
                                     long long ds_n, long long ds_m, float score_div,
                                     int add_loop, float loop, void* stream) {
  static int allowed = -1;  // dynamic shared bytes a block may take
  if (allowed < 0 && (allowed = allow_dynamic_smem(gmh_attention_bwd_kernel)) < 0)
    return (int)cudaGetLastError();
  const int smem = gmh_attention_bwd_smem(N, Fi, A, O, H);
  if (smem > allowed || (dx == nullptr) != (part_x == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gmh_attention_bwd_clusters(B) * kCluster, C);
  gmh_attention_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, wq, bq, wk, bk, wv, bv, gv, ga, dx, dadj, part_x, part_w, out_w, tickets, B, C, N,
      Fi, A, O, H, ds, as_b, as_c, as_n, as_m, gs_b, gs_n, gs_m, gs_c, ds_b, ds_c, ds_n, ds_m,
      score_div, add_loop, loop);
  return (int)cudaGetLastError();
}

// Above N = 64: shared bytes of a gmh_score_grad block, and of a
// gmh_attention_bwd_tiled block with or without dA.
extern "C" int gmh_score_grad_smem(int A, int H) {
  return static_cast<int>(sizeof(float)) * ScoreGradLayout(A, H).total;
}

extern "C" int gmh_attention_bwd_tiled_smem(int N, int Fi, int A, int O, int need_adj) {
  return static_cast<int>(sizeof(float)) * TiledLayout(N, Fi, A, O, need_adj != 0).total;
}

// qk (B, C, N, 2A) contiguous, Q | K of gmh_projection_run; ga = dL/dA
// (B, N, N, C) through strides gs_* (b, n, m, c) -> gqk (B, C, N, 2A):
// gQ | gK.  One launch on `stream`; returns its cudaError_t.
extern "C" int gmh_score_grad_run(const float* qk, const float* ga, float* gqk, int B, int C,
                                  int N, int A, int H, int ds, long long gs_b, long long gs_n,
                                  long long gs_m, long long gs_c, float score_div,
                                  void* stream) {
  static int allowed = -1;
  if (allowed < 0 && (allowed = allow_dynamic_smem(gmh_score_grad_kernel)) < 0)
    return (int)cudaGetLastError();
  const int smem = gmh_score_grad_smem(A, H);
  if (smem > allowed || B > 65535 || C > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(2 * cdiv(N, kTile), C, B);
  gmh_score_grad_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      qk, ga, gqk, C, N, A, H, ds, gs_b, gs_n, gs_m, gs_c, score_div);
  return (int)cudaGetLastError();
}

// x (B, N, F_in) contiguous; adj (B, C, N, N) through strides as_*; deg
// (B, C, N) of gcn_degrees_run; w* (C, F_in, .) contiguous; gqk (B, C, N,
// 2A) of gmh_score_grad_run; gv = dL/dV (B, N, C F_out) contiguous.
// Writes dx (or skips it: null), dadj through strides ds_* (or skips it),
// out_w as gmh_attention_bwd_run.  `clusters` clusters of kCluster blocks
// a channel (at least B * cdiv(N, kTile) blocks, one a row tile of a
// graph); part_x (B, C, N, F_in) (null with dx) and part_w (clusters,
// size of out_w) are scratch; tickets: at least kCluster C + B cdiv(N,
// kTile) ints, zero, left zero.  One launch; returns its cudaError_t.
extern "C" int gmh_attention_bwd_tiled_run(
    const float* x, const float* adj, const float* deg, const float* wq, const float* wk,
    const float* wv, const float* gqk, const float* gv, float* dx, float* dadj, float* part_x,
    float* part_w, float* out_w, int* tickets, int B, int C, int N, int Fi, int A, int O,
    int clusters, long long as_b, long long as_c, long long as_n, long long as_m,
    long long ds_b, long long ds_c, long long ds_n, long long ds_m, int add_loop, float loop,
    void* stream) {
  static int allowed = -1;
  if (allowed < 0 && (allowed = allow_dynamic_smem(gmh_attention_bwd_tiled_kernel)) < 0)
    return (int)cudaGetLastError();
  const int smem = gmh_attention_bwd_tiled_smem(N, Fi, A, O, dadj != nullptr);
  if (smem > allowed || (dx == nullptr) != (part_x == nullptr) ||
      clusters * kCluster < B * cdiv(N, kTile) || C > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(clusters * kCluster, C);
  gmh_attention_bwd_tiled_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, adj, deg, wq, wk, wv, gqk, gv, dx, dadj, part_x, part_w, out_w, tickets, B, C, N, Fi,
      A, O, as_b, as_c, as_n, as_m, ds_b, ds_c, ds_n, ds_m, add_loop, loop);
  return (int)cudaGetLastError();
}
