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
// Above N = 64 (grid: N = 361) the wrapper takes five launches instead:
// gcn_degrees.cu (d), the forward's gmh_projection (Q | K recomputed into
// a scratch; V discarded), then the three kernels at the end of this file,
// each counted under its own name:
//  * gmh_bwd_layout: gm = (gA + gA^T) / 2 channel-major, and the adjacency
//    copied channel-major where its rows are not unit-stride;
//  * gmh_score_grad: gQ | gK into a scratch (B, C, N, 2 attn), a cluster
//    of row-tile blocks a (graph, channel);
//  * gmh_attention_bwd_tiled: every gradient, a block a (graph, row tile,
//    channel), over gP = [gQ | gK | gV].
// What bounds them at grid's widest layer (B = 8, C = 8, N = 361, F_in =
// attn = F_out = 32, H = 4, with dX and dA): gmh_score_grad does 33.4 M
// tanhf (19.8 us at the card's measured tanhf rate) among 1.8 GFLOP (26.9
// us at 67 TFLOP/s); the row-tile kernel 3.2 GFLOP (47.1 us: V = A'^T (d
// o gP) is 2 N^2 P a (graph, channel), P1 and dA 2 N^2 F_in each):
// operations; the layout pass moves 134 MB (39.8 us at 3.35 TB/s): bytes
// (chip_smoke.py: score_grad_cost, row_tile_cost, layout_cost).  The first
// tiled design took 747 us for gQ | gK and ~920 for the rest: two blocks
// (gQ's, gK's) computed every tanh, a thread an output of each product at
// two shared loads an FMA, dL/dA and a channels-last adjacency read one
// channel at a time in 4-byte pieces (a 32-byte sector fetched for 4
// bytes), one block an SM for the row tiles with dA.  What this design
// does about each:
//  * the layout pass reads dL/dA and the adjacency in runs of all C
//    channels (whole sectors), symmetrises gA once, and writes both
//    channel-major in rows on 128-byte lines, so the two kernels after it
//    copy whole rows with 16-byte cp.async;
//  * gmh_score_grad takes each tanh once: a step forms gS of a tile pair
//    and feeds gQ and gK's partial; gK's partials go through an L2-resident
//    scratch and are summed in a fixed order after one cluster barrier
//    (its comment below); register patches of 4 x 4 scores and 2 x 4
//    products fed by 16-byte loads, strides chosen for no bank conflicts;
//    62 KB, three blocks an SM;
//  * the row-tile kernel streams the adjacency's columns (V) and rows (P1)
//    and X through double-buffered 32-row chunks instead of holding them
//    (112 KB with dA: two blocks an SM), V and P1 in one pass on
//    different warps, then dA from X staged whole; the long product V is
//    split over a chunk's rows with 48 outputs a thread; U gives dX's rows
//    (d_R o U = Z W^T), so that product goes; the rows' degree sums ride
//    along the P1 pass.
// Every sum across blocks runs in a fixed order: results repeat bit for
// bit.  Measured on the same card in one call, in turns with the first
// design (scripts/grad_stage_times.py --parent): C = 8 the whole call 807
// us (1875), gmh_score_grad 183 (747), the row-tile kernel 349 (920), the
// layout pass 63; C = 2 (F_in 5, no dX or dA) 208 (379), 54 (205), 53
// (95), 13.  Still 6.8x, 7.4x and 1.6x their bounds: the stage script
// finds ~54 us of gmh_score_grad and ~151 us of the row-tile kernel in
// loads, barriers and small loops (PERF.md).

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

// The two halves of a cluster barrier (PTX barrier.cluster): every thread
// of every block of the cluster arrives, releasing its shared-memory writes,
// and later waits, acquiring the others'; each arrive is followed by one
// wait before the next arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Row stride (floats) of the layout pass's outputs and of dA's
// channel-major scratch: rows on 128-byte lines, so a tile's row is whole
// lines.
__host__ __device__ constexpr int map_row(int N) { return (N + 31) & ~31; }

// ---------------------------------------------------- the layout pass

// A thread takes one entry (n, m) of one graph, all C channels: it reads
// gA[n, m, :] and gA[m, n, :] (in a channels-last dL/dA, each C floats in a
// run, whole 32-byte sectors at C = 8; 16-byte loads where the run allows)
// and writes, channel-major with rows of map_row(N) floats (the pad zero),
//   gm[b, c, n, m] = (gA[n, m, c] + gA[m, n, c]) / 2
// (so gm[n, m] and gm[m, n] are the same bits), and where ac is not null
// ac[b, c, n, m] = A[b, c, n, m], the adjacency copied channel-major (a
// later layer's channels-last view).  Lanes run along m, so each channel's
// stores are whole 128-byte lines; a block is 8 rows n x 32 columns m.
// No shared memory: every byte is read once and written once, except
// gA, read in both orientations (the second read mostly from L2).
constexpr int kLayoutRows = kThreads / 32;

// Whether C floats at p, q (and r) in steps of sc are dense, 16-byte
// aligned runs that float4 loads can take.
__device__ __forceinline__ bool float4_runs(long long sc, int C, const float* p,
                                            const float* q = nullptr) {
  return sc == 1 && (C & 3) == 0 &&
         ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q)) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads)
gmh_bwd_layout_kernel(const float* __restrict__ ga, const float* __restrict__ adj,
                      float* __restrict__ gm, float* __restrict__ ac, int C, int N,
                      long long gs_b, long long gs_n, long long gs_m, long long gs_c,
                      long long as_b, long long as_c, long long as_n, long long as_m) {
  const int ldm = map_row(N), b = blockIdx.z;
  const int n = blockIdx.y * kLayoutRows + (threadIdx.x >> 5);
  const int m = blockIdx.x * 32 + (threadIdx.x & 31);
  if (n >= N || m >= ldm) return;
  const size_t plane = static_cast<size_t>(N) * ldm;
  float* g = gm + static_cast<size_t>(b) * C * plane + static_cast<size_t>(n) * ldm + m;
  float* a = ac ? ac + static_cast<size_t>(b) * C * plane + static_cast<size_t>(n) * ldm + m
                : nullptr;
  const bool pad = m >= N, zero = pad || ablated(kLoads);
  const float* p = ga + b * gs_b + n * gs_n + m * gs_m;  // gA[n, m, :]
  const float* q = ga + b * gs_b + m * gs_n + n * gs_m;  // gA[m, n, :]
  if (!zero && float4_runs(gs_c, C, p, q)) {
    for (int c = 0; c < C; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      const float4 y = *reinterpret_cast<const float4*>(q + c);
      g[c * plane] = 0.5f * (x.x + y.x);
      g[(c + 1) * plane] = 0.5f * (x.y + y.y);
      g[(c + 2) * plane] = 0.5f * (x.z + y.z);
      g[(c + 3) * plane] = 0.5f * (x.w + y.w);
    }
  } else {
    for (int c = 0; c < C; ++c) g[c * plane] = zero ? 0.f : 0.5f * (p[c * gs_c] + q[c * gs_c]);
  }
  if (!a) return;
  const float* s = adj + b * as_b + n * as_n + m * as_m;  // A[:, n, m]
  if (!zero && float4_runs(as_c, C, s)) {
    for (int c = 0; c < C; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(s + c);
      a[c * plane] = x.x;
      a[(c + 1) * plane] = x.y;
      a[(c + 2) * plane] = x.z;
      a[(c + 3) * plane] = x.w;
    }
  } else {
    for (int c = 0; c < C; ++c) a[c * plane] = zero ? 0.f : s[c * as_c];
  }
}

// ---------------------------------------------------- gmh_score_grad

// A cluster of nt = cdiv(N, kTile) blocks takes one (graph, channel); block
// I (its rank) owns the rows of tile I.  In step J = 0 .. nt - 1 it takes
// the tile pair (I, J) and forms gS_h(I, J) once, each tanh once a head
// and entry:
//   gS_h[n, m] = s gm[n, m] (1 - tanh(s Q_h[n] . K_h[m])^2) / H
// which feeds both gQ[I] += gS K[J] (kept in registers over the steps: its
// sum over J runs in step order) and the partial P(I, J) = gS^T Q[I] of
// gK[J], written to part_k (B, C, nt, N, attn) in device memory (it stays
// in L2).  After its last step a block passes one cluster barrier (every
// partial of the graph and channel written) and sums gK[I] = sum_J' P(J',
// I) over J' = 0 .. nt - 1 in that order: no float atomics, and no block
// waits on another before its last step.
//
// Work of a step, 256 threads: scores a thread a head's 4 x 4 patch (rows
// pr + 8 i, columns pc + 8 j; a warp 8 pr x 4 pc), 16-byte loads of four
// d, gS written both ways; the products threads 0-127 gQ, 128-255 P, each
// 2 rows x 4 columns (a quad of one head), both reading gS 16 bytes at a
// time along their sum (gS for gQ, gS^T for P).  Strides (floats): gm and
// gS rows 36 (4 mod 32), gS planes 16 mod 32, gS^T rows 40 (8 mod 32) and
// planes 4 mod 32, so a warp's scalar stores of a patch position, and its
// reads of gm, fall in 32 distinct banks, and the 16 distinct 16-byte rows
// a products warp reads at one k (4 rows x 4 heads) in exactly two
// wavefronts; Q and K rows are ld4.
constexpr int kSgLd = 36;                     // gm tile and gS rows
constexpr int kSgPlane = kTile * kSgLd + 16;  // a head's gS
constexpr int kSgLdT = 40;                    // gS^T rows
constexpr int kSgPlaneT = kTile * kSgLdT + 4; // a head's gS^T
constexpr int kMaxTiles = 16;                 // the largest (non-portable) cluster

struct ScoreGradLayout {
  int ldq, q, k, g, s, st, total;
  __host__ __device__ ScoreGradLayout(int A, int H) {
    ldq = ld4(A);
    q = 0;                           // Q rows of tile I
    k = q + kTile * ldq;             // K rows of tile J, two buffers
    g = k + 2 * kTile * ldq;         // gm[I, J], two buffers
    s = g + 2 * kTile * kSgLd;       // gS, H planes
    st = s + round4(H * kSgPlane);   // gS^T, H planes
    total = st + round4(H * kSgPlaneT);
  }
};

// Whether the design takes attn A in H heads: quads of four columns in one
// head (ds % 4 == 0) and a gQ patch a thread of threads 0-127 (A <= 32).
__host__ __device__ constexpr bool score_grad_takes(int A, int H) {
  return H > 0 && A % H == 0 && (A / H) % 4 == 0 && A <= 32;
}

__global__ void __launch_bounds__(kThreads, 3)
gmh_score_grad_kernel(const float* __restrict__ qk, const float* __restrict__ gm,
                      float* __restrict__ gqk, float* __restrict__ part_k, int C, int N, int A,
                      int H, int ds, float score_div) {
  extern __shared__ __align__(16) float smem[];
  const ScoreGradLayout L(A, H);
  cg::cluster_group cluster = cg::this_cluster();
  const int nt = cdiv(N, kTile), I = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int I0 = I * kTile, nI = min(kTile, N - I0);
  const int A2 = 2 * A, nq = A / 4, ldq = L.ldq, ldm = map_row(N);
  const size_t bc = static_cast<size_t>(b) * C + c;
  const float* qkb = qk + bc * N * A2;
  const float* gmb = gm + bc * N * ldm;
  float* pk = part_k + bc * nt * N * A;  // P(I', J) at pk + (I' N + J0 + m) A
  float* sQ = smem + L.q;
  float* sS = smem + L.s;
  float* sST = smem + L.st;
  const float s = 1.0f / score_div, gscale = s / static_cast<float>(H);

  // rows past a ragged tile's end are zero (their gS is zero too), so no
  // product meets stale values
  auto zero_rows = [&](float* dst, int from, int cols) {
    for (int i = tid; i < (kTile - from) * cols; i += blockDim.x)
      dst[(from + i / cols) * ldq + i % cols] = 0.f;
  };
  auto load = [&](int J, int buf) {
    const int J0 = J * kTile, nJ = min(kTile, N - J0);
    float* sK = smem + L.k + buf * kTile * ldq;
    stage(sK, ldq, qkb + static_cast<size_t>(J0) * A2 + A, A2, 1, nJ, A);
    zero_rows(sK, nJ, A);
    stage(smem + L.g + buf * kTile * kSgLd, kSgLd, gmb + static_cast<size_t>(I0) * ldm + J0,
          ldm, 1, nI, nJ);
  };

  stage(sQ, ldq, qkb + static_cast<size_t>(I0) * A2, A2, 1, nI, A);
  zero_rows(sQ, nI, A);
  load(0, 0);
  gmh::cp_async_commit();
  const int u = tid & 127, r = u / nq, c0 = 4 * (u - r * nq), h = c0 / ds;
  const bool prod = u < 16 * nq && !ablated(kGradQK);
  float gq[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int J = 0; J < nt; ++J) {
    const int buf = J & 1, J0 = J * kTile, nJ = min(kTile, N - J0);
    const float* sK = smem + L.k + buf * kTile * ldq;
    const float* sG = smem + L.g + buf * kTile * kSgLd;
    gmh::cp_async_wait<0>();
    __syncthreads();  // step J's tiles landed; step J - 1's products are done
    if (J + 1 < nt) {
      load(J + 1, buf ^ 1);
      gmh::cp_async_commit();
    }

    // gS of the pair, and gS^T: a thread a head's 4 x 4 patch
    for (int p = tid; p < H * 64; p += blockDim.x) {
      const int hh = p >> 6, pr = p & 7, pc = (p >> 3) & 7;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (!ablated(kScores))
        for (int d = hh * ds; d < (hh + 1) * ds; d += 4) {
          float4 qa[4], kb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qa[i] = *reinterpret_cast<const float4*>(sQ + (pr + 8 * i) * ldq + d);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kb[j] = *reinterpret_cast<const float4*>(sK + (pc + 8 * j) * ldq + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(qa[i].x, kb[j].x, acc[i][j]);
              acc[i][j] = fmaf(qa[i].y, kb[j].y, acc[i][j]);
              acc[i][j] = fmaf(qa[i].z, kb[j].z, acc[i][j]);
              acc[i][j] = fmaf(qa[i].w, kb[j].w, acc[i][j]);
            }
        }
      float* out = sS + hh * kSgPlane;
      float* outT = sST + hh * kSgPlaneT;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = pr + 8 * i, m = pc + 8 * j;
          float v = 0.f;
          if (n < nI && m < nJ && !ablated(kScores)) {
            const float th = tanhf(acc[i][j] * s);
            v = gscale * sG[n * kSgLd + m] * (1.0f - th * th);
          }
          out[n * kSgLd + m] = v;
          outT[m * kSgLdT + n] = v;
        }
    }
    __syncthreads();  // gS complete

    // gQ[I] += gS K[J] (threads 0-127); P(I, J) = gS^T Q[I] into part_k
    // (threads 128-255): rows r and r + 16, the quad c0 of head h
    if (prod) {
      const bool q_side = tid < 128;
      const float* g0 = q_side ? sS + h * kSgPlane + r * kSgLd : sST + h * kSgPlaneT + r * kSgLdT;
      const float* g1 = g0 + 16 * (q_side ? kSgLd : kSgLdT);
      const float* rhs = (q_side ? sK : sQ) + c0;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k = 0; k < kTile; k += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(g0 + k);
        const float4 a1 = *reinterpret_cast<const float4*>(g1 + k);
        const float av0[4] = {a0.x, a0.y, a0.z, a0.w}, av1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 bv = *reinterpret_cast<const float4*>(rhs + (k + e) * ldq);
          acc[0][0] = fmaf(av0[e], bv.x, acc[0][0]);
          acc[0][1] = fmaf(av0[e], bv.y, acc[0][1]);
          acc[0][2] = fmaf(av0[e], bv.z, acc[0][2]);
          acc[0][3] = fmaf(av0[e], bv.w, acc[0][3]);
          acc[1][0] = fmaf(av1[e], bv.x, acc[1][0]);
          acc[1][1] = fmaf(av1[e], bv.y, acc[1][1]);
          acc[1][2] = fmaf(av1[e], bv.z, acc[1][2]);
          acc[1][3] = fmaf(av1[e], bv.w, acc[1][3]);
        }
      }
      if (q_side) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) gq[i][e] += acc[i][e];
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (r + 16 * i < nJ)
            *reinterpret_cast<float4*>(pk + (static_cast<size_t>(I) * N + J0 + r + 16 * i) * A +
                                       c0) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                         acc[i][3]);
      }
    } else if (tid >= 128 && u < 16 * nq) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r + 16 * i < nJ)
          *reinterpret_cast<float4*>(pk + (static_cast<size_t>(I) * N + J0 + r + 16 * i) * A +
                                     c0) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // every partial of this graph and channel written: gK[I] = sum over J'
  // of P(J', I), in the order J' = 0 .. nt - 1, read from L2
  float gk[4] = {0.f, 0.f, 0.f, 0.f};
  if (!ablated(kReduce)) {
    __threadfence();
    cluster_arrive();
    cluster_wait();
    if (tid < kTile * nq && tid / nq < nI) {
      const float* src = pk + (static_cast<size_t>(I0) + tid / nq) * A + 4 * (tid % nq);
      for (int j0 = 0; j0 < nt; j0 += 4) {
        float4 v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + e < nt)
            v[e] = __ldcg(reinterpret_cast<const float4*>(src + static_cast<size_t>(j0 + e) * N * A));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + e < nt) {
            gk[0] += v[e].x;
            gk[1] += v[e].y;
            gk[2] += v[e].z;
            gk[3] += v[e].w;
          }
      }
    }
  }

  float* dst = gqk + bc * N * A2 + static_cast<size_t>(I0) * A2;
  if (tid < 16 * nq) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r + 16 * i < nI)
        *reinterpret_cast<float4*>(dst + (r + 16 * i) * A2 + c0) =
            make_float4(gq[i][0], gq[i][1], gq[i][2], gq[i][3]);
  }
  if (tid < kTile * nq && tid / nq < nI)
    *reinterpret_cast<float4*>(dst + (tid / nq) * A2 + A + 4 * (tid % nq)) =
        make_float4(gk[0], gk[1], gk[2], gk[3]);
}

// ------------------------------------------- gmh_attention_bwd_tiled

// A block takes one row tile R = [r0, r0 + nr) of one graph and channel:
// the row-tile scheme of grad_common.cuh over gP = [gQ | gK | gV], with A'
// read from rows of unit column stride (the adjacency itself where its
// rows are, else the layout pass's channel-major copy), in a
// double-buffered pass over chunks of kTile rows (and columns) and a pass
// over X whole:
//   1. V = A'[:, R]^T (d o gP) (the long product, 2 N P a row: split
//      over a chunk's rows by groups of 64 threads, four without dA and
//      three with it, a thread 4 rows x 3 quads of P in registers, 16-byte
//      loads, the groups' partials added in a fixed order at the end) and,
//      with dA, on the last two warps, from the same chunk index P1 =
//      A'[R, :] (d o X) and the rows' sums of A' in gcn_degrees.cu's order
//      (a lane a column of the chunk), whose slope gives dr = slope (gNX .
//      P1 + X . U);
//   then U = V W^T, this channel's dX rows d_R o U (= Z W^T, into part_x),
//   gNX = gP[R] W^T, Z = d_R o V;
//   2. (dA) dA[n, m] = d_n d_m gNX[n] . X[m] + dr[n], X of the graph staged
//      whole (52 KB at grid's widths) over the chunks' buffers, written
//      through dadj's strides (channels-last, the C blocks of a row tile,
//      which run together, fill each sector in L2);
// then the block's dW = X[R]^T Z and db = sum_R gP[R], summed over the
// channel's blocks (clusters of kCluster (graph, row tile) blocks laid
// along y, then tickets), and dX over channels by the last channel of each
// (graph, row tile).  Channels run along x, so the C blocks of one row tile
// run together.  112 KB with dA: two blocks an SM.
struct RowTileLayout {
  int P, T, ldw, ldx, ldp, lda, chunk;
  int w, d, xr, gpr, v, u, gnx, p1, sl, dr, st, total;
  __host__ __device__ RowTileLayout(int N, int Fi, int A, int O, bool need_x, bool need_adj) {
    P = 2 * A + O;
    T = Fi * P + P;
    ldw = ld4(P);
    ldx = ld4(Fi);
    ldp = ld4(P);
    lda = ld4(kTile);  // A' columns R of a chunk's rows, and its rows R
    // a chunk's A' columns and gP rows, and with dA its A' rows and X rows
    chunk = kTile * (lda + ldp + (need_adj ? lda + ldx : 0));
    w = 0;
    d = w + Fi * ldw;
    xr = d + round4(N);
    gpr = xr + kTile * ldx;
    v = gpr + kTile * ldp;
    u = v + kTile * ldp;
    gnx = u + (need_x || need_adj ? kTile * ldx : 0);
    p1 = gnx + (need_adj ? kTile * ldx : 0);
    sl = p1 + (need_adj ? kTile * ldx : 0);
    dr = sl + (need_adj ? kTile : 0);
    st = dr + (need_adj ? kTile : 0);
    // the chunks; then X whole (the dA pass); then the dW partial
    total = st + imax(imax(2 * chunk, round4(T)), need_adj ? N * ldx : 0);
  }
};

// Whether the design takes P = 2 attn + F_out: quads of P, at most 24 (3 a
// thread of a V pass group).
__host__ __device__ constexpr bool row_tile_takes(int A, int O) {
  return (2 * A + O) % 4 == 0 && 2 * A + O <= 96;
}

__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads, 2)
gmh_attention_bwd_tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ adj, const float* __restrict__ deg,
    const float* __restrict__ wq, const float* __restrict__ wk, const float* __restrict__ wv,
    const float* __restrict__ gqk, const float* __restrict__ gv, float* __restrict__ dx,
    float* __restrict__ dadj, float* __restrict__ part_x, float* __restrict__ part_w,
    float* __restrict__ out_w, int* __restrict__ tickets, int B, int C, int N, int Fi, int A,
    int O, long long a_b, long long a_c, long long a_n, long long ds_b, long long ds_c,
    long long ds_n, long long ds_m, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const bool need_x = dx != nullptr, need_adj = dadj != nullptr;
  const RowTileLayout L(N, Fi, A, O, need_x, need_adj);
  const int P = L.P, A2 = 2 * A, nq = P / 4;
  float* sW = smem + L.w;
  float* sD = smem + L.d;
  float* sXR = smem + L.xr;
  float* sGPR = smem + L.gpr;
  float* sV = smem + L.v;
  float* sU = smem + L.u;
  float* sGNX = smem + L.gnx;
  float* sP1 = smem + L.p1;
  float* sSl = smem + L.sl;
  float* sDr = smem + L.dr;
  float* sSt = smem + L.st;
  float* sPart = smem + L.st;  // over the chunks, once the passes are done
  const int nt = cdiv(N, kTile);
  const int c = blockIdx.x, bt = blockIdx.y;
  const int b = bt / nt, r0 = (bt % nt) * kTile, nr = min(kTile, N - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;

  if (b < B) {  // else a padding block of the last cluster
    const float* w[3] = {wq + static_cast<size_t>(c) * Fi * A,
                         wk + static_cast<size_t>(c) * Fi * A,
                         wv + static_cast<size_t>(c) * Fi * O};
    for (int m = 0; m < 3; ++m) {
      const int width = m < 2 ? A : O;
      stage(sW + m * A, L.ldw, w[m], width, 1, Fi, width);
    }
    const float* xb = x + static_cast<size_t>(b) * N * Fi;
    stage(sD, N, deg + (static_cast<size_t>(b) * C + c) * N, N, 1, 1, N);
    stage(sXR, L.ldx, xb + static_cast<size_t>(r0) * Fi, Fi, 1, nr, Fi);
    const float* gqb = gqk + (static_cast<size_t>(b) * C + c) * N * A2;
    const float* gvb = gv + static_cast<size_t>(b) * N * C * O + static_cast<size_t>(c) * O;
    stage(sGPR, L.ldp, gqb + static_cast<size_t>(r0) * A2, A2, 1, nr, A2);
    stage(sGPR + A2, L.ldp, gvb + static_cast<size_t>(r0) * C * O, C * O, 1, nr, O);
    const float* ab = adj + b * a_b + c * a_c;
    gmh::cp_async_commit();

    // 1. V = A'[:, R]^T (d o gP) by vg groups of 64 threads (all four
    // without dA), with dA P1 = A'[R, :] (d o X) and the rows' sums of A' by
    // threads 192-255, from the same chunk index (m = n).  V: group gi
    // takes rows [js gi, js gi + js) of each chunk, a thread rows 4 rq..
    // and quads cg + 8 i of P.  P1: a thread rows pq + 8 i and the quad f0
    // of f; the row sums a warp every other row, a lane the columns of
    // gcn_degrees.cu's lane (m = lane mod 32), in its order.
    const int vg = need_adj ? 3 : 4, js = cdiv(kTile, vg);
    const bool v_side = tid < 64 * vg, p1_side = need_adj && !v_side && !ablated(kRecompute);
    const int gi = tid >> 6, rq = (tid & 63) >> 3, cg = tid & 7;
    const int pq = (tid & 63) >> 3, f0 = 4 * (tid & 7), sw = warp & 1;
    const bool xvec = (Fi & 3) == 0;
    float vacc[4][3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) vacc[i][k][e] = 0.f;
    float pacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pacc[i][e] = 0.f;
    float rs[kTile / 2];
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) rs[i] = 0.f;
    chunk_loop(
        N,
        [&](int k, int buf) {
          const int n0 = k * kTile, mc = min(kTile, N - n0);
          float* s = sSt + buf * L.chunk;
          float* g = s + kTile * L.lda;
          stage(s, L.lda, ab + n0 * a_n + r0, a_n, 1, mc, nr);
          stage(g, L.ldp, gqb + static_cast<size_t>(n0) * A2, A2, 1, mc, A2);
          stage(g + A2, L.ldp, gvb + static_cast<size_t>(n0) * C * O, C * O, 1, mc, O);
          if (need_adj && !ablated(kRecompute)) {
            float* ar = g + kTile * L.ldp;
            stage(ar, L.lda, ab + r0 * a_n + n0, a_n, 1, nr, mc);
            stage(ar + kTile * L.lda, L.ldx, xb + static_cast<size_t>(n0) * Fi, Fi, 1, mc, Fi);
          }
        },
        [&](int k, int buf) {
          const int n0 = k * kTile, mc = min(kTile, N - n0), off = n0 - r0;
          float* s = sSt + buf * L.chunk;
          float* ar = s + kTile * (L.lda + L.ldp);
          if (add_loop && off >= 0 && off < nr) {  // the diagonal of A' in this chunk
            if (tid < min(mc, nr - off)) {
              s[tid * L.lda + off + tid] = loop;
              if (need_adj) ar[(off + tid) * L.lda + tid] = loop;
            }
            __syncthreads();
          }
          if (v_side) {
            const float* gc = s + kTile * L.lda;
            const int j1 = ablated(kGradV) ? 0 : min(js * gi + js, mc);
            for (int j = js * gi; j < j1; ++j) {
              const float4 a = *reinterpret_cast<const float4*>(s + j * L.lda + 4 * rq);
              const float dn = sD[n0 + j];
              const float av[4] = {a.x * dn, a.y * dn, a.z * dn, a.w * dn};
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                if (cg + 8 * q >= nq) break;
                const float4 g =
                    *reinterpret_cast<const float4*>(gc + j * L.ldp + 4 * (cg + 8 * q));
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  vacc[i][q][0] = fmaf(av[i], g.x, vacc[i][q][0]);
                  vacc[i][q][1] = fmaf(av[i], g.y, vacc[i][q][1]);
                  vacc[i][q][2] = fmaf(av[i], g.z, vacc[i][q][2]);
                  vacc[i][q][3] = fmaf(av[i], g.w, vacc[i][q][3]);
                }
              }
            }
          } else if (p1_side) {
            const int col = lane - (n0 & 31);  // this lane's column of the chunk
            if (col >= 0 && col < mc)
#pragma unroll
              for (int i = 0; i < kTile / 2; ++i)
                if (sw + 2 * i < nr) rs[i] += ar[(sw + 2 * i) * L.lda + col];
            const float* xc = ar + kTile * L.lda;
            const int m1 = ablated(kGradAdj) || f0 >= Fi ? 0 : mc;
            for (int j = 0; j < m1; ++j) {
              const float dm = sD[n0 + j];
              float xv[4];
              if (xvec) {
                const float4 t = *reinterpret_cast<const float4*>(xc + j * L.ldx + f0);
                xv[0] = t.x * dm, xv[1] = t.y * dm, xv[2] = t.z * dm, xv[3] = t.w * dm;
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  xv[e] = f0 + e < Fi ? xc[j * L.ldx + f0 + e] * dm : 0.f;
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float a = ar[(pq + 8 * i) * L.lda + j];
#pragma unroll
                for (int e = 0; e < 4; ++e) pacc[i][e] = fmaf(a, xv[e], pacc[i][e]);
              }
            }
          }
        });
    if (p1_side) {
      // P1's rows, and the slope of the rows' sums
      if (f0 < Fi)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (f0 + e < Fi) sP1[(pq + 8 * i) * L.ldx + f0 + e] = pacc[i][e];
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {
        float v = rs[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0 && sw + 2 * i < nr) sSl[sw + 2 * i] = degree_slope(v);
      }
    }
    // the groups' partials into V, in group order
    for (int g = 0; g < vg; ++g) {
      if (gi == g)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (cg + 8 * q >= nq) break;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float4* o = reinterpret_cast<float4*>(sV + (4 * rq + i) * L.ldp + 4 * (cg + 8 * q));
            const float4 prev = g ? *o : make_float4(0.f, 0.f, 0.f, 0.f);
            *o = make_float4(prev.x + vacc[i][q][0], prev.y + vacc[i][q][1],
                             prev.z + vacc[i][q][2], prev.w + vacc[i][q][3]);
          }
        }
      __syncthreads();
    }

    // U = V W^T (dX and dA); gNX = gP[R] W^T (dA)
    const int per = patches<2, 2>(nr, Fi);
    const int n_u = need_x || need_adj ? per : 0, n_g = need_adj ? per : 0;
    for (int i = tid; i < n_u + n_g; i += blockDim.x) {
      if (i < n_u)
        patch_nt<2, 2>(i, sV, L.ldp, sW, L.ldw, nr, Fi, 0, ablated(kGradNX) ? 0 : P,
                       [&](int r, int f, float v) { sU[r * L.ldx + f] = v; });
      else
        patch_nt<2, 2>(i - n_u, sGPR, L.ldp, sW, L.ldw, nr, Fi, 0, ablated(kGradNX) ? 0 : P,
                       [&](int r, int f, float v) { sGNX[r * L.ldx + f] = v; });
    }
    __syncthreads();
    // Z = d_R o V in place; this channel's dX rows d_R o U (= Z W^T)
    for (int i = tid; i < nr * P; i += blockDim.x) {
      const int r = i / P, q = i - r * P;
      sV[r * L.ldp + q] *= sD[r0 + r];
    }
    float* px = need_x ? part_x + ((static_cast<size_t>(b) * C + c) * N + r0) * Fi : nullptr;
    if (need_x)
      for (int i = tid; i < nr * Fi; i += blockDim.x) {
        const int r = i / Fi, f = i - r * Fi;
        px[i] = ablated(kGradX) ? 0.f : sD[r0 + r] * sU[r * L.ldx + f];
      }

    if (need_adj) {
      // dr = slope (gNX . P1 + X . U) of each of the tile's rows, a warp a row
      for (int r = warp; r < nr; r += nwarps) {
        float v = 0.f;
        for (int f = lane; f < Fi; f += 32)
          v = fmaf(sGNX[r * L.ldx + f], sP1[r * L.ldx + f],
                   fmaf(sXR[r * L.ldx + f], sU[r * L.ldx + f], v));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) sDr[r] = sSl[r] * v;
      }
      // (chunk_loop's first barrier orders dr before its reads)

      // 2. dA[n, m] = d_n d_m gNX[n] . X[m] + dr[n] of the tile's rows,
      // X of the graph staged whole over the chunks' buffers (free since
      // the first pass's last barrier), one barrier
      float* out = dadj + b * ds_b + c * ds_c + r0 * ds_n;
      if (!ablated(kGradY)) {
        stage(sSt, L.ldx, xb, Fi, 1, N, Fi);
        gmh::cp_async_commit();
        gmh::cp_async_wait<0>();
        __syncthreads();  // X landed; dr written
        for (int p = tid; p < patches<2, 2>(nr, N); p += blockDim.x)
          patch_nt<2, 2>(p, sGNX, L.ldx, sSt, L.ldx, nr, N, 0, ablated(kGradAdj) ? 0 : Fi,
                         [&](int r, int m, float v) {
                           const int n = r0 + r;
                           out[r * ds_n + m * ds_m] =
                               (add_loop && n == m) ? 0.f : fmaf(v * sD[n], sD[m], sDr[r]);
                         });
      }
      __syncthreads();  // X's buffers free for the dW partial
    } else {
      __syncthreads();  // Z complete before dW reads it
    }

    // the block's dW = X[R]^T Z (dWq | dWk | dWv, each Fi x width) and db
    // = sum_R gP[R], into its partial over the chunks
    auto dw = [&](int f, int q, float v) {
      const int e = q < A ? f * A + q
                          : (q < A2 ? Fi * A + f * A + q - A : 2 * Fi * A + f * O + q - A2);
      sPart[e] = v;
    };
    const int kw = ablated(kGradW) ? 0 : nr;
    const int n_dw = patches4<4>(Fi, P);
    for (int i = tid; i < n_dw + P; i += blockDim.x) {
      if (i < n_dw) {
        patch_tn4<4>(i, sXR, L.ldx, sV, L.ldp, Fi, P, kw, dw);
      } else {
        const int q = i - n_dw;
        float acc = 0.f;
        for (int r = 0; r < kw; ++r) acc += sGPR[r * L.ldp + q];
        sPart[Fi * P + q] = acc;
      }
    }

    // dx[b, R] = sum_c part_x[b, c, R], by the last of the C channels'
    // blocks of this row tile to finish
    if (need_x && !ablated(kReduce) && last_arrival(tickets + C * kCluster + bt, C)) {
      const float* pb = part_x + (static_cast<size_t>(b) * C * N + r0) * Fi;
      float* xo = dx + (static_cast<size_t>(b) * N + r0) * Fi;
      for (int i = tid; i < nr * Fi; i += blockDim.x)
        xo[i] = ordered_sum_l2(pb + i, static_cast<long long>(N) * Fi, C);
    }
  } else {
    zero_fill(sPart, L.T);
  }

  // dW and db of channel c over the batch, as the one-block kernel takes
  // them (clusters along y)
  if (!ablated(kReduce)) {
    const int fa = Fi * A, fo = Fi * O, wsz = 2 * fa + fo;
    batch_sum(
        sPart, L.T, gridDim.y / kCluster, part_w + static_cast<size_t>(c) * L.T,
        static_cast<long long>(C) * L.T, tickets + c * kCluster,
        [&](int e, float v) {
          int start, width;
          if (e < wsz) {
            start = e < fa ? 0 : (e < 2 * fa ? fa : 2 * fa);
            width = e < 2 * fa ? fa : fo;
          } else {
            start = e < wsz + A ? wsz : (e < wsz + 2 * A ? wsz + A : wsz + 2 * A);
            width = e < wsz + 2 * A ? A : O;
          }
          out_w[static_cast<size_t>(C) * start + c * width + e - start] = v;
        },
        static_cast<int>(blockIdx.y) / kCluster);
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

// Above N = 64: shared bytes of a block of gmh_score_grad (0 where its
// design does not take attn A in H heads) and of the row-tile kernel (0
// where it does not take P = 2 A + O).
extern "C" int gmh_score_grad_smem(int A, int H) {
  return score_grad_takes(A, H) ? static_cast<int>(sizeof(float)) * ScoreGradLayout(A, H).total
                                : 0;
}

extern "C" int gmh_attention_bwd_tiled_smem(int N, int Fi, int A, int O, int need_x,
                                            int need_adj) {
  return row_tile_takes(A, O) ? static_cast<int>(sizeof(float)) *
                                    RowTileLayout(N, Fi, A, O, need_x != 0, need_adj != 0).total
                              : 0;
}

// ga = dL/dA (B, N, N, C) through strides gs_* (b, n, m, c); adj (B, C, N,
// N) through strides as_* (b, c, n, m).  Writes gm (B, C, N, map_row(N))
// contiguous and, where ac is not null, the adjacency copied into ac, the
// same shape.  One launch on `stream`; returns its cudaError_t.
extern "C" int gmh_bwd_layout_run(const float* ga, const float* adj, float* gm, float* ac, int B,
                                  int C, int N, long long gs_b, long long gs_n, long long gs_m,
                                  long long gs_c, long long as_b, long long as_c,
                                  long long as_n, long long as_m, void* stream) {
  if (B > 65535 || cdiv(N, kLayoutRows) > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(map_row(N) / 32, cdiv(N, kLayoutRows), B);
  gmh_bwd_layout_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ga, adj, gm, ac, C, N, gs_b, gs_n, gs_m, gs_c, as_b, as_c, as_n, as_m);
  return (int)cudaGetLastError();
}

// The launch configuration of gmh_score_grad: a cluster of the cdiv(N,
// kTile) row tiles of each (graph, channel), above the portable 8 where
// the tiles need it; null where the runtime refuses an attribute (its
// error then pending).
static bool score_grad_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int B, int C,
                              int N, int A, int H, cudaStream_t stream) {
  static int allowed = -1;
  if (allowed < 0) {
    if ((allowed = allow_dynamic_smem(gmh_score_grad_kernel)) < 0) return false;
    if (cudaFuncSetAttribute(gmh_score_grad_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess)
      return false;
  }
  const int nt = cdiv(N, kTile);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(nt, C, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = gmh_score_grad_smem(A, H);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nt;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cfg.dynamicSmemBytes) <= allowed;
}

// Clusters of gmh_score_grad that the card can hold at once for graphs of
// N nodes (0: the cluster of cdiv(N, kTile) blocks is not granted), or
// minus the cudaError_t of the query.
extern "C" int gmh_score_grad_max_clusters(int N, int A, int H) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!score_grad_takes(A, H) || cdiv(N, kTile) > kMaxTiles) return 0;
  if (!score_grad_config(cfg, attr, 1, 1, N, A, H, 0)) return -(int)cudaGetLastError();
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, gmh_score_grad_kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// qk (B, C, N, 2A) contiguous, Q | K of gmh_projection_run; gm (B, C, N,
// map_row(N)) of gmh_bwd_layout_run -> gqk (B, C, N, 2A): gQ | gK; part_k
// (B, C, cdiv(N, kTile), N, A) is scratch.  One launch on `stream` (a
// cluster of cdiv(N, kTile) <= kMaxTiles blocks a graph and channel);
// returns its cudaError_t.
extern "C" int gmh_score_grad_run(const float* qk, const float* gm, float* gqk, float* part_k,
                                  int B, int C, int N, int A, int H, int ds, float score_div,
                                  void* stream) {
  if (!score_grad_takes(A, H) || A / H != ds || cdiv(N, kTile) > kMaxTiles || B > 65535 ||
      C > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!score_grad_config(cfg, attr, B, C, N, A, H, (cudaStream_t)stream)) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, gmh_score_grad_kernel, qk, gm, gqk, part_k, C, N, A, H, ds,
                         score_div);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// x (B, N, F_in) contiguous; a: the adjacency (B, C, N, >= N) in strides
// a_* (b, c, n) with unit column stride (adj itself, or the layout pass's
// ac); deg (B, C, N) of gcn_degrees_run; w* (C, F_in, .) contiguous; gqk
// (B, C, N, 2A) of gmh_score_grad_run; gv = dL/dV (B, N, C F_out)
// contiguous.  Writes dx (or skips it: null), dadj through strides ds_*
// (or skips it), out_w as gmh_attention_bwd_run.  Blocks: C along x,
// `clusters` clusters of kCluster along y (at least B * cdiv(N, kTile), one
// a row tile of a graph); part_x (B, C, N, F_in) (null with dx) and part_w
// (clusters, size of out_w) are scratch; tickets: at least kCluster C + B
// cdiv(N, kTile) ints, zero, left zero.  One launch; returns its
// cudaError_t.
extern "C" int gmh_attention_bwd_tiled_run(
    const float* x, const float* a, const float* deg, const float* wq, const float* wk,
    const float* wv, const float* gqk, const float* gv, float* dx, float* dadj, float* part_x,
    float* part_w, float* out_w, int* tickets, int B, int C, int N, int Fi, int A, int O,
    int clusters, long long a_b, long long a_c, long long a_n, long long ds_b, long long ds_c,
    long long ds_n, long long ds_m, int add_loop, float loop, void* stream) {
  static int allowed = -1;
  if (allowed < 0 && (allowed = allow_dynamic_smem(gmh_attention_bwd_tiled_kernel)) < 0)
    return (int)cudaGetLastError();
  const int smem = gmh_attention_bwd_tiled_smem(N, Fi, A, O, dx != nullptr, dadj != nullptr);
  if (smem <= 0 || smem > allowed || (dx == nullptr) != (part_x == nullptr) ||
      clusters * kCluster < B * cdiv(N, kTile) || clusters * kCluster > 65535 || C > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(C, clusters * kCluster);
  gmh_attention_bwd_tiled_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, a, deg, wq, wk, wv, gqk, gv, dx, dadj, part_x, part_w, out_w, tickets, B, C, N, Fi, A,
      O, a_b, a_c, a_n, ds_b, ds_c, ds_n, ds_m, add_loop, loop);
  return (int)cudaGetLastError();
}
