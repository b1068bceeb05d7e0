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
// (graph, channel) a block holds N <= 64 (the wrapper raises above); the
// batch is padded to a multiple of the cluster size with blocks that
// contribute zeros.

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
