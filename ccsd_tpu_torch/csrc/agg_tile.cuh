// The normalised aggregation tile of the tiled designs (N > 64, grid's
// N = 361), shared by channel_agg.cu (channel_agg_tile_kernel) and
// gmh_attention.cu (gmh_projection_kernel):
//
//   NX[c, n, f] = d_n sum_m A'[c, n, m] d_m X[m, f]
//
// for the kRows rows n of one row tile of one graph, a group of G <= 8
// channels and a pass of up to 32 features f, where A' is the adjacency
// with its diagonal set to `loop` (when add_loop) and d the degrees a
// gcn_degrees launch computed (gcn_common.cuh).  The product runs on the
// tensor cores: mma.sync m16n8k8 in TF32 with the 3xTF32 split (a = a_hi +
// a_lo, x = x_hi + x_lo, summed as a_lo x_hi + a_hi x_lo + a_hi x_hi in f32;
// CUTLASS's OpMultiplyAddFastF32), which keeps f32 accuracy: a single TF32
// pass keeps ~3 digits and is not used.  The bf16 variant of channel_agg
// rounds each norm element (d_n a) d_m and x to bf16, which TF32 holds
// exactly, and takes one pass: the products are exact and summed in f32,
// as round_bf16(norm) @ round_bf16(x) is.
//
// What bounds it on H100: the adjacency, read once (33 MB at B = 8, C = 8,
// N = 361: ~10 us at 3.35 TB/s), and the 3xTF32 products of grid's widest
// layer (1.6 GFLOP of TF32 in mma.sync, which issues an m16n8k8 every ~7
// cycles a sub-partition).  What the design does about it:
//  * a block takes one graph, one tile of kRows = 16 rows (the M of one
//    mma; 23 tiles at N = 361, so 184 blocks at B = 8: a third of the SMs
//    hold one block, the rest two, and those set the time) and G channels;
//    the adjacency arrives in chunks of KC columns through a ring of
//    `stages` cp.async stages, so copies overlap the products: two chunks
//    of 4 k-steps a warp for channel_agg, three of 2 for the projection (its
//    outputs and NX take the room), two blocks an SM;
//  * a channels-last adjacency (channel stride 1, G = 4 or 8) is copied
//    four channels a 16-byte piece into [r][m][g]: at G = C = 8 a block
//    reads each 32-byte sector of its rows once, and its rows are one
//    contiguous run.  Any other strides are copied a channel at a time into
//    [g][r][m]: rows with unit column stride as 16-byte runs from the row's
//    own 16-byte boundary (grid's rows of 361 floats are not aligned, and
//    4-byte cp.async copies are slow), others a float at a time;
//  * the warps split the channels into subgroups of two and the chunk's
//    k-steps into KS slices; each warp keeps its two channels' sums of up to
//    32 features in registers (4 x 4 mma accumulators a channel: two blocks
//    an SM fit in 128 registers a thread without spills), and the slices'
//    sums meet once, in a fixed order, through shared memory after the last
//    chunk (so repeated calls are bit-identical);
//  * the n-tiles of a pass (1 for F <= 8, else 4) are a template parameter:
//    under a runtime bound every mma.sync was predicated and fenced by a
//    warp sync; the hi part of the split is rounded by an integer add and a
//    mask (cvt.rna.tf32.f32 issues at a fraction of the rate);
//  * d_m and the loop are applied to the adjacency fragment as it leaves
//    shared memory (the chunk goes to the product as it arrives), d_n to the
//    sums; the ragged last chunk and tile are masked in registers.
// Padding: [g][r][m] rows of KC + 4 floats (4 mod 32: no bank conflicts;
// two-way where a row starts off its 16-byte boundary), [r][m][g] rows of
// KC G + 4 (G = 8) or + 16 (G = 4) floats (the 8-byte loads of a warp's
// two channels: two-way conflicts, the least 16-byte rows allow), X rows of
// 8 or 40 floats (8 mod 32).

#pragma once

#include <type_traits>

#include "gcn_common.cuh"

namespace agg {

using gcn::copy_run_async;
using gcn::run_shift;

using gmh::cdiv;
using gmh::ld4;
using gmh::round4;

constexpr int kRows = 16;     // rows of a tile: the M of one mma
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // channels of a block
constexpr int kPassNT = 4;    // n-tiles of eight features a pass: 32 features
constexpr int kCPS = 2;       // channels of a warp

// Stages a build may remove (the stage scripts): the copies of the
// adjacency, X and the degrees (a zero fill in their place), the degrees
// (d = 1, not applied), the product (zero sums).
enum Ablate : unsigned { kNoLoads = 1, kNoDegrees = 2, kNoProduct = 4 };

// The shared-memory geometry of a block of G channels over F features.
// Floats: the ring (`stages` x (adjacency chunk, X chunk)), which the
// slices' partial sums reuse after the last chunk (`region` is the larger),
// then the degrees [m][g] (`deg`).
struct Geometry {
  int stages;   // chunks of the adjacency in the ring
  int steps;    // k-steps of a warp in a chunk
  int G;        // channels of a block
  bool quad;    // four channels a 16-byte copy, [r][m][g]; else [g][r][m]
  int SG, GP;   // channel subgroups of kCPS, their channels (past G: padding)
  int KS, KC;   // k-slices (warps of a subgroup), columns of a chunk
  int NT;       // n-tiles of eight features in a pass: 1 (F <= 8) or kPassNT
  int lda, ldx, ldp;
  int a_stage, stage, region, deg;
  __host__ __device__ Geometry(int N, int F, int G_, bool quad_, int stages_, int steps_)
      : stages(stages_), steps(steps_), G(G_), quad(quad_) {
    SG = G <= 2 ? 1 : G <= 4 ? 2 : 4;
    GP = SG * kCPS;
    KS = kWarps / SG;
    KC = 8 * KS * steps;
    NT = F <= 8 ? 1 : kPassNT;
    lda = quad ? KC * G + (G == 4 ? 16 : 4) : KC + 4;
    ldx = NT == 1 ? 8 : 40;
    ldp = ld4(8 * NT);
    a_stage = quad ? kRows * lda : GP * kRows * lda;
    stage = a_stage + KC * ldx + 8;  // a dense X run's shift and last piece
    const int ring = stages * stage, red = KS * GP * kRows * ldp;
    region = ring > red ? ring : red;
    deg = round4(N * G + GP);  // the padding channels' reads past the last row
  }
};

// Whether a launch may take the [r][m][g] copies: channel stride 1, whole
// groups of four channels dividing C, and every (n, m) entry of four
// channels 16-byte aligned.
__host__ __device__ inline bool takes_quad(const float* adj, int C, int G, long long sb,
                                           long long sc, long long sn, long long sm) {
  return sc == 1 && (G == 4 || G == 8) && C % G == 0 && sm % 4 == 0 && sn % 4 == 0 &&
         sb % 4 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15) == 0;
}

// What a block of the tile reads: the adjacency at (b, c0, r0) in strides
// (sc, sn, sm), X of graph b (N x F, contiguous).
struct Tile {
  const float* adj;
  long long sc, sn, sm;
  const float* x;
  int N, F, r0, nr, nch;
  bool add_loop;
  float loop;
};

// ------------------------------------------------------------------ mma

// v ~ hi + lo, each the TF32 value nearest what it takes (rounded by an
// integer add and a mask: cvt.rna.tf32.f32 issues at a fraction of the
// rate): |v - hi| <= 2^-11 |v|, and lo's own rounding leaves <= 2^-22 |v|.
// Left to the tensor core, lo would be truncated (<= 2^-21 |v|): grid's
// seeded ScoreNetworkA, ill-conditioned in f32, amplified that past its
// bound against float64.
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(__float_as_uint(v));
  lo = round_tf32(__float_as_uint(v - __uint_as_float(hi)));
}

// d += a b: A 16 x 8 (rows g, g + 8; columns t, t + 4 of a thread with
// g = lane / 4, t = lane % 4), B 8 x 8 (rows t, t + 4; column g), D 16 x 8
// (rows g, g + 8; columns 2t, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, the accumulator starting from zero
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// ------------------------------------------------------------- staging

// The degrees of the block's channels, deg (nch x N, the (b, c0) rows of
// gcn_degrees' output) into sD[m * G + g]; not committed.
template <unsigned kAblate>
__device__ __forceinline__ void stage_degrees(float* sD, const float* deg, int N, int nch,
                                              int G) {
  if (kAblate & kNoLoads) {
    gmh::zero_fill(sD, N * G);
    return;
  }
  for (int g = 0; g < nch; ++g)
    for (int m = threadIdx.x; m < N; m += blockDim.x)
      gmh::cp_async4(sD + m * G + g, deg + g * N + m);
}

// The product of one pass, features [f0, f0 + nf), nf <= 32: the slices'
// sums into the region, then out(g, r, f, v) for every channel g < nch,
// row r < nr and feature f < nf of the tile.  sD must hold the degrees
// (staged and committed before, or staged uncommitted: the first chunk's
// group takes them).  Ends with a barrier: the region is free again.
// Copies: a warp a row.  [r][m][g]: 16-byte pieces of four channels.
// [g][r][m]: rows with unit column stride as 16-byte runs (the row stored
// from its own 16-byte boundary, `run_shift` floats in: grid's rows of 361
// floats are not 16-byte aligned), others a float at a time.  X: the
// chunk's rows as one run where a pass takes all F <= 8 features (dense,
// F floats a row), else a row at a time into rows of ldx floats.
template <int kStages, int kNT, bool kQuad, bool kBf16, unsigned kAblate, typename Out>
__device__ __forceinline__ void aggregate(const Geometry& geo, const Tile& t, float* region,
                                          const float* sD, int f0, int nf, Out out) {
  const int G = geo.G, KC = geo.KC, KS = geo.KS, lda = geo.lda, ldx = geo.ldx;
  const int N = t.N, nchunks = cdiv(N, KC);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int sub = warp / KS, ks = warp - sub * KS;
  const int q0 = sub * kCPS;
  constexpr bool kDeg = !(kAblate & kNoDegrees);
  const bool runs = !kQuad && t.sm == 1;
  constexpr bool xdense = kNT == 1;  // F <= 8: one pass of every feature
  const bool xvec = (t.F & 3) == 0 && (nf & 3) == 0 && (f0 & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(t.x) & 15) == 0;

  // chunk k (columns [k KC, k KC + mc)) of the adjacency and of X into
  // stage k % kStages, not committed
  auto stage = [&](int k) {
    float* sA = region + (k % kStages) * geo.stage;
    float* sX = sA + geo.a_stage;
    const int m0 = k * KC, mc = min(KC, N - m0);
    const float* src = t.adj + m0 * t.sm;
    if (kQuad) {  // lane p: column p / gv, piece p % gv of gv = G / 4 (1 or 2)
      const int sh = G >> 3;
      for (int r = warp; r < t.nr; r += kWarps)
        for (int p = lane; p < (mc << sh); p += 32) {
          const int m = p >> sh, q = p & sh;
          gmh::cp_async16(sA + r * lda + m * G + 4 * q, src + r * t.sn + m * t.sm + 4 * q);
        }
    } else {
      for (int g = 0; g < t.nch; ++g)
        for (int r = warp; r < t.nr; r += kWarps) {
          float* dst = sA + (g * kRows + r) * lda;
          const float* row = src + g * t.sc + r * t.sn;
          if (runs)
            copy_run_async(dst, row, mc, lane);
          else
            for (int m = lane; m < mc; m += 32) gmh::cp_async4(dst + m, row + m * t.sm);
        }
    }
    const float* xs = t.x + static_cast<size_t>(m0) * t.F + f0;
    if (xdense) {
      if (warp == 0) copy_run_async(sX, xs, mc * t.F, lane);
    } else {  // eight lanes a row
      for (int m = 4 * warp + (lane >> 3); m < mc; m += 4 * kWarps) {
        if (xvec) {
          for (int f = 4 * (lane & 7); f < nf; f += 32)
            gmh::cp_async16(sX + m * ldx + f, xs + m * t.F + f);
        } else {
          for (int f = lane & 7; f < nf; f += 8)
            gmh::cp_async4(sX + m * ldx + f, xs + m * t.F + f);
        }
      }
    }
  };

  // where the rows of the thread's channels start in a [g][r][m] stage:
  // run_shift of rows gid (bits 4q) and gid + 8 (bits 4q + 2) of channel q
  int shifts = 0;
  if (runs) {
    const int a0 = run_shift(t.adj), sc = static_cast<int>(t.sc & 3);
    const int sn = static_cast<int>(t.sn & 3);
#pragma unroll
    for (int q = 0; q < kCPS; ++q) {
      const int base = a0 + (q0 + q) * sc + gid * sn;
      shifts |= ((base & 3) | (((base + 8 * sn) & 3) << 2)) << (4 * q);
    }
  }

  float acc[kCPS][kNT][4];
#pragma unroll
  for (int q = 0; q < kCPS; ++q)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

  // one k-step: columns kk .. kk + 7 of the chunk at m0 (mc columns); with
  // kEdge the columns past N are masked and the diagonal set to the loop
  auto kstep = [&](const float* sA, const float* sX, int m0, int mc, int kk, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    const int c0 = kk + tig, c1 = c0 + 4;    // the thread's two columns of the step
    const bool in0 = !kEdge || c0 < mc, in1 = !kEdge || c1 < mc;
    const int mg0 = kEdge ? min(m0 + c0, N - 1) : m0 + c0;
    const int mg1 = kEdge ? min(m0 + c1, N - 1) : m0 + c1;
    // B: X rows c0, c1 of the chunk, column gid of each n-tile
    uint32_t bh[kNT][2], bl[kNT][2];
    const int xsh = xdense ? run_shift(t.x + static_cast<size_t>(m0) * t.F) : 0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* x0p = xdense ? sX + xsh + c0 * t.F + gid : sX + c0 * ldx + 8 * j + gid;
      const float* x1p = xdense ? sX + xsh + c1 * t.F + gid : sX + c1 * ldx + 8 * j + gid;
      const float x0 = in0 ? *x0p : 0.f, x1 = in1 ? *x1p : 0.f;
      if (kBf16) {
        bh[j][0] = __float_as_uint(gcn::round_bf16(x0));
        bh[j][1] = __float_as_uint(gcn::round_bf16(x1));
      } else {
        split(x0, bh[j][0], bl[j][0]);
        split(x1, bh[j][1], bl[j][1]);
      }
    }
    // A: rows gid, gid + 8 and columns c0, c1 of each channel, d_m applied
    float a[kCPS][4];
    if (kQuad) {  // the subgroup's two channels, 8-byte loads
      const float* ar = sA + gid * lda + c0 * G + 2 * sub;
      const float2 v00 = *reinterpret_cast<const float2*>(ar);
      const float2 v10 = *reinterpret_cast<const float2*>(ar + 8 * lda);
      const float2 v01 = *reinterpret_cast<const float2*>(ar + 4 * G);
      const float2 v11 = *reinterpret_cast<const float2*>(ar + 8 * lda + 4 * G);
      a[0][0] = v00.x, a[0][1] = v10.x, a[0][2] = v01.x, a[0][3] = v11.x;
      a[1][0] = v00.y, a[1][1] = v10.y, a[1][2] = v01.y, a[1][3] = v11.y;
    } else {
#pragma unroll
      for (int q = 0; q < kCPS; ++q) {
        const float* ar = sA + ((q0 + q) * kRows + gid) * lda + c0;
        const int s0 = (shifts >> (4 * q)) & 3, s1 = (shifts >> (4 * q + 2)) & 3;
        a[q][0] = ar[s0];
        a[q][1] = ar[8 * lda + s1];
        a[q][2] = ar[s0 + 4];
        a[q][3] = ar[8 * lda + s1 + 4];
      }
    }
    if (kEdge && t.add_loop) {
      const int n0 = t.r0 + gid, n1 = n0 + 8;
#pragma unroll
      for (int q = 0; q < kCPS; ++q) {
        if (n0 == m0 + c0) a[q][0] = t.loop;
        if (n1 == m0 + c0) a[q][1] = t.loop;
        if (n0 == m0 + c1) a[q][2] = t.loop;
        if (n1 == m0 + c1) a[q][3] = t.loop;
      }
    }
    if (kDeg) {
      float d0[kCPS], d1[kCPS];
      if (kQuad) {
        const float2 u = *reinterpret_cast<const float2*>(sD + mg0 * G + 2 * sub);
        const float2 v = *reinterpret_cast<const float2*>(sD + mg1 * G + 2 * sub);
        d0[0] = u.x, d0[1] = u.y, d1[0] = v.x, d1[1] = v.y;
      } else {
#pragma unroll
        for (int q = 0; q < kCPS; ++q) {
            d0[q] = sD[mg0 * G + q0 + q];
          d1[q] = sD[mg1 * G + q0 + q];
        }
      }
#pragma unroll
      for (int q = 0; q < kCPS; ++q) {
        if (kBf16) {  // norm = (d_n a) d_m, as the plain version forms it
          const int g = q0 + q;
          const float dn0 = sD[min(t.r0 + gid, N - 1) * G + g];
          const float dn1 = sD[min(t.r0 + gid + 8, N - 1) * G + g];
          a[q][0] = (dn0 * a[q][0]) * d0[q];
          a[q][1] = (dn1 * a[q][1]) * d0[q];
          a[q][2] = (dn0 * a[q][2]) * d1[q];
          a[q][3] = (dn1 * a[q][3]) * d1[q];
        } else {
          a[q][0] *= d0[q];
          a[q][1] *= d0[q];
          a[q][2] *= d1[q];
          a[q][3] *= d1[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCPS; ++q) {
      if (!in0) a[q][0] = a[q][1] = 0.f;
      if (!in1) a[q][2] = a[q][3] = 0.f;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kBf16)
          ah[e] = __float_as_uint(gcn::round_bf16(a[q][e]));
        else
          split(a[q][e], ah[e], al[e]);
      }
      // the n-tiles' products interleaved, so that no mma waits on the one
      // before it: the small products, then the large one
      // the step's products into fresh accumulators, added to the sums in
      // f32: summed inside the tensor core (whose adds truncate), a row's
      // 3 x 46 adds left several times the error of an f32 product, which
      // grid's seeded ScoreNetworkA, ill-conditioned in f32, amplified past
      // its bound against float64
      float t[kNT][4];
      if (kBf16) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma0(t[j], ah, bh[j][0], bh[j][1]);
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma0(t[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(t[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(t[j], ah, bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][j][e] += t[j][e];
    }
  };

  if (kAblate & kNoLoads) gmh::zero_fill(region, kStages * geo.stage);
#pragma unroll 1
  for (int k = 0; k < kStages - 1; ++k) {
    if (!(kAblate & kNoLoads) && k < nchunks) stage(k);
    gmh::cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nchunks; ++k) {
    gmh::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk k landed for all; chunk k - 1's stage is free
    if (!(kAblate & kNoLoads) && k + kStages - 1 < nchunks) stage(k + kStages - 1);
    gmh::cp_async_commit();
    if (kAblate & kNoProduct) continue;

    const float* sA = region + (k % kStages) * geo.stage;
    const float* sX = sA + geo.a_stage;
    const int m0 = k * KC, mc = min(KC, N - m0);
#pragma unroll 1
    for (int kk = 8 * ks; kk < mc; kk += 8 * KS) {
      const bool edge = kk + 8 > mc ||
                        (t.add_loop && m0 + kk < t.r0 + kRows && m0 + kk + 8 > t.r0);
      if (edge)
        kstep(sA, sX, m0, mc, kk, std::true_type{});
      else
        kstep(sA, sX, m0, mc, kk, std::false_type{});
    }
  }
  gmh::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the partial sums take it

  // slice ks's sums of channel g: red[((ks GP + g) kRows + r) ldp + f], GP
  // the subgroups' channels (past G: unused)
  const int ldp = geo.ldp;
  const int GP = geo.GP;
#pragma unroll
  for (int q = 0; q < kCPS; ++q) {
    float* p = region + ((ks * GP + q0 + q) * kRows + gid) * ldp + 2 * tig;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      *reinterpret_cast<float2*>(p + 8 * j) = make_float2(acc[q][j][0], acc[q][j][1]);
      *reinterpret_cast<float2*>(p + 8 * ldp + 8 * j) = make_float2(acc[q][j][2], acc[q][j][3]);
    }
  }
  __syncthreads();
  // the slices' sums, in slice order: a warp a (channel, row), a lane a feature
  for (int gr = warp; gr < t.nch * kRows; gr += kWarps) {
    const int g = gr / kRows, r = gr % kRows;
    if (r >= t.nr || lane >= nf) continue;
    float v = 0.f;
    for (int s = 0; s < KS; ++s) v += region[((s * GP + g) * kRows + r) * ldp + lane];
    if (kDeg && !kBf16) v *= sD[(t.r0 + r) * G + g];
    out(g, r, lane, v);
  }
  __syncthreads();  // the region is free for the next pass
}

}  // namespace agg
