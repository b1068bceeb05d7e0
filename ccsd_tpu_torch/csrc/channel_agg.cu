// Channel-folded GCN aggregation of the fused AttentionLayer, with the
// normalisation of each channel's adjacency formed inside the kernel.
//
// Replaces: agg_pallas, tools/probe_pallas_agg.py:43-51 (body _agg_kernel
// :34-40), and agg_pallas_2d, tools/probe_pallas_agg.py:64-73 (body
// _agg_kernel_2d :54-61), together with the gcn_norm the layer ran before
// them (ccsd_tpu/models/attention.py:244, ccsd_tpu/models/gcn.py:23-35):
//
//   out[b, c, n, f] = sum_m norm[b, c, n, m] x[b, m, f]
//   norm[b, c]      = d_n A'[b, c, n, m] d_m   (gcn_common.cuh, loop 1)
//
// The adjacency comes in any strides: the (B, C, N, N) a first layer gets,
// the channels-last view a later layer gets, or the probes' folded
// (B, C*N, N).  In f32 the kernel never forms norm (d is applied on the
// fly); with bf16 it forms each norm element as (d_n a) d_m, rounds it and
// x to bf16 (nearest, ties to even), and sums their products in f32, as
// round_bf16(gcn_norm(adj)) @ round_bf16(x) does.
//
// What bounds it on H100: at the sampler's widest layer (B = 128, C = 8,
// N = 20, F = 32) one launch reads 1.6 MB of adjacency and 0.33 MB of x and
// writes 2.6 MB, ~1.4 us at 3.35 TB/s, against 27 MFLOP (0.4 us at
// 67 TFLOP/s of f32): bytes bound it, and at these sizes the block's
// serial phases are what it waits on in practice.  Before this kernel the
// layer formed norm with ~11 PyTorch launches, each a pass over the
// (B, C, N, N) tensor in device memory; here nothing between the adjacency
// and the output goes to device memory.
// What the design does about it, for a whole graph (N <= 64): one round of
// cp.async copies stages a block's graph and its x, and the block waits on
// them once; the degree sums take kRowLanes lanes a row; two barriers in
// f32.  Two kernels:
//  * four channels a block (channel_agg_group_kernel) where the adjacency
//    is channels-last, as every layer after the first passes it: each
//    (n, m) entry of four channels is one 16-byte copy, x is read once for
//    the four, and a thread's 16 accumulators (four channels x four F) take
//    16 FMAs per three 16-byte shared loads (256 blocks at B = 128, C = 8);
//  * one (graph, channel) a block otherwise (channel_agg_kernel; 256 blocks
//    at the first layer's C = 2).  A thread owns four consecutive outputs
//    along F of one row: each four m cost a 16-byte load of the A row, one
//    of d and four of x for 16 FMAs.
// Both apply d_m to the A entries as the product reads them and d_n to the
// sums, and store four outputs in one 16-byte store where F % 4 == 0.
// Plain f32 FMAs; no TF32.
//
// Above N = 64 (grid: N = 361, where the adjacency alone is 33 MB at B = 8,
// C = 8) a gcn_degrees launch computes d of every row first, and
// channel_agg_tile_kernel takes the graph in tiles of 16 rows: the
// normalised aggregation tile of agg_tile.cuh on the tensor cores (3xTF32,
// f32-accurate; the bf16 variant in one TF32 pass over bf16 values), a
// block a (row tile, group of up to 8 channels, graph), the outputs of a
// pass stored from the slices' sums.

#include "agg_tile.cuh"

namespace {

using gcn::cdiv;
using gcn::ld4;
using gcn::round4;

// Shared layout (floats): A N x ld4(N) | x N x round4(F) | d round4(N).
__host__ __device__ constexpr int smem_floats(int N, int F) {
  return N * ld4(N) + N * round4(F) + round4(N);
}

// One (graph, channel) a block, all N rows.  T, the type of adj, x and out:
// float, or bf16 (staged as f32, each output rounded once as it is
// stored); kBf16: norm and x rounded to bf16 before the product.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(gcn::kMaxThreads)
channel_agg_kernel(const T* __restrict__ adj, const T* __restrict__ x, T* __restrict__ out,
                   int C, int N, int F, long long sb, long long sc, long long sn,
                   long long sm) {
  extern __shared__ __align__(16) float smem[];
  const int lda = ld4(N), ldx = round4(F);
  float* sA = smem;
  float* sX = sA + N * lda;
  float* sD = sX + N * ldx;

  const int bc = blockIdx.x;  // b * C + c
  const int b = bc / C, c = bc - b * C;

  gcn::stage(sA, lda, adj + b * sb + c * sc, sn, sm, N, N);
  gcn::stage(sX, ldx, x + (size_t)b * N * F, F, 1, N, F);
  gmh::cp_async_commit();
  gcn::zero_pad(sX, ldx, N, F);
  gmh::cp_async_wait<0>();
  __syncthreads();  // every copy has landed: a row's diagonal may be another thread's copy
  gcn::prepare_rows(sA, lda, 0, N, N, true, true, 1.0f, sD);
  const bool scale = !gcn::ablated(gcn::kDegrees);
  if (kBf16) {  // x rounded to bf16 (every element once)
    for (int i = threadIdx.x; i < N * F; i += blockDim.x) {
      const int m = i / F;
      float& v = sX[m * ldx + (i - m * F)];
      v = gcn::round_bf16(v);
    }
  }
  __syncthreads();
  if (kBf16) {  // norm formed element by element, (d_n a) d_m, and rounded
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      const int r = i / N, m = i - r * N;
      float& v = sA[r * lda + m];
      v = gcn::round_bf16(scale ? sD[r] * v * sD[m] : v);
    }
    __syncthreads();
  }

  // f32: out = d_n sum_m (a d_m) x[m]; bf16: out = sum_m norm x[m]
  const int groups = cdiv(F, 4);
  for (int p = threadIdx.x; p < N * groups; p += blockDim.x) {
    const int r = p / groups, c0 = 4 * (p - r * groups);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!gcn::ablated(gcn::kProduct)) {
      v = (!kBf16 && scale) ? gcn::row_times4<true>(sA + r * lda, sD, sX, ldx, c0, N)
                            : gcn::row_times4<false>(sA + r * lda, sD, sX, ldx, c0, N);
    }
    if (!kBf16 && scale) {
      const float dn = sD[r];
      v = make_float4(dn * v.x, dn * v.y, dn * v.z, dn * v.w);
    }
    gcn::store4(out + ((size_t)bc * N + r) * F, c0, F, v);
  }
}

// Four channels a block, for a whole graph whose adjacency is
// channels-last (the view a later layer passes: channel stride 1, the
// other strides multiples of 4).  Each (n, m) entry of four channels is
// one 16-byte copy into a row of four-channel entries, A4[r][m][g] (row
// stride 4 * odd(N) floats: the rows a warp reads at one m fall in
// distinct banks), and a thread owns four outputs along F of one row for
// all four channels: per m one 16-byte load each of A4, d4 and x feeds 16
// FMAs.  x is read once for four channels.
constexpr int kGroup = 4;

__host__ __device__ constexpr int ld_group(int N) { return kGroup * gmh::odd(N); }

// Shared layout (floats): A4 N x ld_group(N) | x N x round4(F) | d4 N x 4.
__host__ __device__ constexpr int smem_floats_group(int N, int F) {
  return N * ld_group(N) + N * round4(F) + kGroup * N;
}

__global__ void __launch_bounds__(gcn::kMaxThreads)
channel_agg_group_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                         float* __restrict__ out, int C, int N, int F, long long sb,
                         long long sn, long long sm) {
  extern __shared__ __align__(16) float smem[];
  const int lda = ld_group(N), ldx = round4(F);
  float* sA = smem;
  float* sX = sA + N * lda;
  float* sD = sX + N * ldx;  // d4[m] = d of channels c0 .. c0 + 3 at row m

  const int groups = C / kGroup;
  const int b = blockIdx.x / groups, c0 = (blockIdx.x - b * groups) * kGroup;
  if (gcn::ablated(gcn::kLoads)) {
    gmh::zero_fill(sA, N * lda);
  } else {
    const float* ab = adj + b * sb + c0;
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      const int r = i / N, m = i - r * N;
      gmh::cp_async16(sA + r * lda + kGroup * m, ab + r * sn + m * sm);
    }
  }
  gcn::stage(sX, ldx, x + (size_t)b * N * F, F, 1, N, F);
  gmh::cp_async_commit();
  gcn::zero_pad(sX, ldx, N, F);
  gmh::cp_async_wait<0>();
  __syncthreads();  // every copy has landed: a row's diagonal may be another thread's copy

  // the diagonal of the four channels, then their sums
  gcn::prepare_rows(reinterpret_cast<float4*>(sA), lda / kGroup, 0, N, N, true, true,
                    make_float4(1.f, 1.f, 1.f, 1.f), reinterpret_cast<float4*>(sD));
  __syncthreads();

  const int fg = cdiv(F, 4);
  for (int p = threadIdx.x; p < N * fg; p += blockDim.x) {
    const int r = p / fg, f0 = 4 * (p - r * fg);
    const float4* row = reinterpret_cast<const float4*>(sA + r * lda);
    const float4* d4 = reinterpret_cast<const float4*>(sD);
    float acc[kGroup][4] = {};
    if (!gcn::ablated(gcn::kProduct)) {
      for (int m = 0; m < N; ++m) {
        const float4 a = row[m], d = d4[m];
        const float4 xv = *reinterpret_cast<const float4*>(sX + m * ldx + f0);
        const float ag[kGroup] = {a.x * d.x, a.y * d.y, a.z * d.z, a.w * d.w};
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          acc[g][0] = fmaf(ag[g], xv.x, acc[g][0]);
          acc[g][1] = fmaf(ag[g], xv.y, acc[g][1]);
          acc[g][2] = fmaf(ag[g], xv.z, acc[g][2]);
          acc[g][3] = fmaf(ag[g], xv.w, acc[g][3]);
        }
      }
    }
    const float4 dn = d4[r];
    const float dg[kGroup] = {dn.x, dn.y, dn.z, dn.w};
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float s = dg[g];
      gcn::store4(out + (((size_t)b * C + c0 + g) * N + r) * F, f0, F,
                  make_float4(s * acc[g][0], s * acc[g][1], s * acc[g][2], s * acc[g][3]));
    }
  }
}

// The four-channel kernel takes a whole graph, f32, with a channels-last
// adjacency whose entries of four channels are 16-byte aligned.
bool takes_group(const float* adj, int C, int bf16, long long sb, long long sc, long long sn,
                 long long sm) {
  return !bf16 && C % kGroup == 0 && sc == 1 && sm % 4 == 0 && sn % 4 == 0 && sb % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(adj) & 15) == 0;
}

// ------------------------------------------------------ tiled (N > 64)
//
// A block per (row tile of agg::kRows rows, group of G channels, graph),
// graphs in reverse order: the gcn_degrees launch before reads them in
// order, so the first blocks find their rows in L2.  Stage ablation as
// gcn_common.cuh's: the loads, the degrees, the product, the store.

constexpr unsigned kTileAblate = ((GCN_ABLATE & gcn::kLoads) ? agg::kNoLoads : 0u) |
                                 ((GCN_ABLATE & gcn::kDegrees) ? agg::kNoDegrees : 0u) |
                                 ((GCN_ABLATE & gcn::kProduct) ? agg::kNoProduct : 0u);

// the ring: two chunks of four k-steps a warp (two blocks an SM at G = 8,
// F = 32; fewer barriers than four chunks of two)
constexpr int kTileStages = 2, kTileSteps = 4;

// Shared floats of a block: the tile's region and degrees.
__host__ __device__ inline int tile_floats(int N, int F, int G, bool quad) {
  const agg::Geometry geo(N, F, G, quad, kTileStages, kTileSteps);
  return geo.region + geo.deg;
}

template <bool kQuad, bool kBf16, int kNT>
__global__ void __launch_bounds__(agg::kThreads, 2)
channel_agg_tile_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                        const float* __restrict__ deg, float* __restrict__ out, int C, int N,
                        int F, int G, long long sb, long long sc, long long sn, long long sm) {
  extern __shared__ __align__(16) float smem[];
  const agg::Geometry geo(N, F, G, kQuad, kTileStages, kTileSteps);
  float* sD = smem + geo.region;
  const int c0 = blockIdx.x * G, r0 = blockIdx.y * agg::kRows;
  const int b = gridDim.z - 1 - blockIdx.z;
  const agg::Tile t{adj + b * sb + c0 * sc + r0 * sn, sc, sn, sm,
                    x + static_cast<size_t>(b) * N * F, N, F, r0,
                    min(agg::kRows, N - r0), min(G, C - c0), true, 1.0f};
  agg::stage_degrees<kTileAblate>(sD, deg + (static_cast<size_t>(b) * C + c0) * N, N, t.nch, G);
  float* ob = out + (static_cast<size_t>(b) * C + c0) * N * F + static_cast<size_t>(r0) * F;
  for (int f0 = 0; f0 < F; f0 += 8 * agg::kPassNT) {
    const int nf = min(8 * agg::kPassNT, F - f0);
    agg::aggregate<kTileStages, kNT, kQuad, kBf16, kTileAblate>(
        geo, t, smem, sD, f0, nf, [&](int g, int r, int f, float v) {
          if (!gcn::ablated(gcn::kStore))
            ob[(static_cast<size_t>(g) * N + r) * F + f0 + f] = v;
        });
  }
}

template <bool kQuad, bool kBf16, int kNT>
int launch_tiles(const float* adj, const float* x, const float* deg, float* out, int B, int C,
                 int N, int F, int G, long long sb, long long sc, long long sn, long long sm,
                 cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(channel_agg_tile_kernel<kQuad, kBf16, kNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gmh::kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = sizeof(float) * tile_floats(N, F, G, kQuad);
  if (smem > gmh::kMaxSmem || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(C, G), cdiv(N, agg::kRows), B);
  channel_agg_tile_kernel<kQuad, kBf16, kNT><<<grid, agg::kThreads, smem, stream>>>(
      adj, x, deg, out, C, N, F, G, sb, sc, sn, sm);
  return (int)cudaGetLastError();
}

// the layout ([r][m][g] or [g][r][m]) and the n-tiles of a pass (F <= 8:
// one, else four) as the strides and F allow
template <bool kBf16>
int launch_tiles(const float* adj, const float* x, const float* deg, float* out, int B, int C,
                 int N, int F, int G, long long sb, long long sc, long long sn, long long sm,
                 cudaStream_t stream) {
  const bool quad = agg::takes_quad(adj, C, G, sb, sc, sn, sm);
  const auto launch = quad ? (F <= 8 ? launch_tiles<true, kBf16, 1> : launch_tiles<true, kBf16, 4>)
                           : (F <= 8 ? launch_tiles<false, kBf16, 1>
                                     : launch_tiles<false, kBf16, 4>);
  return launch(adj, x, deg, out, B, C, N, F, G, sb, sc, sn, sm, stream);
}

template <typename T, bool kBf16>
int launch_graphs(const T* adj, const T* x, T* out, int B, int C, int N, int F, long long sb,
                  long long sc, long long sn, long long sm, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(channel_agg_kernel<T, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gmh::kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = sizeof(float) * smem_floats(N, F);
  channel_agg_kernel<T, kBf16><<<B * C, gcn::block_threads(N, cdiv(F, 4)), smem, stream>>>(
      adj, x, out, C, N, F, sb, sc, sn, sm);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared bytes of a block: rows >= N, a whole graph in the larger of the
// two one-block layouts; rows < N, a tile of G channels in the larger of
// the tile's two layouts.
extern "C" int channel_agg_smem(int N, int F, int rows, int G) {
  int floats;
  if (rows >= N) {
    const int one = smem_floats(N, F), four = smem_floats_group(N, F);
    floats = one > four ? one : four;
  } else {
    const int rowwise = tile_floats(N, F, G, false);
    const int quad = (G == 4 || G == 8) ? tile_floats(N, F, G, true) : 0;
    floats = rowwise > quad ? rowwise : quad;
  }
  return (int)sizeof(float) * floats;
}

// adj (B, C, N, N) in strides (sb, sc, sn, sm), x (B, N, F) contiguous ->
// out (B, C, N, F) contiguous.  rows >= N: a whole graph a block (G and deg
// unused); rows < N: the tiles of G channels reading deg (B, C, N) from
// gcn_degrees_run.  Returns the cudaError_t of the launch (0 on success).
extern "C" int channel_agg_run(const float* adj, const float* x, const float* deg, float* out,
                               int B, int C, int N, int F, long long sb, long long sc,
                               long long sn, long long sm, int rows, int G, int bf16,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows < N) {
    if (G < 1 || G > agg::kMaxGroup) return (int)cudaErrorInvalidValue;
    return bf16 ? launch_tiles<true>(adj, x, deg, out, B, C, N, F, G, sb, sc, sn, sm, s)
                : launch_tiles<false>(adj, x, deg, out, B, C, N, F, G, sb, sc, sn, sm, s);
  }
  if (takes_group(adj, C, bf16, sb, sc, sn, sm)) {
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(channel_agg_group_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           gmh::kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    const size_t smem = sizeof(float) * smem_floats_group(N, F);
    channel_agg_group_kernel<<<B * (C / kGroup), gcn::block_threads(N, cdiv(F, 4)), smem, s>>>(
        adj, x, out, C, N, F, sb, sn, sm);
    return (int)cudaGetLastError();
  }
  return bf16 ? launch_graphs<float, true>(adj, x, out, B, C, N, F, sb, sc, sn, sm, s)
              : launch_graphs<float, false>(adj, x, out, B, C, N, F, sb, sc, sn, sm, s);
}

// The whole-graph launch (N <= 64) over bf16 adj (any strides), x and out;
// bf16 != 0 rounds norm to bf16 before the product, as above.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int channel_agg_bf16_run(const gmh::bf16* adj, const gmh::bf16* x, gmh::bf16* out,
                                    int B, int C, int N, int F, long long sb, long long sc,
                                    long long sn, long long sm, int bf16, void* stream) {
  if (N > 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_graphs<gmh::bf16, true>(adj, x, out, B, C, N, F, sb, sc, sn, sm, s)
              : launch_graphs<gmh::bf16, false>(adj, x, out, B, C, N, F, sb, sc, sn, sm, s);
}
