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
// What the design does about it: one round of cp.async copies stages a
// block's part of the adjacency and the graph's x (and, for a tiled graph,
// the degrees gcn_degrees.cu computed), and the block waits on them once;
// the degree sums take kRowLanes lanes a row; two barriers in f32.  Two
// kernels:
//  * four channels a block (channel_agg_group_kernel) where the adjacency
//    is channels-last, as every layer after the first passes it, and the
//    graph is whole (N <= 64): each (n, m) entry of four channels is one
//    16-byte copy, x is read once for the four, and a thread's 16
//    accumulators (four channels x four F) take 16 FMAs per three 16-byte
//    shared loads (256 blocks at B = 128, C = 8);
//  * one (graph, channel) a block otherwise: `rows` rows of it, all N where
//    N <= 64 (256 blocks at the first layer's C = 2), else tiles of 32 rows
//    (768 blocks at grid's B = 8, C = 8, N = 361; 192 at C = 2).  A thread
//    owns four consecutive outputs along F of one row: each four m cost a
//    16-byte load of the A row, one of d and four of x for 16 FMAs.
// Both apply d_m to the A entries as the product reads them and d_n to the
// sums, and store four outputs in one 16-byte store where F % 4 == 0.
// Staging whole rows (not K tiles) keeps one wait per block: at N = 361,
// F = 32 a block holds 92 KB.  Plain f32 FMAs; no TF32.

#include "gcn_common.cuh"

namespace {

using gcn::cdiv;
using gcn::ld4;
using gcn::round4;

// Shared layout (floats): A rows x ld4(N) | x N x round4(F) | d round4(N).
__host__ __device__ constexpr int smem_floats(int N, int F, int rows) {
  return rows * ld4(N) + N * round4(F) + round4(N);
}

template <bool kBf16>
__global__ void __launch_bounds__(gcn::kMaxThreads)
channel_agg_kernel(const float* __restrict__ adj, const float* __restrict__ x,
                   const float* __restrict__ deg, float* __restrict__ out, int C, int N,
                   int F, int rows, long long sb, long long sc, long long sn, long long sm) {
  extern __shared__ __align__(16) float smem[];
  const int lda = ld4(N), ldx = round4(F);
  float* sA = smem;
  float* sX = sA + rows * lda;
  float* sD = sX + N * ldx;

  const int tiles = cdiv(N, rows);
  const int bc = blockIdx.x / tiles;  // b * C + c
  const int r0 = (blockIdx.x - bc * tiles) * rows, nr = min(rows, N - r0);
  const int b = bc / C, c = bc - b * C;
  const bool whole = tiles == 1;

  gcn::stage(sA, lda, adj + b * sb + c * sc + r0 * sn, sn, sm, nr, N);
  gcn::stage(sX, ldx, x + (size_t)b * N * F, F, 1, N, F);
  if (!whole) gcn::stage(sD, N, deg + (size_t)bc * N, N, 1, 1, N);
  gmh::cp_async_commit();
  gcn::zero_pad(sX, ldx, N, F);
  gmh::cp_async_wait<0>();
  __syncthreads();  // every copy has landed: a row's diagonal may be another thread's copy
  gcn::prepare_rows(sA, lda, r0, nr, N, whole, true, 1.0f, sD);
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
    for (int i = threadIdx.x; i < nr * N; i += blockDim.x) {
      const int r = i / N, m = i - r * N;
      float& v = sA[r * lda + m];
      v = gcn::round_bf16(scale ? sD[r0 + r] * v * sD[m] : v);
    }
    __syncthreads();
  }

  // f32: out = d_n sum_m (a d_m) x[m]; bf16: out = sum_m norm x[m]
  const int groups = cdiv(F, 4);
  for (int p = threadIdx.x; p < nr * groups; p += blockDim.x) {
    const int r = p / groups, c0 = 4 * (p - r * groups);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!gcn::ablated(gcn::kProduct)) {
      v = (!kBf16 && scale) ? gcn::row_times4<true>(sA + r * lda, sD, sX, ldx, c0, N)
                            : gcn::row_times4<false>(sA + r * lda, sD, sX, ldx, c0, N);
    }
    if (!kBf16 && scale) {
      const float dn = sD[r0 + r];
      v = make_float4(dn * v.x, dn * v.y, dn * v.z, dn * v.w);
    }
    gcn::store4(out + ((size_t)bc * N + r0 + r) * F, c0, F, v);
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
bool takes_group(const float* adj, int C, int N, int rows, int bf16, long long sb, long long sc,
                 long long sn, long long sm) {
  return !bf16 && rows >= N && C % kGroup == 0 && sc == 1 && sm % 4 == 0 && sn % 4 == 0 &&
         sb % 4 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15) == 0;
}

template <bool kBf16>
int launch(const float* adj, const float* x, const float* deg, float* out, int B, int C, int N,
           int F, long long sb, long long sc, long long sn, long long sm, int rows,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(channel_agg_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gmh::kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int tiles = cdiv(N, rows);
  const int threads = gcn::block_threads(rows, cdiv(F, 4));
  const size_t smem = sizeof(float) * smem_floats(N, F, rows);
  channel_agg_kernel<kBf16><<<B * C * tiles, threads, smem, stream>>>(
      adj, x, deg, out, C, N, F, rows, sb, sc, sn, sm);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared bytes of a block of `rows` rows, in the larger of the two layouts.
extern "C" int channel_agg_smem(int N, int F, int rows) {
  const int one = smem_floats(N, F, rows);
  const int four = rows >= N ? smem_floats_group(N, F) : 0;
  return (int)sizeof(float) * (one > four ? one : four);
}

// adj (B, C, N, N) in strides (sb, sc, sn, sm), x (B, N, F) contiguous ->
// out (B, C, N, F) contiguous.  rows >= N: a block per (graph, channel),
// deg unused; rows < N: blocks of `rows` rows reading deg (B, C, N) from
// gcn_degrees_run.  Returns the cudaError_t of the launch (0 on success).
extern "C" int channel_agg_run(const float* adj, const float* x, const float* deg, float* out,
                               int B, int C, int N, int F, long long sb, long long sc,
                               long long sn, long long sm, int rows, int bf16, void* stream) {
  rows = rows < N ? rows : N;
  if (takes_group(adj, C, N, rows, bf16, sb, sc, sn, sm)) {
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(channel_agg_group_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           gmh::kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    const size_t smem = sizeof(float) * smem_floats_group(N, F);
    channel_agg_group_kernel<<<B * (C / kGroup), gcn::block_threads(N, cdiv(F, 4)), smem,
                               (cudaStream_t)stream>>>(adj, x, out, C, N, F, sb, sn, sm);
    return (int)cudaGetLastError();
  }
  return bf16 ? launch<true>(adj, x, deg, out, B, C, N, F, sb, sc, sn, sm, rows,
                             (cudaStream_t)stream)
              : launch<false>(adj, x, deg, out, B, C, N, F, sb, sc, sn, sm, rows,
                              (cudaStream_t)stream);
}
