// Degree-normalised dense GCN aggregation, a block per graph or per tile
// of a graph's rows.
//
// Replaces: gcn_aggregate_pallas, ccsd_tpu/ops/pallas/gcn.py:45-85 (body
// _gcn_kernel :31-42), whose Pallas grid (B,) becomes the CUDA grid
// (B * row tiles,).
//
//   A'  = A with the diagonal set to `loop` (when add_loop)
//   d   = max(rowsum A', 1)^-1/2
//   out = (d * A' * d^T) (X W) + bias
//
// A block holding a whole graph takes it as out[n] = d_n sum_m (A'[n, m]
// d_m) (X W)[m] + bias: X W is formed beside the degree sums, so one
// barrier fewer separates the loads from the store.  A block holding a
// tile of rows takes the (norm X) W order, out[n] = d_n ((A' (d * X))
// W)[n] + bias, so that it works on its rows only (norm (X W) would need
// X W of every row in every block).
//
// What bounds it on H100: at the sampler's shapes (B = 128, N = 20,
// F <= 32) one call moves ~0.9 MB and does ~4 MFLOP, about 0.26 us at
// 3.35 TB/s (bytes bound it), so the block's serial phases bound it in
// practice.  At grid's N = 361 (B = 8) the adjacency is 4.2 MB, ~1.3 us.
// What the design does about it: one round of cp.async copies stages the
// block's rows of A (every column), the graph's X, W and the bias (and,
// for a tiled graph, the degrees gcn_degrees.cu computed), and the block
// waits on them once.  Where N <= 64 a block takes a whole graph and one
// thread a row sums it (16-byte loads, no shuffles); else it takes 32
// rows, so grid's 8 graphs make 96 blocks.  d_m is applied to the A row as
// the product reads it; a thread owns four consecutive outputs along F of
// a row in each product (16-byte loads of the left row and four rows of
// the right operand for 16 FMAs), and the outputs leave in 16-byte stores
// where F_out % 4 == 0.  The bias is staged, not read per output.  Two
// barriers for a whole graph, three for a row tile.  Plain f32 FMAs; no
// TF32.

#include "gcn_common.cuh"

namespace {

using gcn::cdiv;
using gcn::ld4;
using gcn::round4;

// Row stride (floats) of the middle product: X W of every row (whole
// graphs) or P = A' (d * X) of the block's rows (row tiles).
__host__ __device__ constexpr int mid_ld(int Fi, int Fo, bool whole) {
  return whole ? round4(Fo) : round4(Fi);
}

// Shared layout (floats): A rows x ld4(N) | X N x round4(Fi) |
// W Fi x round4(Fo) | bias round4(Fo) | X W or P rows x mid_ld | d round4(N).
__host__ __device__ constexpr int smem_floats(int N, int Fi, int Fo, int rows) {
  return rows * ld4(N) + N * round4(Fi) + Fi * round4(Fo) + round4(Fo) +
         rows * mid_ld(Fi, Fo, rows >= N) + round4(N);
}

// out[c0 .. c0 + 3] = dn * v + bias[c0 ..]
__device__ __forceinline__ void store_out(float* row, int c0, int Fo, float dn, float4 v,
                                          const float* sBias) {
  const float4 bv = *reinterpret_cast<const float4*>(sBias + c0);
  gcn::store4(row, c0, Fo,
              make_float4(fmaf(dn, v.x, bv.x), fmaf(dn, v.y, bv.y), fmaf(dn, v.z, bv.z),
                          fmaf(dn, v.w, bv.w)));
}

__global__ void __launch_bounds__(gcn::kMaxThreads)
gcn_aggregate_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                     const float* __restrict__ deg, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int N, int Fi,
                     int Fo, int rows, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const int lda = ld4(N), ldx = round4(Fi), ldw = round4(Fo);
  float* sA = smem;
  float* sX = sA + rows * lda;
  float* sW = sX + N * ldx;
  float* sBias = sW + Fi * ldw;
  float* sM = sBias + ldw;  // X W (whole graph) or P (row tile)
  const int ldm = mid_ld(Fi, Fo, rows >= N);
  float* sD = sM + rows * ldm;

  const int tiles = cdiv(N, rows);
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - b * tiles) * rows, nr = min(rows, N - r0);
  const bool whole = tiles == 1;

  gcn::stage(sA, lda, adj + ((size_t)b * N + r0) * N, N, 1, nr, N);
  gcn::stage(sX, ldx, x + (size_t)b * N * Fi, Fi, 1, N, Fi);
  gcn::stage(sW, ldw, w, Fo, 1, Fi, Fo);
  if (bias != nullptr) gcn::stage(sBias, ldw, bias, Fo, 1, 1, Fo);
  if (!whole) gcn::stage(sD, N, deg + (size_t)b * N, N, 1, 1, N);
  gmh::cp_async_commit();
  if (bias == nullptr) gmh::zero_fill(sBias, ldw);
  gcn::zero_pad(sX, ldx, N, Fi);
  gcn::zero_pad(sW, ldw, Fi, Fo);
  gcn::zero_pad(sBias, ldw, 1, Fo);
  gmh::cp_async_wait<0>();
  __syncthreads();  // every copy has landed: a row's diagonal may be another thread's copy
  const bool scale = !gcn::ablated(gcn::kDegrees);
  const int gi = cdiv(Fi, 4), go = cdiv(Fo, 4);
  if (whole) {
    // degrees and X W side by side, then out = d_n sum_m (a d_m) (X W)[m] + bias
    gcn::prepare_rows(sA, lda, r0, nr, N, true, add_loop, loop, sD);
    for (int p = threadIdx.x; p < N * go; p += blockDim.x) {
      const int r = p / go, c0 = 4 * (p - r * go);
      const float4 v = gcn::ablated(gcn::kProjection)
                           ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : gcn::row_times4<false>(sX + r * ldx, nullptr, sW, ldw, c0, Fi);
      *reinterpret_cast<float4*>(sM + r * ldm + c0) = v;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < N * go; p += blockDim.x) {
      const int r = p / go, c0 = 4 * (p - r * go);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!gcn::ablated(gcn::kProduct)) {
        v = scale ? gcn::row_times4<true>(sA + r * lda, sD, sM, ldm, c0, N)
                  : gcn::row_times4<false>(sA + r * lda, sD, sM, ldm, c0, N);
      }
      store_out(out + ((size_t)b * N + r) * Fo, c0, Fo, scale ? sD[r] : 1.0f, v, sBias);
    }
    return;
  }

  // a row tile: P = A' (d * X) for the block's rows, then out = d_n P W + bias
  gcn::prepare_rows(sA, lda, r0, nr, N, false, add_loop, loop, sD);
  __syncthreads();
  for (int p = threadIdx.x; p < nr * gi; p += blockDim.x) {
    const int r = p / gi, c0 = 4 * (p - r * gi);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!gcn::ablated(gcn::kProduct)) {
      v = scale ? gcn::row_times4<true>(sA + r * lda, sD, sX, ldx, c0, N)
                : gcn::row_times4<false>(sA + r * lda, sD, sX, ldx, c0, N);
    }
    *reinterpret_cast<float4*>(sM + r * ldm + c0) = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nr * go; p += blockDim.x) {
    const int r = p / go, c0 = 4 * (p - r * go);
    const float4 v = gcn::ablated(gcn::kProjection)
                         ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : gcn::row_times4<false>(sM + r * ldm, nullptr, sW, ldw, c0, Fi);
    store_out(out + ((size_t)b * N + r0 + r) * Fo, c0, Fo, scale ? sD[r0 + r] : 1.0f, v, sBias);
  }
}

}  // namespace

// Shared bytes of a block of `rows` rows.
extern "C" int gcn_aggregate_smem(int N, int Fi, int Fo, int rows) {
  return (int)sizeof(float) * smem_floats(N, Fi, Fo, rows);
}

// x (B, N, F_in), adj (B, N, N), w (F_in, F_out), bias (F_out) or null, all
// contiguous -> out (B, N, F_out).  rows >= N: a block per graph, deg
// unused; rows < N: blocks of `rows` rows reading deg (B, N) from
// gcn_degrees_run.  Returns the cudaError_t of the launch (0 on success).
extern "C" int gcn_aggregate_run(const float* x, const float* adj, const float* deg,
                                 const float* w, const float* bias, float* out, int B, int N,
                                 int Fi, int Fo, int rows, int add_loop, float loop,
                                 void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gcn_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gmh::kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  rows = rows < N ? rows : N;
  const int widest = cdiv(Fi > Fo ? Fi : Fo, 4);
  const size_t smem = sizeof(float) * smem_floats(N, Fi, Fo, rows);
  gcn_aggregate_kernel<<<B * cdiv(N, rows), gcn::block_threads(rows, widest), smem,
                         (cudaStream_t)stream>>>(x, adj, deg, w, bias, out, N, Fi, Fo, rows,
                                                 add_loop, loop);
  return (int)cudaGetLastError();
}
