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
//
// A whole graph (N <= 64): one round of cp.async copies stages the
// graph's A, X, W and the bias, and the block waits on them once; one
// thread a row sums it (16-byte loads, no shuffles); d_m is applied to the
// A row as the product reads it; a thread owns four consecutive outputs
// along F of a row in each product (16-byte loads of the left row and four
// rows of the right operand for 16 FMAs), and the outputs leave in 16-byte
// stores where F_out % 4 == 0.  Two barriers.  Plain f32 FMAs; no TF32.
//
// Row tiles (N > 64): a block takes `rows` <= kMaxTileRows consecutive rows
// of one graph (the wrapper's plan, gcn_aggregate_plan in kernels/gcn.py:
// at N = 361, 16 tiles of 23 rows, so grid's 8 graphs make 128 blocks on
// the 132 SMs; fewer rows where a graph's X and rows do not fit) and reads
// the degrees of every column from a gcn_degrees launch just before.
// Measured and dropped (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W), to take
// that launch off the critical path: the tiles of a graph as one
// thread-block cluster sharing the degrees through distributed shared
// memory (an empty 16-block cluster kernel took 8.5 us of replay against
// ~2 for a plain one); the tiles as a programmatic dependent of the
// gcn_degrees launch (the pair took 22 us against 14.7 launched plainly);
// one cooperative launch whose tiles exchange their degrees through L2
// behind a per-graph ticket (the launch took longer than the two plain
// ones).  Not built: a ring streaming A in column chunks under the
// products; with no loads at all the kernel took 0.7 us less at grid's
// F_in 32, the most such a ring could hide.
//
// The rows of A arrive as 16-byte cp.async pieces from each row's own
// 16-byte boundary (grid's rows of 361 floats are not aligned; 4-byte
// copies are slow), X into rows padded with zero rows past N.  One pass
// then writes each row over its copy from the 16-byte boundary, as A'[n, m]
// d_m (the product a design applying d_m as it reads A takes), zeros past
// N, so the product reads aligned quads of the row and of X (the rows of a
// warp read the same X rows: broadcasts), with no d loads, each quad's
// loads one quad ahead of its FMAs: P = (A' d) X, then out = d_n (P W) +
// bias, each sum in m order, then k order: the outputs of the 32-row tiles
// this design replaced, bit for bit (scripts/gcn_stage_times.py --parent
// checks it).  That order leaves the product one thread per kRT rows and
// four features (96 threads at 23 rows and F_in 32): splitting a sum over
// m between threads would change its rounding.

#include "gcn_common.cuh"

namespace {

using gcn::cdiv;
using gcn::ld4;
using gcn::round4;

// ------------------------------------------------------- a whole graph

// Shared layout (floats): A N x ld4(N) | X N x round4(Fi) |
// W Fi x round4(Fo) | bias round4(Fo) | X W N x round4(Fo) | d round4(N).
__host__ __device__ constexpr int smem_floats(int N, int Fi, int Fo) {
  return N * ld4(N) + N * round4(Fi) + Fi * round4(Fo) + round4(Fo) + N * round4(Fo) +
         round4(N);
}

// out[c0 .. c0 + 3] = dn * v + bias[c0 ..]
template <typename T>
__device__ __forceinline__ void store_out(T* row, int c0, int Fo, float dn, float4 v,
                                          const float* sBias) {
  const float4 bv = *reinterpret_cast<const float4*>(sBias + c0);
  gcn::store4(row, c0, Fo,
              make_float4(fmaf(dn, v.x, bv.x), fmaf(dn, v.y, bv.y), fmaf(dn, v.z, bv.z),
                          fmaf(dn, v.w, bv.w)));
}

// Stage W and the bias (zeros without one), and zero the padding of W's
// rows; not committed.
template <typename T>
__device__ __forceinline__ void stage_weights(float* sW, float* sBias, int ldw, const T* w,
                                              const T* bias, int Fi, int Fo) {
  gcn::stage(sW, ldw, w, Fo, 1, Fi, Fo);
  if (bias != nullptr) gcn::stage(sBias, ldw, bias, Fo, 1, 1, Fo);
  if (bias == nullptr) gmh::zero_fill(sBias, ldw);
  gcn::zero_pad(sW, ldw, Fi, Fo);
  gcn::zero_pad(sBias, ldw, 1, Fo);
}

// T, the type of every input and the output: float, or bf16 (staged as
// f32, each output rounded once as it is stored)
template <typename T>
__global__ void __launch_bounds__(gcn::kMaxThreads)
gcn_aggregate_kernel(const T* __restrict__ x, const T* __restrict__ adj,
                     const T* __restrict__ w, const T* __restrict__ bias,
                     T* __restrict__ out, int N, int Fi, int Fo, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const int lda = ld4(N), ldx = round4(Fi), ldw = round4(Fo);
  float* sA = smem;
  float* sX = sA + N * lda;
  float* sW = sX + N * ldx;
  float* sBias = sW + Fi * ldw;
  float* sM = sBias + ldw;  // X W
  float* sD = sM + N * ldw;
  const int b = blockIdx.x;

  gcn::stage(sA, lda, adj + (size_t)b * N * N, N, 1, N, N);
  gcn::stage(sX, ldx, x + (size_t)b * N * Fi, Fi, 1, N, Fi);
  stage_weights(sW, sBias, ldw, w, bias, Fi, Fo);
  gmh::cp_async_commit();
  gcn::zero_pad(sX, ldx, N, Fi);
  gmh::cp_async_wait<0>();
  __syncthreads();  // every copy has landed: a row's diagonal may be another thread's copy
  const bool scale = !gcn::ablated(gcn::kDegrees);
  const int go = cdiv(Fo, 4);
  // degrees and X W side by side, then out = d_n sum_m (a d_m) (X W)[m] + bias
  gcn::prepare_rows(sA, lda, 0, N, N, true, add_loop, loop, sD);
  for (int p = threadIdx.x; p < N * go; p += blockDim.x) {
    const int r = p / go, c0 = 4 * (p - r * go);
    const float4 v = gcn::ablated(gcn::kProjection)
                         ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : gcn::row_times4<false>(sX + r * ldx, nullptr, sW, ldw, c0, Fi);
    *reinterpret_cast<float4*>(sM + r * ldw + c0) = v;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < N * go; p += blockDim.x) {
    const int r = p / go, c0 = 4 * (p - r * go);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!gcn::ablated(gcn::kProduct)) {
      v = scale ? gcn::row_times4<true>(sA + r * lda, sD, sM, ldw, c0, N)
                : gcn::row_times4<false>(sA + r * lda, sD, sM, ldw, c0, N);
    }
    store_out(out + ((size_t)b * N + r) * Fo, c0, Fo, scale ? sD[r] : 1.0f, v, sBias);
  }
}

// ----------------------------------------------------------- row tiles

constexpr int kMaxTileRows = 32;  // rows of a row-tile block

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Shared layout of a row-tile block (floats): the rows of A, rows x lda,
// each first as copied (16-byte pieces from the row's own boundary: N + 3
// floats at most), then as A' d written over the copy (from its 16-byte
// boundary, zeros to round16(N) + 8: the product reads round16(N) and
// loads 8 past it) | X (round16(N) + 8) x round4(Fi), zeros past N |
// W Fi x round4(Fo) | bias round4(Fo) | P rows x ld4(Fi) | d round4(N).
// The wrapper takes fewer rows a block where a graph's X and rows do not
// fit (gcn_aggregate_plan in kernels/gcn.py).
struct RowLayout {
  int lda, ldx, ldw, ldp;
  int x, w, bias, p, d, total;
  __host__ __device__ RowLayout(int N, int Fi, int Fo, int rows) {
    lda = ld4(round16(N) + 8);
    ldx = round4(Fi);
    ldw = round4(Fo);
    ldp = ld4(Fi);
    x = rows * lda;
    w = x + (round16(N) + 8) * ldx;
    bias = w + Fi * ldw;
    p = bias + ldw;
    d = p + rows * ldp;
    total = d + round4(N);
  }
};

// acc += a[0..3] . X rows m..m+3 at this thread's four features, in m order
__device__ __forceinline__ void quad_fma(float4& acc, float4 a, const float4 (&x)[4]) {
  const float ak[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc.x = fmaf(ak[u], x[u].x, acc.x);
    acc.y = fmaf(ak[u], x[u].y, acc.y);
    acc.z = fmaf(ak[u], x[u].z, acc.z);
    acc.w = fmaf(ak[u], x[u].w, acc.w);
  }
}

// P rows of a thread: P[r0 + i, c0 .. c0 + 3] for i < kRT, each a sum over
// m < Q (a multiple of 8) of A' d[r, m] X[m, c0 ..] in m order, a quad of
// four m a step; a (kRT rows' A' d, 16-byte aligned) and X (at column c0,
// ldx floats a row) hold 8 zeros past Q, which the last step loads.  Two
// register stages: each quad's loads one quad ahead of its FMAs.  kRT rows
// a thread use each loaded X quad kRT times, against shared memory's rate
// of 32 floats a cycle an SM: two rows measured faster at F_in 32, one at
// F_in 5 (two leave too few threads there).
template <int kRT>
__device__ __forceinline__ void product_rows(float4 (&acc)[kRT], const float* const (&a)[kRT],
                                             const float* xc, int ldx, int Q) {
  float4 av[2][kRT], xv[2][4];
  auto load = [&](int s, int m) {
#pragma unroll
    for (int i = 0; i < kRT; ++i) av[s][i] = *reinterpret_cast<const float4*>(a[i] + m);
#pragma unroll
    for (int u = 0; u < 4; ++u) xv[s][u] = *reinterpret_cast<const float4*>(xc + (m + u) * ldx);
  };
  load(0, 0);
  load(1, 4);
  for (int m = 0; m < Q; m += 8) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int i = 0; i < kRT; ++i) quad_fma(acc[i], av[s][i], xv[s]);
      load(s, m + 8 + 4 * s);
    }
  }
}

// A block of row tile blockIdx.x (rows r0 = rows blockIdx.x ..) of graph
// blockIdx.y; deg (B, N) holds the degrees of a gcn_degrees launch.
__global__ void __launch_bounds__(gcn::kMaxThreads)
gcn_aggregate_rows_kernel(const float* __restrict__ x, const float* __restrict__ adj,
                          const float* __restrict__ deg, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ out, int N,
                          int Fi, int Fo, int rows, int add_loop, float loop) {
  extern __shared__ __align__(16) float smem[];
  const RowLayout L(N, Fi, Fo, rows);
  float* sA = smem;  // the rows as copied, then A' d
  float* sX = smem + L.x;
  float* sW = smem + L.w;
  float* sBias = smem + L.bias;
  float* sP = smem + L.p;
  float* sD = smem + L.d;
  const int b = blockIdx.y, r0 = blockIdx.x * rows, nr = min(rows, N - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const float* arow0 = adj + ((size_t)b * N + r0) * N;  // the block's first row of A

  // the copies: A's rows (a warp a row) and the degrees, then X, W and the
  // bias
  if (gcn::ablated(gcn::kLoads)) {
    gmh::zero_fill(sA, rows * L.lda);
  } else {
    for (int r = warp; r < nr; r += nwarps)
      gcn::copy_run_async(sA + r * L.lda, arow0 + (size_t)r * N, N, lane);
  }
  gcn::stage(sD, N, deg + (size_t)b * N, N, 1, 1, N);
  gmh::cp_async_commit();  // what the A' d pass reads
  gcn::stage(sX, L.ldx, x + (size_t)b * N * Fi, Fi, 1, N, Fi);
  stage_weights(sW, sBias, L.ldw, w, bias, Fi, Fo);
  gmh::cp_async_commit();  // what the products read, landing during that pass
  gcn::zero_pad(sX, L.ldx, N, Fi);
  for (int i = threadIdx.x; i < (round16(N) + 8 - N) * L.ldx; i += blockDim.x)
    sX[N * L.ldx + i] = 0.f;
  gmh::cp_async_wait<1>();
  __syncthreads();

  // A' d over the copy, from the row's 16-byte boundary, zeros from N to
  // round16(N) + 8: a warp a row, 128 columns a step, every lane's loads
  // before any lane's stores (a step writes columns below those it and the
  // steps after it read: the copy starts run_shift >= 0 floats in)
  const bool scale = !gcn::ablated(gcn::kDegrees);
  for (int r = warp; r < nr; r += nwarps) {
    float* row = sA + r * L.lda;
    const float* raw = row + gcn::run_shift(arow0 + (size_t)r * N);
    const int n = r0 + r;
    for (int c0 = 0; c0 < round16(N) + 8; c0 += 128) {  // every lane the same steps
      const int m0 = c0 + lane;
      float a[4], dm[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + 32 * u;
        a[u] = m < N ? raw[m] : 0.f;
        dm[u] = m < N ? sD[m] : 1.f;
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + 32 * u;
        if (add_loop && m == n) a[u] = loop;
        if (m < round16(N) + 8) row[m] = scale ? a[u] * dm[u] : a[u];
      }
    }
  }
  gmh::cp_async_wait<0>();
  __syncthreads();

  // P = (A' d) X: a thread four consecutive features of kRT rows (two
  // where F_in > 12, else one)
  const int gi = cdiv(Fi, 4), go = cdiv(Fo, 4), Q = round16(N);
  auto product = [&](auto rt) {
    constexpr int kRT = decltype(rt)::value;
    for (int p = threadIdx.x; p < cdiv(nr, kRT) * gi; p += blockDim.x) {
      const int rg = p / gi, c0 = 4 * (p - rg * gi);
      float4 acc[kRT];
      const float* a[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        a[i] = sA + min(rg * kRT + i, nr - 1) * L.lda;  // a ragged tile's last row again
      }
      if (!gcn::ablated(gcn::kProduct)) product_rows<kRT>(acc, a, sX + c0, L.ldx, Q);
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        if (rg * kRT + i < nr)
          *reinterpret_cast<float4*>(sP + (rg * kRT + i) * L.ldp + c0) = acc[i];
    }
  };
  if (gi > 3)
    product(std::integral_constant<int, 2>{});
  else
    product(std::integral_constant<int, 1>{});
  __syncthreads();

  // out = d_n P W + bias
  for (int p = threadIdx.x; p < nr * go; p += blockDim.x) {
    const int r = p / go, c0 = 4 * (p - r * go);
    const float4 v = gcn::ablated(gcn::kProjection)
                         ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : gcn::row_times4<false>(sP + r * L.ldp, nullptr, sW, L.ldw, c0, Fi);
    store_out(out + ((size_t)b * N + r0 + r) * Fo, c0, Fo, scale ? sD[r0 + r] : 1.0f, v,
              sBias);
  }
}

// The shared bytes a launch of `rows` rows a block takes.
int smem_bytes(int N, int Fi, int Fo, int rows) {
  return (int)sizeof(float) *
         (rows >= N ? smem_floats(N, Fi, Fo) : RowLayout(N, Fi, Fo, rows).total);
}

// Raise a kernel's shared-memory limit once; the cudaError_t.
template <typename Kernel>
cudaError_t allow(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              gmh::kMaxSmem);
}

}  // namespace

// Shared bytes of a block of `rows` rows (rows >= N: a whole graph).
extern "C" int gcn_aggregate_smem(int N, int Fi, int Fo, int rows) {
  return smem_bytes(N, Fi, Fo, rows);
}

// x (B, N, F_in), adj (B, N, N), w (F_in, F_out), bias (F_out) or null, all
// contiguous -> out (B, N, F_out).  rows >= N: a block per graph (deg
// unused).  rows < N: blocks of `rows` <= 32 rows reading deg (B, N) of a
// gcn_degrees_run launched before on `stream`.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int gcn_aggregate_run(const float* x, const float* adj, const float* deg,
                                 const float* w, const float* bias, float* out, int B, int N,
                                 int Fi, int Fo, int rows, int add_loop, float loop,
                                 void* stream) {
  static cudaError_t whole_ok = allow(gcn_aggregate_kernel<float>);
  static cudaError_t rows_ok = allow(gcn_aggregate_rows_kernel);
  const int smem = smem_bytes(N, Fi, Fo, rows);
  if (smem > gmh::kMaxSmem || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows >= N) {
    if (whole_ok != cudaSuccess) return (int)whole_ok;
    gcn_aggregate_kernel<float>
        <<<B, gcn::block_threads(N, cdiv(Fi > Fo ? Fi : Fo, 4)), smem, s>>>(
            x, adj, w, bias, out, N, Fi, Fo, add_loop, loop);
    return (int)cudaGetLastError();
  }
  if (rows > kMaxTileRows) return (int)cudaErrorInvalidValue;
  if (rows_ok != cudaSuccess) return (int)rows_ok;
  gcn_aggregate_rows_kernel<<<dim3(cdiv(N, rows), B), gcn::kMaxThreads, smem, s>>>(
      x, adj, deg, w, bias, out, N, Fi, Fo, rows, add_loop, loop);
  return (int)cudaGetLastError();
}

// The whole-graph launch (N <= 64) over bf16 x, adj, w, bias (or null) and
// out.  Returns the cudaError_t of the launch (0 on success).
extern "C" int gcn_aggregate_bf16_run(const gmh::bf16* x, const gmh::bf16* adj,
                                      const gmh::bf16* w, const gmh::bf16* bias,
                                      gmh::bf16* out, int B, int N, int Fi, int Fo,
                                      int add_loop, float loop, void* stream) {
  static cudaError_t ok = allow(gcn_aggregate_kernel<gmh::bf16>);
  const int smem = smem_bytes(N, Fi, Fo, N);
  if (smem > gmh::kMaxSmem || B > 65535 || N > 64) return (int)cudaErrorInvalidValue;
  if (ok != cudaSuccess) return (int)ok;
  gcn_aggregate_kernel<gmh::bf16>
      <<<B, gcn::block_threads(N, cdiv(Fi > Fo ? Fi : Fo, 4)), smem, (cudaStream_t)stream>>>(
          x, adj, w, bias, out, N, Fi, Fo, add_loop, loop);
  return (int)cudaGetLastError();
}
