// Sketched long-context KV for Hopper (sm_90a): the tail-table fold and
// the tail score estimates of serve/kv_sketch.py.
//
// Replaces the TPU kernels src/repro/kernels/kv_sketch.py:tail_fold
// (pallas_call of _fold_kernel) and :tail_scores (_scores_kernel).  Hashes
// are evaluated on the fly with csrc/hashing.cuh (bitwise sketch/
// hashing.py); the plain versions are kernels/ref.py:tail_fold_ref and
// tail_scores_ref.
//
// tail_fold.  For each batch element g (one (slot, layer, k-or-v) table of
// the serve path): tail[g, z, h_z(p), :] += s_z(p) * rows[g, n, :] for the
// first counts[g] rows n, p = positions[g, n]; rows past the count add
// nothing.  The TPU contracts signed one-hot tiles on the MXU because it
// has no scatter.  Here one thread block owns one (g, z) table and walks
// its rows in order, threads across the feature axis D, each doing a
// read-modify-write of its columns of table row h_z(p): no atomics, and
// the same order of additions on every run.
//   Bound: bytes.  Each valid row read once (D x 2 B for bf16) and each
//   touched table row read and written once (D x 4 B each way); about one
//   flop per byte.  The row loop is a chain of dependent global loads and
//   stores per thread, so a block runs at the latency of ~N round trips;
//   many (g, z) blocks in flight (864 at the decode fold) hide part of it.
//   Staging rows and table rows through shared memory is later work.
//
// tail_scores.  out[g, n, t] = median_z s_z(t) * (q[g, n] . tail_k[g, z,
// h_z(t)]) for every position t < T (unscaled, unmasked; the caller
// applies the softmax scale and the live mask).  Two passes, one launch
// each:
//   1. products: P[g, z, n, c] = q[g, n] . tail_k[g, z, c] for every
//      bucket c, a batched f32 GEMM (N x hd) x (hd x C) per (g, z) tiled
//      through shared memory, 32 x 64 outputs per block, 2 x 4 per
//      thread.  tail_k is read from device memory once.  The TPU kernel
//      parks the same products in VMEM scratch per query block.
//   2. select: one thread per position t computes its Z buckets and signs
//      once, then for 16 query rows gathers the Z signed products (P is
//      small and stays in L2) and takes the median (hashing.cuh, the
//      middle pair averaged for even Z).
//   A single fused kernel with the (Z, N, C) products in shared memory
//   (the TPU's layout) would have to recompute every product in each of
//   the T tiles the grid needs to fill 132 SMs, and would re-read tail_k
//   from L2 as often; the split reads tail_k once and spreads both passes
//   over hundreds of blocks even at decode, where B x K is 8.
//   Bound: bytes at decode (tail_k read once, out written once; the
//   products are 2 flops per 4-byte tail_k element per query row), f32
//   operations at chunked prefill (2 N Z C hd flops).
//
// Numerics.  The products sum hd terms in another order than the plain
// version's matmul, so estimates differ by f32 rounding; the fold adds
// each row into the table where the plain version adds the summed
// delta.  Gathers, signs and medians are exact.
//
// Every launch function runs on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success); the Python wrappers raise otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr int kFoldThreads = 256;

// pass 1 tiling: BM query rows x BN buckets per block, BK features a step
constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kProdThreads = 256;     // 16 x 16, each 2 rows x 4 buckets

constexpr int kSelThreads = 256;      // positions per block
constexpr int kSelRows = 16;          // query rows per block

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
tail_fold_kernel(const T* __restrict__ rows, const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ counts,
                 float* __restrict__ tail, long long tail_stride,
                 const uint32_t* __restrict__ coeffs, int N, uint32_t C,
                 int D) {
  const int g = blockIdx.x;
  const int z = blockIdx.y;
  const int n_valid = min(counts[g], N);
  const uint32_t a = coeffs[4 * z], b = coeffs[4 * z + 1];
  const uint32_t as = coeffs[4 * z + 2], bs = coeffs[4 * z + 3];
  const T* x = rows + (size_t)g * N * D;
  const int32_t* p = pos + (size_t)g * N;
  float* t = tail + (size_t)g * tail_stride + (size_t)z * C * D;
  for (int n = 0; n < n_valid; ++n) {
    const uint32_t u = (uint32_t)p[n];
    float* row = t + (size_t)sketch::bucket(a, b, u, C) * D;
    const bool neg = sketch::negative(as, bs, u);
    const T* xr = x + (size_t)n * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const float v = widen(xr[d]);
      row[d] += neg ? -v : v;
    }
  }
}

// q: (B, K, N, hd); tk: (B, Z, C, K, hd); P: (B*K, Z, N, C).  Block
// (cx, ny, g*Z + z).
__global__ void __launch_bounds__(kProdThreads)
scores_products_kernel(const float* __restrict__ q,
                       const float* __restrict__ tk, float* __restrict__ P,
                       int K, int N, int Z, int C, int hd) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int gz = blockIdx.z;
  const int g = gz / Z, z = gz % Z;
  const int b = g / K, k = g % K;
  const int n0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* qg = q + (size_t)g * N * hd;
  const size_t row_stride = (size_t)K * hd;           // between buckets
  const float* tz = tk + (((size_t)b * Z + z) * C * K + k) * hd;
  float acc[2][4] = {};
  for (int d0 = 0; d0 < hd; d0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / kProdThreads; ++i) {
      const int e = tid + i * kProdThreads;
      const int r = e / BK, cc = e % BK;
      const int n = n0 + r, d = d0 + cc;
      As[cc][r] = (n < N && d < hd) ? qg[(size_t)n * hd + d] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < BN * BK / kProdThreads; ++i) {
      const int e = tid + i * kProdThreads;
      const int r = e / BK, cc = e % BK;
      const int c = c0 + r, d = d0 + cc;
      Bs[cc][r] = (c < C && d < hd) ? tz[(size_t)c * row_stride + d] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = As[kk][ty], a1 = As[kk][ty + 16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv = Bs[kk][tx + 16 * j];
        acc[0][j] = fmaf(a0, bv, acc[0][j]);
        acc[1][j] = fmaf(a1, bv, acc[1][j]);
      }
    }
    __syncthreads();
  }
  float* Pg = P + ((size_t)g * Z + z) * N * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < C) Pg[(size_t)n * C + c] = acc[i][j];
    }
  }
}

// P: (G, Z, N, C); out: (G, N, T).  Block (t tile, n tile, g).
template <int Z>
__global__ void __launch_bounds__(kSelThreads)
scores_select_kernel(const float* __restrict__ P,
                     const uint32_t* __restrict__ coeffs,
                     float* __restrict__ out, int N, uint32_t C, int T) {
  const int g = blockIdx.z;
  const int t = blockIdx.x * kSelThreads + threadIdx.x;
  if (t >= T) return;
  const uint32_t u = (uint32_t)t;
  uint32_t bk[Z];
  bool neg[Z];
#pragma unroll
  for (int z = 0; z < Z; ++z) {
    bk[z] = sketch::bucket(coeffs[4 * z], coeffs[4 * z + 1], u, C);
    neg[z] = sketch::negative(coeffs[4 * z + 2], coeffs[4 * z + 3], u);
  }
  const float* Pg = P + (size_t)g * Z * N * C;
  const int n0 = blockIdx.y * kSelRows;
  const int n1 = min(n0 + kSelRows, N);
  for (int n = n0; n < n1; ++n) {
    float e[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const float x = Pg[((size_t)z * N + n) * C + bk[z]];
      e[z] = neg[z] ? -x : x;
    }
    out[((size_t)g * N + n) * T + t] = sketch::median<Z>(e);
  }
}

}  // namespace

// tail_fold: rows (G, N, D) bf16 (rows_bf16 = 1) or f32, positions (G, N)
// int32, counts (G,) int32, tail (G, Z, C, D) f32 whose g-th table starts
// tail_stride floats after the (g-1)-th, coefficients (Z, 4) uint32.
extern "C" int tail_fold_launch(const void* rows, int rows_bf16,
                                const void* positions, const void* counts,
                                void* tail, long long tail_stride,
                                const void* coeffs, int G, int N, int Z,
                                long long C, int D, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(G, Z);
  const int32_t* p = static_cast<const int32_t*>(positions);
  const int32_t* cnt = static_cast<const int32_t*>(counts);
  float* t = static_cast<float*>(tail);
  const uint32_t* c = static_cast<const uint32_t*>(coeffs);
  if (rows_bf16)
    tail_fold_kernel<__nv_bfloat16><<<grid, kFoldThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(rows), p, cnt, t, tail_stride, c,
        N, (uint32_t)C, D);
  else
    tail_fold_kernel<float><<<grid, kFoldThreads, 0, s>>>(
        static_cast<const float*>(rows), p, cnt, t, tail_stride, c, N,
        (uint32_t)C, D);
  return (int)cudaGetLastError();
}

// tail_scores pass 1: q (B, K, N, hd) f32, tail_k (B, Z, C, K, hd) f32 ->
// products (B*K, Z, N, C) f32.
extern "C" int tail_scores_products_launch(const void* q, const void* tail_k,
                                           void* products, int B, int K,
                                           int N, int Z, int C, int hd,
                                           void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((C + BN - 1) / BN, (N + BM - 1) / BM, B * K * Z);
  scores_products_kernel<<<grid, kProdThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(tail_k),
      static_cast<float*>(products), K, N, Z, C, hd);
  return (int)cudaGetLastError();
}

// tail_scores pass 2: products (G, Z, N, C), coefficients (Z, 4) uint32 ->
// out (G, N, T) f32 median-of-rows estimates.  Z from 1 to 8.
extern "C" int tail_scores_select_launch(const void* products,
                                         const void* coeffs, void* out,
                                         int G, int N, int Z, long long C,
                                         int T, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((T + kSelThreads - 1) / kSelThreads,
                  (N + kSelRows - 1) / kSelRows, G);
  const float* P = static_cast<const float*>(products);
  const uint32_t* c = static_cast<const uint32_t*>(coeffs);
  float* o = static_cast<float*>(out);
#define KV_SELECT_CASE(ZZ)                                                 \
  case ZZ:                                                                 \
    scores_select_kernel<ZZ><<<grid, kSelThreads, 0, s>>>(                 \
        P, c, o, N, (uint32_t)C, T);                                       \
    break;
  switch (Z) {
    KV_SELECT_CASE(1)
    KV_SELECT_CASE(2)
    KV_SELECT_CASE(3)
    KV_SELECT_CASE(4)
    KV_SELECT_CASE(5)
    KV_SELECT_CASE(6)
    KV_SELECT_CASE(7)
    KV_SELECT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KV_SELECT_CASE
  return (int)cudaGetLastError();
}
