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
// has no scatter.  Here one thread block owns one (g, z) table and one
// slice of kFoldCols columns (so the 8k prefill fold-through, 36 tables x
// 3 rows x D 256, is 432 blocks) and walks its rows in tiles of kFoldTile:
//   1. the tile's positions (read a tile ahead) are hashed by one warp,
//      a row a lane, and its rows' slice was copied into shared memory
//      by cp.async a tile ahead;
//   2. each row finds, with __match_any_sync, the next row of the tile
//      with the same bucket and whether it is the first of its bucket;
//   3. for every first row, the table row's slice is gathered into
//      shared memory by cp.async, every copy of the tile in flight at
//      once and no register held for them;
//   4. each (first row, column) adds the rows of its bucket's chain in
//      increasing n and writes the table element back once.
// Each table element thus receives the same additions in the same order
// as a row-by-row sequential fold: the result is bitwise that fold, and
// the same on every run (no atomics).  The plain model of the tiling is
// tests/test_torch_kv_sketch.py:tail_fold_tiled_ref.
//   Bound: bytes.  Each valid row read once (D x 2 B for bf16) and each
//   touched table row read and written once (D x 4 B each way); about one
//   flop per byte.  A tile costs one dependent round trip (the gather);
//   the next tile's position and row copies overlap it.

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

#include "async_copy.cuh"
#include "hashing.cuh"

namespace {

constexpr int kFoldThreads = 128;
constexpr int kFoldTile = 32;         // rows staged per step: a warp
constexpr int kFoldCols = 64;         // table columns per block

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

// Copies tile rows [n0, n0 + kFoldTile) of this block's column slice of
// one (N, D) row block into xs (row r at xs + r * kFoldCols), 16 bytes at
// a time; rows past N are left as they were (they are never read).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, int n0,
                                           int N, int D, int c0, T* xs) {
  constexpr int per = 16 / sizeof(T);            // elements per copy
  constexpr int units = kFoldCols / per;          // copies per row
  for (int e = threadIdx.x; e < kFoldTile * units; e += kFoldThreads) {
    const int r = e / units, c = (e - r * units) * per;
    const int n = n0 + r, d = c0 + c;
    if (n < N && d < D)
      async_copy::copy16(xs + r * kFoldCols + c, x + (size_t)n * D + d);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
tail_fold_kernel(const T* __restrict__ rows, const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ counts,
                 float* __restrict__ tail, long long tail_stride,
                 const uint32_t* __restrict__ coeffs, int N, uint32_t C,
                 int D) {
  __shared__ uint32_t bk[kFoldTile];
  __shared__ bool neg[kFoldTile];
  __shared__ bool first[kFoldTile];
  __shared__ int next[kFoldTile];
  __shared__ __align__(16) float tb[kFoldTile][kFoldCols];  // table rows
  __shared__ __align__(16) T xs[2][kFoldTile * kFoldCols];  // rows, 2 tiles
  const int g = blockIdx.x;
  const int z = blockIdx.y;
  const int c0 = blockIdx.z * kFoldCols;
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t a = coeffs[4 * z], b = coeffs[4 * z + 1];
  const uint32_t as = coeffs[4 * z + 2], bs = coeffs[4 * z + 3];
  const T* x = rows + (size_t)g * N * D;
  const int32_t* p = pos + (size_t)g * N;
  float* t = tail + (size_t)g * tail_stride + (size_t)z * C * D;
  // tile 0's positions (warp 0, one row a lane) and rows are requested
  // with the count: rows past it lie inside the (N, D) block and are
  // never added
  int p_tile = tid < kFoldTile && tid < N ? p[tid] : 0;
  stage_rows(x, 0, N, D, c0, xs[0]);
  async_copy::commit();
  const int n_valid = min(counts[g], N);
  for (int n0 = 0, buf = 0; n0 < n_valid; n0 += kFoldTile, buf ^= 1) {
    const int nt = min(kFoldTile, n_valid - n0);
    if (tid < kFoldTile) {
      // buckets; rows past the count get distinct values >= 2^31 (C <
      // 2^31) so they match nothing; then each row's bucket-mates
      const uint32_t u = (uint32_t)p_tile;
      const uint32_t bkt = lane < nt ? sketch::bucket(a, b, u, C)
                                     : 0x80000000u | lane;
      const uint32_t same = __match_any_sync(0xffffffffu, bkt);
      const uint32_t later = same & ~((2u << lane) - 1u);
      bk[lane] = bkt;
      neg[lane] = sketch::negative(as, bs, u);
      first[lane] = __ffs(same) - 1 == lane;
      next[lane] = later ? __ffs(later) - 1 : -1;
      const int n1 = n0 + kFoldTile + lane;      // next tile's position
      if (n1 < N) p_tile = p[n1];
    }
    __syncthreads();
    // each bucket's first row gathers its table row's slice: every copy
    // of the tile in flight at once, then the next tile's rows behind it
    for (int e = tid; e < kFoldTile * kFoldCols / 4; e += kFoldThreads) {
      const int r = e / (kFoldCols / 4), c = e % (kFoldCols / 4) * 4;
      const int d = c0 + c;
      if (r < nt && first[r] && d < D)
        async_copy::copy16(&tb[r][c], t + (size_t)bk[r] * D + d);
    }
    async_copy::commit();
    if (n0 + kFoldTile < n_valid)
      stage_rows(x, n0 + kFoldTile, N, D, c0, xs[buf ^ 1]);
    async_copy::commit();
    async_copy::wait<1>();          // this tile's rows and gather landed
    __syncthreads();
    // add each bucket's rows in increasing n, write the element back once
    const T* xt = xs[buf];
    for (int e = tid; e < kFoldTile * kFoldCols; e += kFoldThreads) {
      const int r = e / kFoldCols, c = e % kFoldCols, d = c0 + c;
      if (!(r < nt && first[r] && d < D)) continue;
      float acc = tb[r][c];
      for (int m = r; m >= 0; m = next[m]) {
        const float xv = widen(xt[m * kFoldCols + c]);
        acc += neg[m] ? -xv : xv;
      }
      t[(size_t)bk[r] * D + d] = acc;
    }
    __syncthreads();              // smem reused; written rows visible
  }
  async_copy::wait<0>();
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
// tail_stride floats after the (g-1)-th, coefficients (Z, 4) uint32.  The
// 16-byte copies need rows and tail 16-byte aligned, D a multiple of 8
// (bf16 rows) or 4 (f32), and tail_stride a multiple of 4.
extern "C" int tail_fold_launch(const void* rows, int rows_bf16,
                                const void* positions, const void* counts,
                                void* tail, long long tail_stride,
                                const void* coeffs, int G, int N, int Z,
                                long long C, int D, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(G, Z, (D + kFoldCols - 1) / kFoldCols);
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
