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
//      bucket c, a batched (N x hd) x (hd x C) product per (g, z) on the
//      tensor cores (mma.sync m16n8k8 in TF32).  f32 inputs go in as
//      3xTF32: x = big + small, big = x rounded to TF32 and small = the
//      remainder rounded to TF32, and each product is small*big +
//      big*small + big*big accumulated in f32 (the small*small term is
//      below f32 rounding), which keeps the error of an f32 product (one
//      TF32 product alone keeps ~3 decimal digits, which the estimates'
//      stated tolerance does not allow).  Both operands stream through a
//      ring of 32-feature slices in shared memory by 16-byte
//      cp.async; tail_k's rows are hd-contiguous (1 KB at hd 256), so a
//      slice of a row is 128 contiguous bytes.  Two tile shapes, picked
//      by N:
//        decode (N <= 16): 16 query rows x 64 buckets a block, 4 warps of
//          16 x 16 each, so the 8k decode (24 (g, z) tables of 1024
//          buckets) is 384 blocks, all resident at once, and tail_k
//          (25 MB) is read once with 2 slices a block in flight (a ring
//          of 3; 32 x 32 tiles and rings of 4 or 8 measured no faster);
//        prefill: 64 x 64 a block, 4 warps of 32 x 32 (2 x 4 mma tiles),
//          1,536 blocks at the 8k chunk (N 2048), a ring of 3.
//      The TPU kernel parks the same products in VMEM scratch per query
//      block.
//   2. select: a block copies the products of up to 8 query rows, all Z
//      rows and C buckets (96 KB at Z 3, C 1024), into shared memory with
//      coalesced reads (P is small and stays in L2), then walks a chunk of
//      positions a thread each: Z buckets and signs, and for each of its
//      rows the Z signed products gathered from shared memory and their
//      median (hashing.cuh, the middle pair averaged for even Z), written
//      coalesced along t.  Chunks of T fill the card when the rows do not
//      (decode: 8 slots x 1 row tile x 32 chunks).  Gathering straight
//      from P in device memory costs one L2 sector per product (on an
//      H100, 0.149 of 0.235 ms at the 8k chunk prefill).
//   A single fused kernel with the (Z, N, C) products in shared memory
//   (the TPU's layout) would have to recompute every product in each of
//   the T tiles the grid needs to fill 132 SMs, and would re-read tail_k
//   from L2 as often; the split reads tail_k once.
//   Bound: bytes at decode (tail_k read once, out written once; the
//   products are 2 flops per 4-byte tail_k element per query row), f32
//   operations at chunked prefill (2 N Z C hd flops).
//
// Numerics.  The products sum hd terms in another order than the plain
// version's matmul, through the 3xTF32 split, so estimates differ by f32
// rounding; the fold adds
// each row into the table where the plain version adds the summed
// delta.  Gathers, signs and medians are exact.
//
// Every launch function runs on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success); the Python wrappers raise otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"
#include "hashing.cuh"

namespace {

constexpr int kFoldThreads = 128;
constexpr int kFoldTile = 32;         // rows staged per step: a warp
constexpr int kFoldCols = 64;         // table columns per block

// pass 1: a stage holds kProdK features of every row of the tile, rows
// kProdLd floats apart (the padding makes the fragment reads conflict
// free); a ring of kProdStages stages (the kernel's template argument)
constexpr int kProdK = 32;
constexpr int kProdLd = kProdK + 4;
constexpr int kProdThreads = 128;     // 4 warps
constexpr int kDecodeRows = 16;       // N at most this takes the decode tile

constexpr int kSelThreads = 256;      // positions a block walks at once
constexpr int kSelRows = 8;           // query rows a block, at most
constexpr long long kSelSmem = 200 * 1024;  // staged products, at most

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

// x rounded to TF32 (round to nearest, ties away), as mma operand bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (the 3xTF32 split).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a * b: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// q: (B, K, N, hd); tk: (B, Z, C, K, hd); P: (B*K, Z, N, C); hd a multiple
// of 4.  Block (c tile, n tile, g*Z + z) of BM = WM*MT*16 query rows x
// BN = WN*NT*8 buckets; warp (wm, wn) owns MT x NT mma tiles.  Rows past
// N, buckets past C and features past hd are zero-filled in shared memory.
template <int WM, int WN, int MT, int NT, int kProdStages>
__global__ void __launch_bounds__(kProdThreads)
scores_products_kernel(const float* __restrict__ q,
                       const float* __restrict__ tk, float* __restrict__ P,
                       int K, int N, int Z, int C, int hd) {
  static_assert(WM * WN * 32 == kProdThreads, "four warps");
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int kUnits = kProdK / 4;             // 16-byte copies a row
  extern __shared__ __align__(16) float psm[];
  float* As = psm;                                // [stage][BM][kProdLd]
  float* Bs = psm + kProdStages * BM * kProdLd;   // [stage][BN][kProdLd]
  const int gz = blockIdx.z;
  const int g = gz / Z, z = gz % Z;
  const int b = g / K, k = g % K;
  const int n0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const float* qg = q + (size_t)g * N * hd;
  const size_t row_stride = (size_t)K * hd;           // between buckets
  const float* tz = tk + (((size_t)b * Z + z) * C * K + k) * hd;
  const int steps = (hd + kProdK - 1) / kProdK;

  auto stage = [&](int slot, int d0) {
    float* as = As + slot * BM * kProdLd;
    float* bs = Bs + slot * BN * kProdLd;
    for (int e = threadIdx.x; e < BM * kUnits; e += kProdThreads) {
      const int r = e / kUnits, cc = (e % kUnits) * 4;
      const int n = n0 + r, d = d0 + cc;
      const bool ok = n < N && d < hd;
      async_copy::copy_or_zero<16>(as + r * kProdLd + cc,
                                   ok ? qg + (size_t)n * hd + d : qg, ok);
    }
    for (int e = threadIdx.x; e < BN * kUnits; e += kProdThreads) {
      const int r = e / kUnits, cc = (e % kUnits) * 4;
      const int c = c0 + r, d = d0 + cc;
      const bool ok = c < C && d < hd;
      async_copy::copy_or_zero<16>(bs + r * kProdLd + cc,
                                   ok ? tz + (size_t)c * row_stride + d : tz,
                                   ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kProdStages - 1; ++s) {
    if (s < steps) stage(s, s * kProdK);
    async_copy::commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[MT][NT][4] = {};
  for (int it = 0; it < steps; ++it) {
    async_copy::wait<kProdStages - 2>();   // slice it landed
    __syncthreads();                       // ... for every thread; slot of
                                           // it - 1 free for reuse
    const int nxt = it + kProdStages - 1;
    if (nxt < steps) stage(nxt % kProdStages, nxt * kProdK);
    async_copy::commit();
    const float* as = As + (it % kProdStages) * BM * kProdLd;
    const float* bs = Bs + (it % kProdStages) * BN * kProdLd;
#pragma unroll
    for (int kk = 0; kk < kProdK; kk += 8) {
      uint32_t ab[MT][4], asm_[MT][4], bb[NT][2], bsm[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a0 = as + (wm * MT * 16 + mt * 16 + gid) * kProdLd + kk;
        split_tf32(a0[tig], ab[mt][0], asm_[mt][0]);
        split_tf32(a0[8 * kProdLd + tig], ab[mt][1], asm_[mt][1]);
        split_tf32(a0[tig + 4], ab[mt][2], asm_[mt][2]);
        split_tf32(a0[8 * kProdLd + tig + 4], ab[mt][3], asm_[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* b0 = bs + (wn * NT * 8 + nt * 8 + gid) * kProdLd + kk;
        split_tf32(b0[tig], bb[nt][0], bsm[nt][0]);
        split_tf32(b0[tig + 4], bb[nt][1], bsm[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(acc[mt][nt], asm_[mt], bb[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bsm[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
        }
    }
  }
  async_copy::wait<0>();
  float* Pg = P + ((size_t)g * Z + z) * N * C;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = c0 + wn * NT * 8 + nt * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * MT * 16 + mt * 16 + gid + 8 * h;
        if (n >= N) continue;
        if (c < C) Pg[(size_t)n * C + c] = acc[mt][nt][2 * h];
        if (c + 1 < C) Pg[(size_t)n * C + c + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

template <int WM, int WN, int MT, int NT, int S>
int launch_products(const float* q, const float* tk, float* P, int B, int K,
                    int N, int Z, int C, int hd, cudaStream_t s) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int bytes = S * (BM + BN) * kProdLd * sizeof(float);
  auto kernel = scores_products_kernel<WM, WN, MT, NT, S>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((C + BN - 1) / BN, (N + BM - 1) / BM, B * K * Z);
  kernel<<<grid, kProdThreads, bytes, s>>>(q, tk, P, K, N, Z, C, hd);
  return (int)cudaGetLastError();
}

// P: (G, Z, N, C); out: (G, N, T).  Block (t chunk, n tile of RB rows, g).
template <int Z>
__global__ void __launch_bounds__(kSelThreads)
scores_select_kernel(const float* __restrict__ P,
                     const uint32_t* __restrict__ coeffs,
                     float* __restrict__ out, int N, sketch::Divisor Cd,
                     int T, int RB, int chunk) {
  extern __shared__ float ps[];                   // [Z][RB][C]
  const int C = (int)Cd.d;
  const int g = blockIdx.z;
  const int n0 = blockIdx.y * RB;
  const int rows = min(RB, N - n0);
  const float* Pg = P + (size_t)g * Z * N * C;
  for (int z = 0; z < Z; ++z) {
    const float* src = Pg + ((size_t)z * N + n0) * C;
    float* dst = ps + (size_t)z * RB * C;
    for (int e = threadIdx.x; e < rows * C; e += kSelThreads) dst[e] = src[e];
  }
  uint32_t c[4 * Z];
#pragma unroll
  for (int k = 0; k < 4 * Z; ++k) c[k] = __ldg(coeffs + k);
  __syncthreads();
  const int t1 = min(T, (blockIdx.x + 1) * chunk);
  for (int t = blockIdx.x * chunk + threadIdx.x; t < t1; t += kSelThreads) {
    const uint32_t u = (uint32_t)t;
    int bk[Z];
    bool neg[Z];
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      bk[z] = (int)sketch::bucket(c[4 * z], c[4 * z + 1], u, Cd);
      neg[z] = sketch::negative(c[4 * z + 2], c[4 * z + 3], u);
    }
    for (int r = 0; r < rows; ++r) {
      float e[Z];
#pragma unroll
      for (int z = 0; z < Z; ++z) {
        const float x = ps[((size_t)z * RB + r) * C + bk[z]];
        e[z] = neg[z] ? -x : x;
      }
      out[((size_t)g * N + n0 + r) * T + t] = sketch::median<Z>(e);
    }
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
// products (B*K, Z, N, C) f32; hd a multiple of 4, both 16-byte aligned.
extern "C" int tail_scores_products_launch(const void* q, const void* tail_k,
                                           void* products, int B, int K,
                                           int N, int Z, int C, int hd,
                                           void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* tf = static_cast<const float*>(tail_k);
  float* P = static_cast<float*>(products);
  if (N <= kDecodeRows)
    return launch_products<1, 4, 1, 2, 3>(qf, tf, P, B, K, N, Z, C, hd, s);
  return launch_products<2, 2, 2, 4, 3>(qf, tf, P, B, K, N, Z, C, hd, s);
}

// tail_scores pass 2: products (G, Z, N, C), coefficients (Z, 4) uint32 ->
// out (G, N, T) f32 median-of-rows estimates.  Z from 1 to 8; a row's Z x
// C products must fit the block's shared memory (kSelSmem).
extern "C" int tail_scores_select_launch(const void* products,
                                         const void* coeffs, void* out,
                                         int G, int N, int Z, long long C,
                                         int T, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long row_bytes = (long long)Z * C * sizeof(float);
  const int RB = (int)std::min<long long>(kSelRows, kSelSmem / row_bytes);
  if (RB < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (N + RB - 1) / RB;
  // chunks of T (whole multiples of the block) until ~2 blocks an SM
  const long long want = (2LL * 132 + (long long)G * tiles - 1) /
                         ((long long)G * tiles);
  const int per = (int)((T + want - 1) / want);
  const int chunk = (per + kSelThreads - 1) / kSelThreads * kSelThreads;
  const dim3 grid((T + chunk - 1) / chunk, tiles, G);
  const int bytes = (int)(RB * row_bytes);
  const float* P = static_cast<const float*>(products);
  const uint32_t* c = static_cast<const uint32_t*>(coeffs);
  float* o = static_cast<float*>(out);
  const sketch::Divisor Cd = sketch::make_divisor((uint32_t)C);
  int err = 0;
#define KV_SELECT_CASE(ZZ)                                                 \
  case ZZ:                                                                 \
    err = (int)cudaFuncSetAttribute(                                       \
        scores_select_kernel<ZZ>,                                          \
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);               \
    if (err) return err;                                                   \
    scores_select_kernel<ZZ><<<grid, kSelThreads, bytes, s>>>(             \
        P, c, o, N, Cd, T, RB, chunk);                                     \
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
