// Split-KV flash-decode paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (pallas_call body _attend_block).  It computes the same
// raw f32 online-softmax statistics (m, l, acc) through per-slot block
// tables: query row i of slot b sees key position p iff
// fold_base[b] <= p <= start[b] + i and p's block is live (table entry
// < NB).  The plain version is kernels/ref.py:paged_attention_ref; the
// plain model of this decomposition is
// tests/test_torch_paged_attention.py:paged_attention_split_ref.
//
// What bounds it on this card: bytes.  Per call it must read each live KV
// row once (K and V, bf16) and does ~4 flops per KV byte at decode, far
// below the ~295 flop/byte ridge of an H100.  What the design does:
//   * Split-KV.  The grid runs over (KV split, tile of query rows, slot x
//     kv head).  Each block owns a contiguous range of the slot's logical
//     blocks, so a decode step of 8 slots fills the card (the wrapper's
//     planner, kernels/paged_attention.py:plan, picks the split count from
//     the shapes and the SM count alone; it never reads start, fold_base
//     or the tables, so a slot's output depends on its own inputs only and
//     the call needs no host sync).  Each split writes partial (m, l, acc)
//     to f32 scratch and paged_attention_merge_kernel combines the splits
//     in increasing order (no atomics: two launches agree bitwise).
//   * One tile per kv head.  All R*Sq query rows of a kv head share a tile
//     of 16 to 64 rows (the MMA's M), so each KV row is read once per tile;
//     q is read straight from its (B, Sq, K, R, hd) strides.
//   * Asynchronous staging.  A ring of kStages stages of kKeys keys (whole
//     pool blocks) of K and V in shared memory, filled by 16-byte
//     cp.async.cg copies kStages - 1 stages ahead of the stage in use; the
//     split's table entries and q are read while start and fold_base are.
//   * Tensor cores.  S = Q K^T and acc += P V run on mma.sync.m16n8k16
//     (bf16 in, f32 accumulate).  A warp owns 16 query rows and a slice of
//     16 * CH head dims; the DG warps of a row group add their slices'
//     partial scores through shared memory in a fixed order and then all
//     hold the same scores, so the online softmax (f32) agrees across them.
// Blocks that are dead (entry >= NB) are zeroed, not read, and masked;
// blocks outside the tile's visible range are never visited.  Skipping a
// block is exactly masking it: m_cur == m_prev, corr == 1 and p == 0.
// Left for later: TMA and wgmma (decode does too few flops per byte for
// wgmma to matter), and a persistent grid.
//
// Numerics follow the reference: bf16 x bf16 products (exact in f32)
// summed in f32, then * scale; masked scores are -1e30 (not -inf), so a
// row with no live key ends with m = -1e30, l = 0, acc = 0 (and such a
// split drops out of the merge); p is zeroed where the key is dead and
// rounded to bf16 (round to nearest even) before P V.  The online softmax
// steps once per stage of kKeys keys where the reference steps once per
// pool block, so p is rounded at another running max: acc / l agrees to
// one bf16 rounding of p.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kKeys = 32;          // keys per stage: 4 score n-tiles
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kPad = 8;            // bf16 per smem row past the head dims
constexpr int kSpLd = kKeys + 8;   // floats per row of the score partials
constexpr int kMaxThreads = 512;   // 4 row groups x 4 head-dim slices
constexpr int kMergeThreads = 256;  // >= the largest head dim
constexpr int kMergeBatch = 32;    // splits read at once by the merge
constexpr float kNeg = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  long long sqB, sqS, sqK, sqR;     // q strides (elements); hd stride 1
  const __nv_bfloat16* k_pool;
  const __nv_bfloat16* v_pool;
  const int* tables;
  const int* start;
  const int* fold_base;
  float* m_out;                     // (splits, B, K, NQ)
  float* l_out;
  float* acc_out;                   // (splits, B, K, NQ, hd)
  int B, Sq, K, R, hd, NB, bs, nb, NQ;
  int tile_rows, per, stage_blocks, DG;
  float scale;
};

// Head-dim slices: DG warps per row group, 16 * CH dims each.
__host__ __device__ inline int dim_groups(int hd) {
  return hd <= 64 ? 1 : (hd + 63) / 64;
}
__host__ __device__ inline int dim_chunks(int hd) {   // CH
  const int dg = dim_groups(hd);
  return ((hd + dg - 1) / dg + 15) / 16;
}

using async_copy::smem_addr;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Quad (4 lanes holding one fragment row) reductions: xor butterflies,
// so every lane of the quad ends with the same bits.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int CH>
__global__ void __launch_bounds__(kMaxThreads)
paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DG = p.DG;
  const int RG = p.tile_rows / 16;
  const int hdp = DG * 16 * CH;              // padded head dims
  const int ld = hdp + kPad;                 // smem row stride (bf16)
  const int P = p.stage_blocks;              // pool blocks per stage
  const int bs = p.bs;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kStages * kKeys * ld;
  float* sp = reinterpret_cast<float*>(vs + kStages * kKeys * ld);
  int* ent = reinterpret_cast<int*>(sp + (DG > 1 ? RG * DG * 16 * kSpLd
                                                 : 0));

  const int split = blockIdx.x;
  const int row0 = blockIdx.y * p.tile_rows;
  const int bz = blockIdx.z;
  const int b = bz / p.K, z = bz - b * p.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / DG, dg = warp - rg * DG;
  const int g = lane >> 2, t = lane & 3;
  const int st = p.start[b], fb = p.fold_base[b];
  const int j0 = split * p.per;
  // the split's table entries, loaded with start and fold_base
  for (int k = threadIdx.x; k < min(p.per, p.nb - j0); k += blockDim.x)
    ent[k] = p.tables[(size_t)b * p.nb + j0 + k];

  // this block's logical blocks: the split's range, clipped to the
  // positions some row of the tile can see.  Tile row tr holds query
  // row r * Sq + i with i = tr / R, r = tr % R (i-major: a kv head's R
  // query heads of one position are neighbours).
  const int last = min(row0 + p.tile_rows, p.NQ) - 1;
  const int hi = st + last / p.R;
  const int jlo = max(j0, fb > 0 ? fb / bs : 0);
  const int jhi = hi < 0 ? -1 : min(min(p.nb, j0 + p.per) - 1, hi / bs);
  const int nblk = max(0, jhi - jlo + 1);
  const int nstage = (nblk + P - 1) / P;

  // rows g and g + 8 of this warp's 16
  int lim[2], out_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = row0 + rg * 16 + g + 8 * h;
    const bool ok = tr < p.NQ;
    const int i = ok ? tr / p.R : 0;
    lim[h] = ok ? st + i : -1;                 // positions are >= 0
    out_row[h] = ok ? (tr - i * p.R) * p.Sq + i : -1;
  }
  const int d0 = dg * 16 * CH;                 // this warp's head dims

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[2 * CH][4];
#pragma unroll
  for (int n = 0; n < 2 * CH; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // q fragments (A operand, 16 rows x 16 * CH dims), straight from q
  uint32_t qa[CH][4];
#pragma unroll
  for (int kq = 0; kq < CH; ++kq)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = (h & 1) ? 1 : 0;          // regs 1, 3: row g + 8
      const int d = d0 + 16 * kq + 2 * t + ((h & 2) ? 8 : 0);
      const int tr = row0 + rg * 16 + g + 8 * r;
      uint32_t v = 0;
      if (tr < p.NQ && d < p.hd) {
        const int i = tr / p.R, rr = tr - i * p.R;
        const __nv_bfloat16* qr = p.q + b * p.sqB + i * p.sqS +
                                  z * p.sqK + rr * p.sqR;
        v = *reinterpret_cast<const uint32_t*>(qr + d);
      }
      qa[kq][h] = v;
    }

  if (nstage > 0) {
    const int nthreads = blockDim.x;
    const int* ent_v = ent + (jlo - j0);        // the visible range's
    // zero the pad head dims of every stage and the pad key rows of V
    // (never copied into)
    const int hd = p.hd;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    if (hd < hdp)
      for (int e = threadIdx.x; e < kStages * kKeys * (hdp - hd);
           e += nthreads) {
        const int row = e / (hdp - hd), c = hd + e % (hdp - hd);
        ks[row * ld + c] = zero;
        vs[row * ld + c] = zero;
      }
    const int keys_used = P * bs;
    for (int e = threadIdx.x; e < kStages * (kKeys - keys_used) * hd;
         e += nthreads) {
      const int s = e / ((kKeys - keys_used) * hd);
      const int rem = e - s * (kKeys - keys_used) * hd;
      vs[(s * kKeys + keys_used + rem / hd) * ld + rem % hd] = zero;
    }

    __syncthreads();                             // ent, zeros visible

    const int vec_per_row = hd / 8;              // 16-byte vectors
    const int vec_per_blk = bs * vec_per_row;
    // copy stage s into ring slot s % kStages: live blocks by cp.async,
    // dead blocks (and slots past the range) as zero V rows
    auto issue = [&](int s) {
      __nv_bfloat16* kb = ks + (s % kStages) * kKeys * ld;
      __nv_bfloat16* vb = vs + (s % kStages) * kKeys * ld;
      for (int e = threadIdx.x; e < P * vec_per_blk; e += nthreads) {
        const int u = e / vec_per_blk;
        const int rem = e - u * vec_per_blk;
        const int r = rem / vec_per_row, c = (rem - r * vec_per_row) * 8;
        const int k = s * P + u;
        const int entry = k < nblk ? ent_v[k] : -1;
        const int srow = (u * bs + r) * ld + c;
        if (entry >= 0 && entry < p.NB) {
          const size_t gofs =
              (((size_t)entry * bs + r) * p.K + z) * hd + c;
          async_copy::copy16(kb + srow, p.k_pool + gofs);
          async_copy::copy16(vb + srow, p.v_pool + gofs);
        } else {
          *reinterpret_cast<uint4*>(vb + srow) = make_uint4(0, 0, 0, 0);
        }
      }
    };

    // the columns this thread holds (c = 8 nt + 2 t + e) and the pool
    // block slot of each (P when the column is padding)
    int col_blk[8];
#pragma unroll
    for (int q8 = 0; q8 < 8; ++q8) {
      const int c = 8 * (q8 >> 1) + 2 * t + (q8 & 1);
      col_blk[q8] = c < keys_used ? c / bs : P;
    }

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nstage) issue(s);
      async_copy::commit();
    }
    for (int s = 0; s < nstage; ++s) {
      if (s + kStages - 1 < nstage) issue(s + kStages - 1);
      async_copy::commit();
      async_copy::wait<kStages - 1>();
      __syncthreads();
      const __nv_bfloat16* kb = ks + (s % kStages) * kKeys * ld;
      const __nv_bfloat16* vb = vs + (s % kStages) * kKeys * ld;

      // partial scores over this warp's head dims: 16 rows x 32 keys
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < CH; ++kq)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          const int key = 16 * np + 8 * (lane >> 4) + (lane & 7);
          const int col = d0 + 16 * kq + 8 * ((lane >> 3) & 1);
          ldmatrix_x4(bf, kb + key * ld + col);
          mma16816(sc[2 * np], qa[kq], bf[0], bf[1]);
          mma16816(sc[2 * np + 1], qa[kq], bf[2], bf[3]);
        }
      if (DG > 1) {
        // add the row group's slices in increasing dg: every warp of the
        // group then holds the same scores, bit for bit
        float* mine = sp + ((rg * DG + dg) * 16) * kSpLd;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * t;
          *reinterpret_cast<float2*>(mine + g * kSpLd + c) =
              make_float2(sc[n][0], sc[n][1]);
          *reinterpret_cast<float2*>(mine + (g + 8) * kSpLd + c) =
              make_float2(sc[n][2], sc[n][3]);
        }
        __syncthreads();
        const float* grp = sp + (rg * DG * 16) * kSpLd;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * t;
          float2 lo = *reinterpret_cast<const float2*>(grp + g * kSpLd + c);
          float2 up =
              *reinterpret_cast<const float2*>(grp + (g + 8) * kSpLd + c);
          for (int o = 1; o < DG; ++o) {
            const float* w = grp + o * 16 * kSpLd;
            const float2 a = *reinterpret_cast<const float2*>(
                w + g * kSpLd + c);
            const float2 a8 = *reinterpret_cast<const float2*>(
                w + (g + 8) * kSpLd + c);
            lo.x += a.x; lo.y += a.y; up.x += a8.x; up.y += a8.y;
          }
          sc[n][0] = lo.x; sc[n][1] = lo.y; sc[n][2] = up.x; sc[n][3] = up.y;
        }
      }

      // mask, scale, online softmax per row (f32)
      unsigned live = 0;                         // live block slots
      for (int u = 0; u < P; ++u) {
        const int k = s * P + u;
        const int entry = k < nblk ? ent_v[k] : -1;
        if (entry >= 0 && entry < p.NB) live |= 1u << u;
      }
      const int base = (jlo + s * P) * bs;       // position of column 0
      unsigned ok[2] = {0u, 0u};
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int q8 = 0; q8 < 8; ++q8) {
        const int n = q8 >> 1, e = q8 & 1;
        const int pos = base + 8 * n + 2 * t + e;
        const bool col_ok = col_blk[q8] < P && ((live >> col_blk[q8]) & 1u)
                            && pos >= fb;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool v = col_ok && pos <= lim[h];
          const float x = v ? sc[n][2 * h + e] * p.scale : kNeg;
          sc[n][2 * h + e] = x;
          ok[h] |= (v ? 1u : 0u) << q8;
          mx[h] = fmaxf(mx[h], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_cur = fmaxf(m[h], quad_max(mx[h]));
        corr[h] = expf(m[h] - m_cur);
        float sum = 0.f;
#pragma unroll
        for (int q8 = 0; q8 < 8; ++q8) {
          const int n = q8 >> 1, e = q8 & 1;
          // exp(-1e30 - (-1e30)) == 1 on a dead row: zero p where dead
          const float e_ = ((ok[h] >> q8) & 1u)
                               ? expf(sc[n][2 * h + e] - m_cur) : 0.f;
          sc[n][2 * h + e] = e_;
          sum += e_;
        }
        l[h] = l[h] * corr[h] + quad_sum(sum);
        m[h] = m_cur;
      }
#pragma unroll
      for (int n = 0; n < 2 * CH; ++n) {
        acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
        acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
      }
      // P (bf16) as the A operand: score n-tiles 2kk, 2kk + 1 are the
      // A fragment of keys 16kk .. 16kk + 15
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < CH; ++np) {
          uint32_t bf[4];
          const int key = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int col = d0 + 16 * np + 8 * (lane >> 4);
          ldmatrix_x4_trans(bf, vb + key * ld + col);
          mma16816(acc[2 * np], pa, bf[0], bf[1]);
          mma16816(acc[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
      __syncthreads();                           // ring slot and sp free
    }
    async_copy::wait<0>();
  }

  // this split's partial statistics
  const size_t rows = (size_t)p.B * p.K * p.NQ;
  const size_t first = (size_t)split * rows + (size_t)bz * p.NQ;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (out_row[h] < 0) continue;
    const size_t row = first + out_row[h];
    if (dg == 0 && t == 0) {
      p.m_out[row] = m[h];
      p.l_out[row] = l[h];
    }
    float* arow = p.acc_out + row * p.hd;
#pragma unroll
    for (int n = 0; n < 2 * CH; ++n) {
      const int c = d0 + 8 * n + 2 * t;
      if (c < p.hd)
        *reinterpret_cast<float2*>(arow + c) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// Combine the splits of each row in increasing split order:
// m = max m_s, w_s = exp(m_s - m), l = sum w_s l_s, acc = sum w_s acc_s.
// One block per row.  Each thread requests the first kMergeBatch splits'
// partials of its column before the weights exist; meanwhile warp 0 finds
// m and the weights (into shared memory) and lane 0 sums l.
__global__ void __launch_bounds__(kMergeThreads)
paged_attention_merge_kernel(const float* __restrict__ mp,
                             const float* __restrict__ lp,
                             const float* __restrict__ ap,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ acc_out, int rows, int hd,
                             int splits) {
  extern __shared__ float w[];        // (splits,) weights, then w_s l_s
  float* wl = w + splits;
  const int row = blockIdx.x;
  const int d = threadIdx.x;                    // hd <= kMergeThreads
  float as[kMergeBatch];
#pragma unroll
  for (int j = 0; j < kMergeBatch; ++j)
    as[j] = j < splits && d < hd ? ap[((size_t)j * rows + row) * hd + d]
                                 : 0.f;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = kNeg;
    for (int s = lane; s < splits; s += 32)
      m = fmaxf(m, mp[(size_t)s * rows + row]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    for (int s = lane; s < splits; s += 32) {
      const size_t r = (size_t)s * rows + row;
      w[s] = expf(mp[r] - m);
      wl[s] = w[s] * lp[r];
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int s = 0; s < splits; ++s) l += wl[s];
      m_out[row] = m;
      l_out[row] = l;
    }
  }
  __syncthreads();
  if (d >= hd) return;
  float a = 0.f;
  for (int s0 = 0;; s0 += kMergeBatch) {
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j)
      if (s0 + j < splits) a += w[s0 + j] * as[j];
    if (s0 + kMergeBatch >= splits) break;
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int s = s0 + kMergeBatch + j;
      as[j] = s < splits ? ap[((size_t)s * rows + row) * hd + d] : 0.f;
    }
  }
  acc_out[(size_t)row * hd + d] = a;
}

template <int CH>
int launch_ch(const Params& p, int splits, int tiles, int smem,
              cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(splits, tiles, p.B * p.K);
  const int threads = 32 * (p.tile_rows / 16) * p.DG;
  paged_attention_kernel<CH><<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one launch of the split kernel needs, in bytes (the
// wrapper checks it against the card's limit before launching).
extern "C" int paged_attention_smem_bytes(int hd, int tile_rows, int per) {
  const int dg = dim_groups(hd);
  const int ld = dg * 16 * dim_chunks(hd) + kPad;
  const int kv = 2 * kStages * kKeys * ld * (int)sizeof(__nv_bfloat16);
  const int spb = dg > 1 ? (tile_rows / 16) * dg * 16 * kSpLd * 4 : 0;
  return kv + spb + per * 4;
}

// Launches the split kernel and, for more than one split, the merge, on
// ``stream``; allocates nothing.  With one split the kernel writes
// (m, l, acc) straight into m_out / l_out / acc_out and the scratch
// pointers are unused.  Returns cudaGetLastError() (0 on success) so the
// Python wrapper can raise on a refused launch.
extern "C" int paged_attention_launch(
    const void* q, long long sqB, long long sqS, long long sqK,
    long long sqR, const void* k_pool, const void* v_pool,
    const void* tables, const void* start, const void* fold_base,
    void* m_part, void* l_part, void* acc_part, void* m_out, void* l_out,
    void* acc_out, int B, int Sq, int K, int R, int hd, int NB, int bs,
    int nb, int tile_rows, int tiles, int splits, int per,
    int stage_blocks, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.sqB = sqB; p.sqS = sqS; p.sqK = sqK; p.sqR = sqR;
  p.k_pool = static_cast<const __nv_bfloat16*>(k_pool);
  p.v_pool = static_cast<const __nv_bfloat16*>(v_pool);
  p.tables = static_cast<const int*>(tables);
  p.start = static_cast<const int*>(start);
  p.fold_base = static_cast<const int*>(fold_base);
  const bool merge = splits > 1;
  p.m_out = static_cast<float*>(merge ? m_part : m_out);
  p.l_out = static_cast<float*>(merge ? l_part : l_out);
  p.acc_out = static_cast<float*>(merge ? acc_part : acc_out);
  p.B = B; p.Sq = Sq; p.K = K; p.R = R; p.hd = hd; p.NB = NB; p.bs = bs;
  p.nb = nb; p.NQ = R * Sq; p.tile_rows = tile_rows; p.per = per;
  p.stage_blocks = stage_blocks; p.DG = dim_groups(hd); p.scale = scale;
  if (tile_rows % 16 || tile_rows < 16 || tile_rows > 64 ||
      stage_blocks * bs > kKeys || hd % 8 || hd > 256)
    return (int)cudaErrorInvalidValue;
  const int smem = paged_attention_smem_bytes(hd, tile_rows, per);
  int err;
  switch (dim_chunks(hd)) {
    case 1: err = launch_ch<1>(p, splits, tiles, smem, s); break;
    case 2: err = launch_ch<2>(p, splits, tiles, smem, s); break;
    case 3: err = launch_ch<3>(p, splits, tiles, smem, s); break;
    case 4: err = launch_ch<4>(p, splits, tiles, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || !merge) return err;
  const int rows = B * K * p.NQ;
  paged_attention_merge_kernel<<<rows, kMergeThreads,
                                 2 * splits * sizeof(float), s>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out), rows, hd,
      splits);
  return (int)cudaGetLastError();
}
