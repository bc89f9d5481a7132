// Flash-decode paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (pallas_call body _attend_block).  It computes the same
// raw f32 online-softmax statistics (m, l, acc) through per-slot block
// tables: query row i of slot b sees key position p iff
// fold_base[b] <= p <= start[b] + i and p's block is live (table entry
// < NB).  The plain version is kernels/ref.py:paged_attention_ref.
//
// What bounds it on this card: bandwidth.  Per layer it must read
// sum_b live_len_b * K * hd * 2 (K and V) * 2 (bytes of bf16) of KV, and
// does ~4 flops per KV element read, far below the ~295 flop/byte ridge
// of an H100.  What the design does about it: each live KV block is read
// from device memory once per (slot, kv head, tile of 8 query rows) into
// shared memory and used by every query row of the tile; blocks that are
// dead (entry >= NB) or hold no visible position for any row of the tile
// (entirely below fold_base or above start + Sq - 1) are never read.
// Skipping them is exactly equivalent to masking them: m_cur == m_prev,
// corr == 1 and p == 0.  Split-K over blocks, cp.async/TMA staging and
// wgmma are left for a later change.
//
// Layout.  One thread block per (tile of 8 query rows, kv head z, slot b);
// one warp per query row.  Rows are the wrapper's (B, K, NQ = R*Sq, hd)
// layout, row n = r*Sq + i.  Lane t of a warp owns head dims t + 32*u.
//
// Numerics follow the reference: bf16 x bf16 products (exact in f32)
// summed in f32, then * scale; masked scores are -1e30 (not -inf), so a
// fully dead row ends with m = -1e30, l = 0, acc = 0; p is zeroed where
// the key is dead and rounded to bf16 before p.v.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // query rows per thread block
constexpr int kMaxLaneDims = 8;   // head dims per lane: hd <= 256

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: float addition is commutative, so every lane ends
  // with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ start,
                       const int* __restrict__ fold_base,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ acc_out, int NQ, int Sq, int K,
                       int hd, int NB, int bs, int nb, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // (bs, hd)
  __nv_bfloat16* vs = ks + bs * hd;                             // (bs, hd)
  float* sc = reinterpret_cast<float*>(vs + bs * hd);          // (kWarps, bs)

  const int b = blockIdx.z;
  const int z = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const bool row_ok = n < NQ;
  const int st = start[b];
  const int fb = fold_base[b];
  const int lim = st + (row_ok ? n % Sq : 0);   // last visible position

  const size_t row = (size_t)(b * K + z) * NQ + (row_ok ? n : 0);
  const __nv_bfloat16* qrow = q + row * hd;
  float qr[kMaxLaneDims];
  float acc[kMaxLaneDims];
#pragma unroll
  for (int u = 0; u < kMaxLaneDims; ++u) {
    const int d = lane + 32 * u;
    qr[u] = (row_ok && d < hd) ? __bfloat162float(qrow[d]) : 0.f;
    acc[u] = 0.f;
  }
  float m = -1e30f;
  float l = 0.f;

  // only blocks that can hold a visible position for some row of the tile
  const int hi = st + Sq - 1;
  const int j0 = fb > 0 ? fb / bs : 0;
  const int j1 = hi < 0 ? -1 : min(nb - 1, hi / bs);
  const int vec_per_row = hd / 8;               // 16-byte vectors per row
  const int nvec = bs * vec_per_row;
  float* srow = sc + warp * bs;

  for (int j = j0; j <= j1; ++j) {
    const int entry = tables[(size_t)b * nb + j];   // uniform in the block
    if (entry < 0 || entry >= NB) continue;          // dead: contributes 0
    __syncthreads();                                 // last tile consumed
    for (int t = threadIdx.x; t < nvec; t += blockDim.x) {
      const int r = t / vec_per_row;
      const int c = t - r * vec_per_row;
      const size_t g = (((size_t)entry * bs + r) * K + z) * hd + c * 8;
      reinterpret_cast<uint4*>(ks)[t] =
          *reinterpret_cast<const uint4*>(k_pool + g);
      reinterpret_cast<uint4*>(vs)[t] =
          *reinterpret_cast<const uint4*>(v_pool + g);
    }
    __syncthreads();
    if (!row_ok) continue;

    float mx = -1e30f;
    for (int kk = 0; kk < bs; ++kk) {
      const __nv_bfloat16* kr = ks + kk * hd;
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxLaneDims; ++u) {
        const int d = lane + 32 * u;
        if (d < hd) part = fmaf(qr[u], __bfloat162float(kr[d]), part);
      }
      float s = warp_sum(part) * scale;
      const int p = j * bs + kk;
      s = (p <= lim && p >= fb) ? s : -1e30f;
      mx = fmaxf(mx, s);
      if (lane == 0) srow[kk] = s;
    }
    __syncwarp();
    const float m_cur = fmaxf(m, mx);
    const float corr = expf(m - m_cur);
    float psum = 0.f;
    float pv[kMaxLaneDims];
#pragma unroll
    for (int u = 0; u < kMaxLaneDims; ++u) pv[u] = 0.f;
    for (int kk = 0; kk < bs; ++kk) {
      const int p = j * bs + kk;
      // exp(-1e30 - (-1e30)) == 1 on a dead row: zero p where dead
      const float e = (p <= lim && p >= fb) ? expf(srow[kk] - m_cur) : 0.f;
      psum += e;
      const float pb = __bfloat162float(__float2bfloat16(e));
      const __nv_bfloat16* vr = vs + kk * hd;
#pragma unroll
      for (int u = 0; u < kMaxLaneDims; ++u) {
        const int d = lane + 32 * u;
        if (d < hd) pv[u] = fmaf(pb, __bfloat162float(vr[d]), pv[u]);
      }
    }
    __syncwarp();                                    // srow reused next j
    l = l * corr + psum;
#pragma unroll
    for (int u = 0; u < kMaxLaneDims; ++u) acc[u] = acc[u] * corr + pv[u];
    m = m_cur;
  }

  if (!row_ok) return;
  if (lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
  float* arow = acc_out + row * hd;
#pragma unroll
  for (int u = 0; u < kMaxLaneDims; ++u) {
    const int d = lane + 32 * u;
    if (d < hd) arow[d] = acc[u];
  }
}

}  // namespace

// Shared memory one launch needs, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" int paged_attention_smem_bytes(int hd, int bs) {
  return 2 * bs * hd * (int)sizeof(__nv_bfloat16) + kWarps * bs * 4;
}

// Launches on ``stream``; allocates nothing.  Returns cudaGetLastError()
// (0 on success) so the Python wrapper can raise on a refused launch.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* start, const void* fold_base,
    void* m_out, void* l_out, void* acc_out, int B, int NQ, int Sq, int K,
    int hd, int NB, int bs, int nb, float scale, void* stream) {
  const int smem = paged_attention_smem_bytes(hd, bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((NQ + kWarps - 1) / kWarps, K, B);
  paged_attention_kernel<<<grid, kWarps * 32, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(start),
      static_cast<const int*>(fold_base), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out), NQ, Sq, K,
      hd, NB, bs, nb, scale);
  return (int)cudaGetLastError();
}
