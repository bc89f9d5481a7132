// Count sketch and its decompress for Hopper (sm_90a): the paper's CS
// apply and the signed lookup of every decompress in core/ and cpd/.
//
// Replaces the TPU kernels src/repro/kernels/count_sketch.py:count_sketch
// (pallas_call of _cs_kernel) and src/repro/kernels/unsketch.py:unsketch
// (_unsketch_kernel).  The plain versions are kernels/ref.py:
// count_sketch_ref and unsketch_ref.  Both kernels take D stacked hash
// rows (h, s) of length I and do every repetition in one launch.
//
// count_sketch.  out[d, b, j] = sum over i with h_d(i) = j of
// s_d(i) * x[b, i], for x (B, I) f32 or bf16, accumulated in f32 and
// written in x's type.  The TPU contracts signed one-hot tiles on the MXU
// because it has no scatter.  Here a block keeps f32 accumulators for a
// slab of JS buckets of R rows and ND repetitions in shared memory, laid
// out [ND][JS][R] so that one entry's R rows are one vector access, and
// streams x through them in tiles of kTile entries:
//   1. x tiles are copied by 16-byte cp.async (8 for bf16), coalesced,
//      into a ring of kStages tiles, so each element of x is read from
//      device memory once for all ND repetitions of the block; h and the
//      link words are loaded two tiles ahead into registers;
//   2. each thread owns 4 entries of the tile and writes their link words
//      (kernels/count_sketch.py:bucket_links, built once with the hash)
//      to shared memory: the offset of the next entry of the tile in the
//      same bucket, whether an earlier one exists, and the sign;
//   3. after a barrier, the first entry of each bucket of the tile sums
//      the bucket's chain in increasing i (x from the ring) and adds the
//      sum into its accumulator once: no two threads touch one bucket, so
//      no atomics, and a thread issues all its loads before its stores.
//      A second barrier ends the tile;
//   4. I is split into P chunks of whole tiles (more blocks when B is
//      small); a chunk's sums go to f32 partials and a second launch adds
//      the P partials in increasing chunk order.  With P = 1 the block
//      writes the output itself.
// So every bucket receives its members tile by tile, each tile's members
// summed in order, and the chunks in order: the order is fixed by the
// hash and the chunking, which the wrapper derives from (B, I, J) and
// never from D, so a launch is bitwise repeatable and each repetition is
// bitwise the same when it is sketched alone (RTPM picks the argmax of
// candidate lambdas computed from these sums).  Buckets past shared
// memory (J beyond ~14,000 at 2 rows and 2 repetitions, ~50,000 at 1 and
// 1) are split into slabs across blocks, each reading the tiles again and
// adding only its slab's chains; small problems are split into slabs
// too, to fill the card.  Entries with h outside [0, J) fall in no slab
// and contribute nothing.  The plain model of this order is
// kernels/ref.py:count_sketch_tiled_ref; the kernel equals it bitwise.
//   Bound: bytes.  x read once, h and the signs read once, the output
//   written once; one add per element of x and repetition.  What remains
//   above it: the P partials (written and read once each), the tables
//   re-read from L2 by each group of R rows (and x by each slab), and the
//   shared-memory adds, whose random buckets cost bank conflicts.
//
// unsketch.  out[d, b, i] = s_d(i) * y[d, b, h_d(i)] (y either (D, B, J)
// or one (B, J) shared by every repetition), in y's type.  A gather: each
// thread takes 4 consecutive i, reads their h and s with one 16-byte load
// each and walks RB rows itself, so the tables are read once for every
// RB rows (all B when I alone fills the card), with the 4 gathers of a
// row in flight together and one 16-byte store (8 for bf16).  When I is
// small the rows split across blocks instead.  Blocks run
// repetition-major, so one repetition's
// row of y (4.8 MB at Fig. 5) stays in L2 while it is gathered; tables
// and output stream past it (evict-first loads and stores).  The sign is
// applied as the plain version applies it, one multiply, so the kernel
// equals it bitwise.  An entry with h outside [0, J) reads 0, as the
// Pallas kernel's one-hot does.  Ragged I and misaligned tensors take
// scalar loads of the same 4 entries.
//   Bound: bytes (tables and output dominate; each gather pulls a 32-byte
//   L2 sector for 4 bytes).
//
// Every launch function runs on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success); the Python wrapper raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 512;             // count_sketch block
constexpr int kPer = 4;                   // entries a thread owns
constexpr int kTile = kThreads * kPer;    // entries a tile (the links')
constexpr int kStages = 3;                // x ring depth
constexpr unsigned kNextMask = 0x7ff;     // link word: next entry's offset,
constexpr unsigned kHasNext = 0x800;      //   valid with this bit,
constexpr unsigned kHasPrev = 0x1000;     //   an earlier entry of the bucket,
constexpr unsigned kSignBit = 0x8000;     //   and s < 0
constexpr int kUThreads = 256;            // unsketch block
constexpr int kUTile = kUThreads * kPer;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Tile offset of a thread's e-th entry: 4 consecutive entries with vector
// loads, else 4 entries a block apart (scalar loads, still coalesced).
template <bool VEC, int NT>
__device__ __forceinline__ int entry(int e) {
  return VEC ? kPer * threadIdx.x + e : threadIdx.x + e * NT;
}

// 4 elements of T from p (16 bytes for f32, 8 for bf16), widened.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[kPer]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
}

// Copies rows b0..b0+R-1 of tile [base, base + kTile) of x into a ring
// slot [R][kTile]; rows past B and entries past I are zero.  Each thread
// copies exactly the entries it later reads, so no barrier is needed.
template <typename T, int R, bool VEC>
__device__ __forceinline__ void stage_x(T* slot, const T* x, int b0, int nb,
                                        long long I, long long base) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T* dst = slot + r * kTile;
    if constexpr (VEC) {
      const long long i = base + kPer * threadIdx.x;
      const bool ok = r < nb && i < I;
      async_copy::copy_or_zero<kPer * sizeof(T)>(
          dst + kPer * threadIdx.x, ok ? x + (size_t)(b0 + r) * I + i : x,
          ok);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int k = entry<false, kThreads>(e);
        const long long i = base + k;
        dst[k] = (r < nb && i < I) ? x[(size_t)(b0 + r) * I + i]
                                   : narrow<T>(0.0f);
      }
    }
  }
}

// The bucket and link word of a thread's entries of one tile, for ND
// repetitions; entries past I get bucket -1 (in no slab).
template <int ND>
struct Tab {
  int h[ND][kPer];
  unsigned m[ND][kPer];
};

template <int ND, bool VEC>
__device__ __forceinline__ void load_tab(Tab<ND>& t, const int32_t* h,
                                         const uint16_t* lk, int d0,
                                         long long I, long long base) {
#pragma unroll
  for (int dd = 0; dd < ND; ++dd) {
    const int32_t* hd = h + (size_t)(d0 + dd) * I;
    const uint16_t* lkd = lk + (size_t)(d0 + dd) * I;
    if constexpr (VEC) {
      const long long i = base + kPer * threadIdx.x;
      int4 q = make_int4(-1, -1, -1, -1);
      uint2 m = make_uint2(0, 0);
      if (i < I) {
        q = __ldg(reinterpret_cast<const int4*>(hd + i));
        m = __ldg(reinterpret_cast<const uint2*>(lkd + i));
      }
      t.h[dd][0] = q.x, t.h[dd][1] = q.y, t.h[dd][2] = q.z, t.h[dd][3] = q.w;
      t.m[dd][0] = m.x & 0xffff, t.m[dd][1] = m.x >> 16;
      t.m[dd][2] = m.y & 0xffff, t.m[dd][3] = m.y >> 16;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const long long i = base + entry<false, kThreads>(e);
        t.h[dd][e] = i < I ? __ldg(hd + i) : -1;
        t.m[dd][e] = i < I ? __ldg(lkd + i) : 0u;
      }
    }
  }
}

// R consecutive floats of shared memory as one vector access.
template <int R>
struct Acc {
  float v[R];
  __device__ __forceinline__ void load(const float* a) {
    if constexpr (R == 1) {
      v[0] = a[0];
    } else if constexpr (R == 2) {
      const float2 t = *reinterpret_cast<const float2*>(a);
      v[0] = t.x, v[1] = t.y;
    } else {
      const float4 t = *reinterpret_cast<const float4*>(a);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    }
  }
  __device__ __forceinline__ void store(float* a) const {
    if constexpr (R == 1)
      a[0] = v[0];
    else if constexpr (R == 2)
      *reinterpret_cast<float2*>(a) = make_float2(v[0], v[1]);
    else
      *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__host__ __device__ constexpr size_t acc_bytes(int nd, int js, int r) {
  return ((size_t)nd * js * r * 4 + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t ring_bytes(int r, int esize) {
  return (size_t)kStages * r * kTile * esize;
}

// Block (row group + RG * (chunk + P * slab), repetition group).  part is
// null when P = 1 (the block writes out); else it is (P, D, B, J) f32.
template <typename T, int R, int ND, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
count_sketch_kernel(const T* __restrict__ x, const int32_t* __restrict__ h,
                    const uint16_t* __restrict__ lk, float* __restrict__ part,
                    T* __restrict__ out, int B, long long I, int J, int JS,
                    int RG, int P, int tpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rg = blockIdx.x % RG;
  const int chunk = (blockIdx.x / RG) % P;
  const int j0 = blockIdx.x / RG / P * JS;
  const int js = min(JS, J - j0);
  const int d0 = blockIdx.y * ND;
  const int b0 = rg * R, nb = min(R, B - b0);
  float* acc = reinterpret_cast<float*>(smem);             // [ND][js][R]
  T* ring = reinterpret_cast<T*>(smem + acc_bytes(ND, JS, R));
  uint16_t* links = reinterpret_cast<uint16_t*>(
      smem + acc_bytes(ND, JS, R) + ring_bytes(R, sizeof(T)));  // [ND][kTile]
  const int nacc = ND * js * R;
  for (int k = kPer * threadIdx.x; k < nacc; k += kPer * kThreads)
    *reinterpret_cast<float4*>(acc + k) = make_float4(0.f, 0.f, 0.f, 0.f);

  const long long tiles = (I + kTile - 1) / kTile;
  const long long t0 = (long long)chunk * tpc;
  const int nt = (int)max(0LL, min((long long)tpc, tiles - t0));
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nt)
      stage_x<T, R, VEC>(ring + k * R * kTile, x, b0, nb, I,
                         (t0 + k) * kTile);
    async_copy::commit();
  }
  // Tables ride three register buffers, each filled two tiles ahead of
  // its use; the loop is unrolled by three so no buffer is copied.
  Tab<ND> ta, tb, tc;
  load_tab<ND, VEC>(ta, h, lk, d0, I, t0 * kTile);
  if (nt > 1) load_tab<ND, VEC>(tb, h, lk, d0, I, (t0 + 1) * kTile);

  auto step = [&](const Tab<ND>& cur, Tab<ND>& fill, int k) {
    if (k + 2 < nt)
      load_tab<ND, VEC>(fill, h, lk, d0, I, (t0 + k + 2) * kTile);
    const int kn = k + kStages - 1;
    if (kn < nt)
      stage_x<T, R, VEC>(ring + (kn % kStages) * R * kTile, x, b0, nb, I,
                         (t0 + kn) * kTile);
    async_copy::commit();
    async_copy::wait<kStages - 1>();                       // tile k landed
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      if constexpr (VEC) {
        *reinterpret_cast<uint2*>(links + dd * kTile + kPer * threadIdx.x) =
            make_uint2(cur.m[dd][0] | cur.m[dd][1] << 16,
                       cur.m[dd][2] | cur.m[dd][3] << 16);
      } else {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          links[dd * kTile + entry<false, kThreads>(e)] = cur.m[dd][e];
      }
    }
    __syncthreads();             // tile k's x and links visible to all
    const T* slot = ring + (k % kStages) * R * kTile;
    float xv[R][kPer];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (VEC) {
        load4<T>(slot + r * kTile + kPer * threadIdx.x, xv[r]);
      } else {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          xv[r][e] = widen(slot[r * kTile + entry<false, kThreads>(e)]);
      }
    }
    // The first entry of each bucket of the tile sums the bucket's chain
    // in increasing i and adds the sum once: the buckets a thread adds
    // into are distinct, so all its loads go before its stores.
    bool act[ND][kPer];
    Acc<R> sum[ND][kPer], a[ND][kPer];
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const unsigned j = (unsigned)cur.h[dd][e] - (unsigned)j0;
        const unsigned w = cur.m[dd][e];
        act[dd][e] = j < (unsigned)js && !(w & kHasPrev);
        if (!act[dd][e]) continue;
#pragma unroll
        for (int r = 0; r < R; ++r)
          sum[dd][e].v[r] = w & kSignBit ? -xv[r][e] : xv[r][e];
        for (unsigned u = w; u & kHasNext;) {
          const unsigned m = u & kNextMask;
          u = links[dd * kTile + m];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xm = widen(slot[r * kTile + m]);
            sum[dd][e].v[r] += u & kSignBit ? -xm : xm;
          }
        }
        a[dd][e].load(acc + ((size_t)dd * js + j) * R);
      }
    }
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (!act[dd][e]) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) a[dd][e].v[r] += sum[dd][e].v[r];
        const unsigned j = (unsigned)cur.h[dd][e] - (unsigned)j0;
        a[dd][e].store(acc + ((size_t)dd * js + j) * R);
      }
    }
    __syncthreads();             // tile k added; its slot and links free
  };
  __syncthreads();                                         // acc zeroed
  for (int k = 0; k < nt; k += 3) {
    step(ta, tc, k);
    if (k + 1 < nt) step(tb, ta, k + 1);
    if (k + 2 < nt) step(tc, tb, k + 2);
  }

  const size_t D = gridDim.y * ND;
#pragma unroll
  for (int dd = 0; dd < ND; ++dd) {
    for (int j = threadIdx.x; j < js; j += kThreads) {
      Acc<R> a;
      a.load(acc + ((size_t)dd * js + j) * R);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nb) break;
        const size_t o = ((size_t)(d0 + dd) * B + b0 + r) * J + j0 + j;
        if (part)
          part[(size_t)chunk * D * B * J + o] = a.v[r];
        else
          out[o] = narrow<T>(a.v[r]);
      }
    }
  }
}

// out[n] = part[0, n] + part[1, n] + ... + part[P - 1, n], left to right.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ part, T* __restrict__ out,
               long long N, int P) {
  const long long n = ((long long)blockIdx.x * 256 + threadIdx.x) * kPer;
  if (n >= N) return;
  if (N % kPer == 0) {
    float4 s = __ldcs(reinterpret_cast<const float4*>(part + n));
    for (int p = 1; p < P; ++p) {
      const float4 q =
          __ldcs(reinterpret_cast<const float4*>(part + (size_t)p * N + n));
      s.x += q.x, s.y += q.y, s.z += q.z, s.w += q.w;
    }
    out[n] = narrow<T>(s.x), out[n + 1] = narrow<T>(s.y);
    out[n + 2] = narrow<T>(s.z), out[n + 3] = narrow<T>(s.w);
  } else {
    for (long long m = n; m < min(N, n + kPer); ++m) {
      float s = part[m];
      for (int p = 1; p < P; ++p) s += part[(size_t)p * N + m];
      out[m] = narrow<T>(s);
    }
  }
}

// Block (i tile, group of RB rows, d): repetition-major.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kUThreads)
unsketch_kernel(const T* __restrict__ y, long long y_dstride,
                const int32_t* __restrict__ h, const float* __restrict__ s,
                T* __restrict__ out, int B, int RB, long long I, int J) {
  const int d = blockIdx.z;
  const long long base = (long long)blockIdx.x * kUTile;
  const int32_t* hd = h + (size_t)d * I;
  const float* sd = s + (size_t)d * I;
  int hv[kPer];
  float sv[kPer];
  if constexpr (VEC) {
    if (base + kPer * threadIdx.x >= I) return;
    const long long i = base + kPer * threadIdx.x;
    const int4 q = __ldcs(reinterpret_cast<const int4*>(hd + i));
    const float4 w = __ldcs(reinterpret_cast<const float4*>(sd + i));
    hv[0] = q.x, hv[1] = q.y, hv[2] = q.z, hv[3] = q.w;
    sv[0] = w.x, sv[1] = w.y, sv[2] = w.z, sv[3] = w.w;
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const long long i = base + entry<false, kUThreads>(e);
      hv[e] = i < I ? hd[i] : -1;
      sv[e] = i < I ? sd[i] : 0.0f;
    }
  }
  const T* yd = y + (size_t)d * y_dstride;
  T* od = out + (size_t)d * B * I;
  const int b1 = min(B, (int)(blockIdx.y + 1) * RB);
#pragma unroll 2
  for (int b = blockIdx.y * RB; b < b1; ++b) {
    const T* yb = yd + (size_t)b * J;
    float v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      v[e] = (unsigned)hv[e] < (unsigned)J ? widen(yb[hv[e]]) : 0.0f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] *= sv[e];
    T* ob = od + (size_t)b * I;
    if constexpr (VEC) {
      const long long i = base + kPer * threadIdx.x;
      if constexpr (sizeof(T) == 4) {
        __stcs(reinterpret_cast<float4*>(ob + i),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        __stcs(reinterpret_cast<uint2*>(ob + i),
               make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                          *reinterpret_cast<const unsigned*>(&hi)));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const long long i = base + entry<false, kUThreads>(e);
        if (i < I) ob[i] = narrow<T>(v[e]);
      }
    }
  }
}

struct CsArgs {
  const void *x, *h, *lk;
  void *part, *out;
  int B;
  long long I;
  int J, JS, RG, P, tpc;
  dim3 grid;
  size_t smem;
};

template <typename T, int R, int ND, bool VEC>
cudaError_t launch_cs(const CsArgs& a, cudaStream_t st) {
  auto kern = count_sketch_kernel<T, R, ND, VEC>;
  static size_t opted_in = 48 << 10;    // per instantiation
  if (a.smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (e != cudaSuccess) return e;
    opted_in = a.smem;
  }
  kern<<<a.grid, kThreads, a.smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const int32_t*>(a.h),
      static_cast<const uint16_t*>(a.lk), static_cast<float*>(a.part),
      static_cast<T*>(a.out), a.B, a.I, a.J, a.JS, a.RG, a.P, a.tpc);
  return cudaGetLastError();
}

template <typename T, int R, int ND>
cudaError_t by_vec(const CsArgs& a, bool vec, cudaStream_t st) {
  return vec ? launch_cs<T, R, ND, true>(a, st)
             : launch_cs<T, R, ND, false>(a, st);
}

template <typename T, int R>
cudaError_t by_nd(const CsArgs& a, int nd, bool vec, cudaStream_t st) {
  if (nd == 1) return by_vec<T, R, 1>(a, vec, st);
  if (nd == 2) return by_vec<T, R, 2>(a, vec, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_rows(const CsArgs& a, int R, int nd, bool vec,
                    cudaStream_t st) {
  if (R == 1) return by_nd<T, 1>(a, nd, vec, st);
  if (R == 2) return by_nd<T, 2>(a, nd, vec, st);
  if (R == 4) return by_nd<T, 4>(a, nd, vec, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The plan (tile, R, nd, JS, nslab, P, tpc) is kernels/count_sketch.py:
// plan's; a tile size other than this build's is refused.
extern "C" int count_sketch_launch(const void* x, int x_bf16, const void* h,
                                   const void* links, void* part, void* out,
                                   int D, int B, long long I, int J, int tile,
                                   int R, int nd, int JS, int nslab, int P,
                                   int tpc, int vec, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (tile != kTile || nd < 1 || D % nd != 0 || R < 1 || JS < 1 || P < 1 ||
      nslab < 1 || tpc < 1 || (P > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  const int RG = (B + R - 1) / R;
  CsArgs a{x, h, links, part, out, B, I, J, JS, RG, P, tpc,
           dim3((unsigned)((long long)RG * P * nslab), D / nd),
           acc_bytes(nd, JS, R) + ring_bytes(R, x_bf16 ? 2 : 4) +
               (size_t)nd * kTile * 2};
  cudaError_t e = x_bf16 ? by_rows<__nv_bfloat16>(a, R, nd, vec != 0, st)
                         : by_rows<float>(a, R, nd, vec != 0, st);
  if (e != cudaSuccess || P == 1) return (int)e;
  const long long N = (long long)D * B * J;
  const unsigned blocks = (unsigned)((N + 256LL * kPer - 1) / (256LL * kPer));
  if (x_bf16)
    combine_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), N,
        P);
  else
    combine_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(out), N, P);
  return (int)cudaGetLastError();
}

// RB rows a thread (B when I alone fills the card, fewer otherwise).
extern "C" int unsketch_launch(const void* y, int y_bf16,
                               long long y_dstride, const void* h,
                               const void* s, void* out, int D, int B,
                               int RB, long long I, int J, int vec,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (RB < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((I + kUTile - 1) / kUTile), (B + RB - 1) / RB,
                  D);
  const int32_t* hh = static_cast<const int32_t*>(h);
  const float* sg = static_cast<const float*>(s);
  if (y_bf16) {
    auto* yy = static_cast<const __nv_bfloat16*>(y);
    auto* oo = static_cast<__nv_bfloat16*>(out);
    if (vec)
      unsketch_kernel<__nv_bfloat16, true><<<grid, kUThreads, 0, st>>>(
          yy, y_dstride, hh, sg, oo, B, RB, I, J);
    else
      unsketch_kernel<__nv_bfloat16, false><<<grid, kUThreads, 0, st>>>(
          yy, y_dstride, hh, sg, oo, B, RB, I, J);
  } else {
    auto* yy = static_cast<const float*>(y);
    auto* oo = static_cast<float*>(out);
    if (vec)
      unsketch_kernel<float, true><<<grid, kUThreads, 0, st>>>(
          yy, y_dstride, hh, sg, oo, B, RB, I, J);
    else
      unsketch_kernel<float, false><<<grid, kUThreads, 0, st>>>(
          yy, y_dstride, hh, sg, oo, B, RB, I, J);
  }
  return (int)cudaGetLastError();
}
