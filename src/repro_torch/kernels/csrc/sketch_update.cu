// Sketched-AdamW moment update and retrieve for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sketch_update.py:
// sketch_update (pallas_calls of _acc_kernel and _ret_kernel).  For one
// flat gradient vector g, given in pieces (element j of a piece at
// ``offset`` is coordinate idx = offset + j), and the leaf's (R, C) f32
// tables it computes
//
//   new_m = b1 * m + (1-b1) * CS(g)        signed count sketch
//   new_v = b2 * v + (1-b2) * CMS(g^2)     count-min
//   m_hat[idx] = median_r  s_r(idx) * new_m[r, h_r(idx)]
//   v_hat[idx] = min_r     new_v[r, h'_r(idx)]
//
// with the bucket and sign hashes of sketch/hashing.py evaluated in
// native uint32 arithmetic (multiply-add mod 2^32, then MurmurHash3
// fmix32; bucket = mix % C, sign = top bit).  The index is carried in 64
// bits and hashed by its low 32 bits: the reference's int32 iota wraps
// the same way, and a yi-9b FFN leaf has 2,164,260,864 > 2^31 elements.
// The plain version is kernels/ref.py:sketch_update_ref.
//
// The TPU has no scatter, so the Pallas kernel contracts signed one-hot
// tiles on the MXU.  Here the natural form has three passes, each one
// launch:
//   1. scale: m *= b1, v *= b2 over the whole tables, in place;
//   2. accumulate: one thread per gradient element (grid-stride), R
//      bucket/sign hashes per table in registers, atomicAdd of
//      (1-b1) * s * g into m and (1-b2) * g^2 into v; once per piece,
//      every piece before any retrieve;
//   3. retrieve: one thread per element, R gathers from each table, the
//      median through the odd-even transposition network of the
//      reference's _median_rows (the middle pair averaged when R is even)
//      and the min for v.
// The tables are updated in place (the JAX version returned new ones);
// g is read in its own type (bf16 or f32) and widened in registers, which
// gives the values of the reference's f32 cast.
//
// What bounds it on this card: bytes.  g is read once (2 or 4 B per
// element), each table read and written once by the scale pass, m_hat and
// v_hat written once (8 B per element); the hashes are ~10 integer ops
// per row and table.  The passes do not reach that bound: the atomics
// and gathers hit random 4-byte words, so each moves a 32-byte sector.
// Fusing the scale into the accumulate, the AdamW step into the
// retrieve, and tiling the scatter through shared memory are later work.
//
// Numerics.  f32 atomics add in an order that changes from run to run,
// and the kernel adds (1-b1)*s*g term by term where the reference scales
// the finished sum, so a table cell differs from the plain version by a
// few f32 ulps of the sum of its terms' magnitudes.  Median and min are
// 1-Lipschitz, so m_hat and v_hat differ by no more than the tables do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride: 16 blocks per SM

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__global__ void __launch_bounds__(kThreads)
scale_kernel(float* __restrict__ m, float* __restrict__ v, int64_t count,
             float b1, float b2) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    m[i] *= b1;
    v[i] *= b2;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const T* __restrict__ g, int64_t n, int64_t offset,
                  float* __restrict__ m, float* __restrict__ v,
                  const uint32_t* __restrict__ cm,
                  const uint32_t* __restrict__ cv, uint32_t C, float a1,
                  float a2) {
  uint32_t c[8 * R];
#pragma unroll
  for (int k = 0; k < 4 * R; ++k) {
    c[k] = __ldg(cm + k);
    c[4 * R + k] = __ldg(cv + k);
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gi = widen(g[i]);
    const float gm = a1 * gi;
    const float gv = a2 * (gi * gi);
    const uint32_t u = (uint32_t)(offset + i);   // low 32 bits
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t bm = mix32(c[4 * r] * u + c[4 * r + 1]) % C;
      const uint32_t neg = mix32(c[4 * r + 2] * u + c[4 * r + 3]) >> 31;
      atomicAdd(m + (size_t)r * C + bm, neg ? -gm : gm);
      const uint32_t bv =
          mix32(c[4 * R + 4 * r] * u + c[4 * R + 4 * r + 1]) % C;
      atomicAdd(v + (size_t)r * C + bv, gv);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
retrieve_kernel(int64_t n, int64_t offset, const float* __restrict__ m,
                const float* __restrict__ v,
                const uint32_t* __restrict__ cm,
                const uint32_t* __restrict__ cv, uint32_t C,
                float* __restrict__ m_hat, float* __restrict__ v_hat) {
  uint32_t c[8 * R];
#pragma unroll
  for (int k = 0; k < 4 * R; ++k) {
    c[k] = __ldg(cm + k);
    c[4 * R + k] = __ldg(cv + k);
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t u = (uint32_t)(offset + i);
    float e[R];
    float w = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t bm = mix32(c[4 * r] * u + c[4 * r + 1]) % C;
      const uint32_t neg = mix32(c[4 * r + 2] * u + c[4 * r + 3]) >> 31;
      const float x = m[(size_t)r * C + bm];
      e[r] = neg ? -x : x;
      const uint32_t bv =
          mix32(c[4 * R + 4 * r] * u + c[4 * R + 4 * r + 1]) % C;
      const float y = v[(size_t)r * C + bv];
      w = r == 0 ? y : fminf(w, y);
    }
    // odd-even transposition network, as _median_rows
#pragma unroll
    for (int p = 0; p < R; ++p) {
#pragma unroll
      for (int j = p % 2; j < R - 1; j += 2) {
        const float lo = fminf(e[j], e[j + 1]);
        const float hi = fmaxf(e[j], e[j + 1]);
        e[j] = lo;
        e[j + 1] = hi;
      }
    }
    if constexpr (R % 2)
      m_hat[i] = e[R / 2];
    else
      m_hat[i] = 0.5f * (e[R / 2 - 1] + e[R / 2]);
    v_hat[i] = w;
  }
}

int blocks_for(int64_t count) {
  const int64_t b = (count + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

// Row counts 1..8 are instantiated (MAX_ROWS in the wrapper).
template <typename T>
int accumulate_rows(const T* g, int64_t n, int64_t offset, float* m,
                    float* v, const uint32_t* cm, const uint32_t* cv,
                    int R, uint32_t C, float a1, float a2,
                    cudaStream_t stream) {
  const int nb = blocks_for(n);
#define SKETCH_ACC_CASE(RR)                                              \
  case RR:                                                               \
    accumulate_kernel<T, RR><<<nb, kThreads, 0, stream>>>(               \
        g, n, offset, m, v, cm, cv, C, a1, a2);                          \
    break;
  switch (R) {
    SKETCH_ACC_CASE(1)
    SKETCH_ACC_CASE(2)
    SKETCH_ACC_CASE(3)
    SKETCH_ACC_CASE(4)
    SKETCH_ACC_CASE(5)
    SKETCH_ACC_CASE(6)
    SKETCH_ACC_CASE(7)
    SKETCH_ACC_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SKETCH_ACC_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1: m *= b1, v *= b2 over ``count`` = R*C entries, in place.
// Each launch function runs on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success) so the Python wrapper can raise on a
// refused launch.
extern "C" int sketch_update_scale_launch(void* m, void* v, long long count,
                                          float b1, float b2,
                                          void* stream) {
  scale_kernel<<<blocks_for(count), kThreads, 0,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(m), static_cast<float*>(v), count, b1, b2);
  return (int)cudaGetLastError();
}

// Pass 2: scatter one piece of n elements at ``offset`` into both
// tables.  ``g_bf16`` selects the piece's type (1: bf16, 0: f32); a1 and
// a2 are 1-b1 and 1-b2.
extern "C" int sketch_update_accumulate_launch(
    const void* g, int g_bf16, long long n, long long offset, void* m,
    void* v, const void* cm, const void* cv, int R, long long C, float a1,
    float a2, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* cmu = static_cast<const uint32_t*>(cm);
  const uint32_t* cvu = static_cast<const uint32_t*>(cv);
  if (g_bf16)
    return accumulate_rows(static_cast<const __nv_bfloat16*>(g), n, offset,
                           static_cast<float*>(m), static_cast<float*>(v),
                           cmu, cvu, R, (uint32_t)C, a1, a2, s);
  return accumulate_rows(static_cast<const float*>(g), n, offset,
                         static_cast<float*>(m), static_cast<float*>(v),
                         cmu, cvu, R, (uint32_t)C, a1, a2, s);
}

// Pass 3: m_hat, v_hat (f32, n) for the piece at ``offset``.
extern "C" int sketch_update_retrieve_launch(
    long long n, long long offset, const void* m, const void* v,
    const void* cm, const void* cv, int R, long long C, void* m_hat,
    void* v_hat, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nb = blocks_for(n);
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  const uint32_t* cmu = static_cast<const uint32_t*>(cm);
  const uint32_t* cvu = static_cast<const uint32_t*>(cv);
  float* mh = static_cast<float*>(m_hat);
  float* vh = static_cast<float*>(v_hat);
#define SKETCH_RET_CASE(RR)                                              \
  case RR:                                                               \
    retrieve_kernel<RR><<<nb, kThreads, 0, s>>>(n, offset, mf, vf, cmu,  \
                                                cvu, (uint32_t)C, mh, vh); \
    break;
  switch (R) {
    SKETCH_RET_CASE(1)
    SKETCH_RET_CASE(2)
    SKETCH_RET_CASE(3)
    SKETCH_RET_CASE(4)
    SKETCH_RET_CASE(5)
    SKETCH_RET_CASE(6)
    SKETCH_RET_CASE(7)
    SKETCH_RET_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SKETCH_RET_CASE
  return (int)cudaGetLastError();
}
