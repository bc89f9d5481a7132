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
// because it has no scatter; here the hash's inverse index does the
// bucketing: perm (D, I) lists each row's i in increasing h (a stable
// sort, so increasing i inside a bucket) and offsets (D, J + 1) delimits
// the buckets.  One thread owns one bucket j of kRows rows of x and sums
// its members in increasing i: every output is written once, with no
// zero-fill pass and no atomics, and the result is the same on every run
// (RTPM picks the argmax of candidate lambdas computed from it).  Entries
// with h >= J lie past offsets[J] and contribute nothing.
//   Bound: bytes.  x read once, the index and signs read once, the output
//   written once; one add per element of x and repetition.  The cost of
//   this design is that x is read in permuted order: each 4-byte element
//   costs a 32-byte sector, and rows of x are re-read by every bucket
//   thread of their repetition.  Shared-memory accumulators fed by
//   coalesced x tiles are later work.
//
// unsketch.  out[d, b, i] = s_d(i) * y[d, b, h_d(i)] (y either (D, B, J)
// or one (B, J) shared by every repetition), in y's type.  A gather: one
// thread per (d, b, i), consecutive threads on consecutive i, so the
// tables are read and the output written coalesced and y is read through
// h (one repetition's row of y, at most a few MB, stays in L2).  The sign
// is applied as the plain version applies it, one multiply, so the kernel
// equals it bitwise.  An entry with h outside [0, J) reads 0, as the
// Pallas kernel's one-hot does.
//   Bound: bytes (tables and output dominate).
//
// Every launch function runs on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success); the Python wrapper raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;          // rows of x per count_sketch thread

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

// Block (j tile, row tile, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
count_sketch_kernel(const T* __restrict__ x, const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ offsets,
                    const float* __restrict__ s, T* __restrict__ out, int B,
                    long long I, int J) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= J) return;
  const int d = blockIdx.z;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  const int32_t* pd = perm + (size_t)d * I;
  const float* sd = s + (size_t)d * I;
  const int32_t* od = offsets + (size_t)d * (J + 1);
  const int k1 = od[j + 1];
  const T* xb = x + (size_t)b0 * I;
  float acc[kRows] = {};
  for (int k = od[j]; k < k1; ++k) {
    const int i = pd[k];
    const float sv = sd[i];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nb) acc[r] += sv * widen(xb[(size_t)r * I + i]);
  }
  T* ob = out + ((size_t)d * B + b0) * J + j;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < nb) ob[(size_t)r * J] = narrow<T>(acc[r]);
}

// Block (i tile, b, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
unsketch_kernel(const T* __restrict__ y, long long y_dstride,
                const int32_t* __restrict__ h, const float* __restrict__ s,
                T* __restrict__ out, int B, long long I, int J) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= I) return;
  const int b = blockIdx.y, d = blockIdx.z;
  const int hv = h[(size_t)d * I + i];
  const float sv = s[(size_t)d * I + i];
  const T* yb = y + (size_t)d * y_dstride + (size_t)b * J;
  const float v = (hv >= 0 && hv < J) ? widen(yb[hv]) : 0.0f;
  out[((size_t)d * B + b) * I + i] = narrow<T>(v * sv);
}

}  // namespace

extern "C" int count_sketch_launch(const void* x, int x_bf16,
                                   const void* perm, const void* offsets,
                                   const void* s, void* out, int D, int B,
                                   long long I, int J, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((J + kThreads - 1) / kThreads, (B + kRows - 1) / kRows, D);
  const int32_t* p = static_cast<const int32_t*>(perm);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  const float* sg = static_cast<const float*>(s);
  if (x_bf16)
    count_sketch_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), p, o, sg,
        static_cast<__nv_bfloat16*>(out), B, I, J);
  else
    count_sketch_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), p, o, sg, static_cast<float*>(out), B,
        I, J);
  return (int)cudaGetLastError();
}

extern "C" int unsketch_launch(const void* y, int y_bf16,
                               long long y_dstride, const void* h,
                               const void* s, void* out, int D, int B,
                               long long I, int J, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((I + kThreads - 1) / kThreads), B, D);
  const int32_t* hh = static_cast<const int32_t*>(h);
  const float* sg = static_cast<const float*>(s);
  if (y_bf16)
    unsketch_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), y_dstride, hh, sg,
        static_cast<__nv_bfloat16*>(out), B, I, J);
  else
    unsketch_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(y), y_dstride, hh, sg,
        static_cast<float*>(out), B, I, J);
  return (int)cudaGetLastError();
}
