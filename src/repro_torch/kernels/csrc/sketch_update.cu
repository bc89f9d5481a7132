// Sketched-AdamW moment update, retrieve and AdamW step for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sketch_update.py:
// sketch_update (pallas_calls of _acc_kernel and _ret_kernel).  For one
// leaf's flat gradient vector g, given in pieces (element j of a piece at
// ``offset`` is coordinate idx = offset + j), and the leaf's (R, C) f32
// tables it computes
//
//   new_m = b1 * m + (1-b1) * CS(g)        signed count sketch
//   new_v = b2 * v + (1-b2) * CMS(g^2)     count-min
//   m_hat[idx] = median_r  s_r(idx) * new_m[r, h_r(idx)]
//   v_hat[idx] = min_r     new_v[r, h'_r(idx)]
//
// and, in the fused form, the AdamW step of the leaf's params from those
// estimates.  A piece may also be strided: element j of a piece with
// ``row`` > 0 is coordinate idx = offset + (j / row) * stride + j % row
// (the local block of a parameter split along one dim: rows of ``row``
// elements, ``stride`` apart in the flat leaf), so one rank's shard of a
// sharded leaf is one piece whatever dim the split takes.  Bucket and sign hashes are those of sketch/hashing.py in
// native uint32 arithmetic (csrc/hashing.cuh).  The index is carried in
// 64 bits and hashed by its low 32 bits: the reference's int32 iota wraps
// the same way, and a yi-9b FFN leaf has 2,164,260,864 > 2^31 elements.
// The plain versions are kernels/ref.py:sketch_accumulate_ref,
// sketch_retrieve_ref and sketched_leaf_update.
//
// What bounds it on this card.  A yi-9b FFN leaf's table row holds
// 180,355,072 f32 (720 MB), far past the 50 MB L2, and every element
// touches 2R random cells of the tables twice (add, then read back).  A
// random 4-byte access moves a 32-byte sector each way, so adding into
// the tables where the element's hash points (one atomic per cell) costs
// about 16x the bytes of the tables themselves.  The accumulate therefore
// partitions the additions by bucket range instead (a bucket sort whose
// buckets are table slabs):
//
//   The 2R table rows (m rows 0..R-1, then v rows) are cut into slabs of
//   kSlab = 2^15 cells (128 KB, one block's shared memory); slab s of row
//   t is bin t * NS + s.  The pieces are processed in groups whose
//   entries fit the wrapper's work space (4 GiB: a yi-9b FFN leaf is 13
//   groups of ~3.7 layers), five launches a group:
//     1. count:   one block per (tile of a piece, table row) hashes the
//                 tile's indices and counts its entries per bin in shared
//                 memory, then writes its row of counts (the counts do not
//                 depend on g);
//     2. scan:    per bin, the counts over tiles become each tile's start
//                 within the bin, and the bin's total;
//     3. offsets: one block scans the totals into each bin's start;
//     4. scatter: one block per (tile, row, window of kWindow slabs)
//                 hashes the tile again, keeps the entries of its window
//                 (the cell's 15-bit offset in its slab, the sign, and g
//                 as bf16 bits: 4 bytes; 8 with an f32 g), places them in
//                 shared memory slab by slab, and copies each slab's run
//                 to the tile's range of the bin, a warp a run.  Each warp
//                 takes a contiguous share of the tile and counts its
//                 entries per slab first (warps match equal slabs with
//                 __match_any_sync), so a scan over the warps gives each
//                 warp's place in each run and a popcount each entry's
//                 place among its warp's: a run holds the tile's entries
//                 of the slab in element order, with no atomic.  Device
//                 memory then sees runs of tile / NS entries rather than
//                 scattered 4-byte stores, which cost a DRAM
//                 read-modify-write of a sector each; the window bounds
//                 the runs a block stages (the wrapper sizes the tile to
//                 fill the staging);
//     5. slab:    one block per bin reads its slab into shared memory
//                 once (scaling it by b1 or b2 in the first group), adds
//                 the bin's entries there ((1-b1) * s * g or (1-b2) * g^2
//                 formed in f32, as the per-element kernel did) and
//                 writes the slab back once.  The entries are taken a
//                 block's width at a time; within such a chunk the
//                 entries that share a cell are added in entry order, in
//                 rounds: each pending entry bids for its cell's owner
//                 slot (a 2^14-slot table hashed by the cell's offset)
//                 with atomicMin of a key that falls from round to round,
//                 and the lowest bidder of each slot adds its term with a
//                 plain store.  About one entry a cell at yi-9b's bins:
//                 two or three rounds a chunk.
//   Device-memory traffic per group: the tables read and written once,
//   the entries written and read once, g read once per window (mostly
//   from L2: a tile's windows are neighbouring blocks).
//
//   The order of additions.  A bin's entries are the group's in (tile,
//   element) order, which is the leaf's element order, groups in order,
//   pieces in order within a group; each cell receives its terms in that
//   order, one at a time.  So every cell of a table is
//     (((b * m) + t_0) + t_1) + ...,  t in the leaf's element order,
//   whatever the grouping, the tile, the number of SMs or the timing: two
//   launches agree bitwise, and kernels/ref.py:sketch_accumulate_ordered_ref
//   adds in the same order.
//
// The retrieve (estimates form) and the fused apply gather 2R random
// cells an element; that stays random by nature.  Each thread takes
// kPerThread elements, a block width apart (coalesced), and issues all
// their 2R * kPerThread loads before any median, so many sectors are in
// flight.  The apply then runs sketched_leaf_update's f32 arithmetic in
// its operation order, with the intrinsics that round each operation once
// (no contraction into fma):
//   mh = m_hat * (1/bc1)         (PyTorch divides a CUDA tensor by a
//   vh = max(v_hat, 0) * (1/bc2)  Python float as a multiply by its f32
//   d  = mh / (sqrt(vh) + eps) + wd * p        reciprocal)
//   p  = round_to_p_type(p - lr * d)
// and writes p in place: m_hat and v_hat never reach memory.
//
// Numerics.  The slab adds each scaled term into the scaled table where
// the plain version (sketch_accumulate_ref) scales the finished sum, and
// adds a cell's terms one at a time in element order where the plain
// version adds them in its own order: a cell differs from the plain
// version by a few f32 ulps of the sum of its terms' magnitudes, and
// equals the ordered model bitwise (each operation rounded once: the
// intrinsics keep the compiler from contracting into fma).  Median and min
// are 1-Lipschitz, so estimates differ by no more than the tables do; given
// equal tables the apply computes the plain path's operations on the card
// in the same order.
//
// Every launch function runs on ``stream``, allocates nothing and returns
// cudaGetLastError() (0 on success); the Python wrapper raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr int kThreads = 256;          // retrieve and apply blocks
constexpr int kPerThread = 4;          // elements a retrieve / apply thread
constexpr int kMaxBlocks = 132 * 16;   // grid-stride: 16 blocks per SM
constexpr int kSlabBits = 15;
constexpr int kSlab = 1 << kSlabBits;  // cells a slab (128 KB of f32)
constexpr int kWindow = 1024;          // slabs a scatter block writes into
constexpr int kStageBytes = 37 * 4096;  // a scatter block's staging
constexpr int kBinThreads = 1024;      // count, scatter and slab blocks
constexpr int kWarps = kBinThreads / 32;
constexpr int kMaxBinsPerRow = 1 << 15;  // 128 KB of shared counters
constexpr int kMaxSegs = 64;           // pieces a launch
constexpr int kOwnerBits = 14;         // a slab block's owner slots
constexpr int kOwner = 1 << kOwnerBits;
constexpr int kRounds = kBinThreads + 1;  // bound on a chunk's rounds
constexpr uint32_t kNone = 0xffffffffu;   // an element outside the window
// a scatter block's per-warp slab table: 16-bit beside the staging, or
// 32-bit over it when the window's entries go straight to device memory
constexpr int kWarpTable16 = kWarps * kWindow * 2;
static_assert(kWindow <= kBinThreads, "one thread a slab of the window");
static_assert(kBinThreads <= 1024, "a slab key's thread fits 10 bits");
static_assert(kStageBytes / 4 < 65536, "staged places fit 16 bits");
static_assert(kStageBytes >= kWarps * kWindow * 4,
              "the 32-bit warp table fits the staging");

// The pieces of one launch, passed by value: segment k has n[k] elements
// at ``data[k]`` (g, or the params for the apply), elements first[k] ..
// first[k] + n[k] - 1 of a piece at offset[k] whose rows are row[k]
// elements stride[k] apart (row 0: contiguous); for count and scatter its
// tiles of ``tile`` elements are [tile0[k], tile0[k + 1]).
struct Segs {
  const void* data[kMaxSegs];
  long long offset[kMaxSegs];
  long long n[kMaxSegs];
  long long first[kMaxSegs];
  long long row[kMaxSegs];
  long long stride[kMaxSegs];
  long long tile0[kMaxSegs + 1];
  long long tile;
  int count;
};
static_assert(sizeof(Segs) <= 4096, "kernel parameters fit 4 KB");

// The coordinate of a segment's element i, hashed by its low 32 bits: a
// strided piece's row division by the invariant ``row`` (a piece of a
// strided segment has fewer than 2^32 elements, checked by the wrapper).
struct Coord {
  long long base, stride;
  uint32_t first;
  bool strided;
  sketch::Divisor row;
  __device__ __forceinline__ Coord(long long offset, long long first_,
                                   long long row_len, long long stride_)
      : base(offset), stride(stride_), first(0), strided(row_len > 0) {
    if (strided) {
      row = sketch::make_divisor((uint32_t)row_len);
      first = (uint32_t)first_;
    } else {
      base += first_;
    }
  }
  __device__ __forceinline__ Coord(const Segs& s, int k)
      : Coord(s.offset[k], s.first[k], s.row[k], s.stride[k]) {}
  __device__ __forceinline__ uint32_t operator()(long long i) const {
    if (!strided) return (uint32_t)(base + i);
    const uint32_t j = first + (uint32_t)i;
    const uint32_t q = sketch::quotient(j, row);
    return (uint32_t)(base + (long long)q * stride + (j - q * row.d));
  }
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A bin entry: the cell's offset in its slab, the sign and g.  bf16 g:
// (offset << 17) | (negative << 16) | bf16 bits.  f32 g: x = (offset << 1)
// | negative, y = the f32 bits.
template <typename T>
struct Entry;
template <>
struct Entry<__nv_bfloat16> {
  using type = uint32_t;
  __device__ static type make(uint32_t off, bool neg, __nv_bfloat16 g) {
    return (off << 17) | ((uint32_t)neg << 16) |
           (uint32_t)__bfloat16_as_ushort(g);
  }
  __device__ static void read(type e, uint32_t& off, bool& neg, float& g) {
    off = e >> 17;
    neg = (e >> 16) & 1u;
    g = __bfloat162float(__ushort_as_bfloat16((unsigned short)(e & 0xffffu)));
  }
};
template <>
struct Entry<float> {
  using type = uint2;
  __device__ static type make(uint32_t off, bool neg, float g) {
    return make_uint2((off << 1) | (uint32_t)neg, __float_as_uint(g));
  }
  __device__ static void read(type e, uint32_t& off, bool& neg, float& g) {
    off = e.x >> 1;
    neg = e.x & 1u;
    g = __uint_as_float(e.y);
  }
};

// The block's piece and element range [i0, i1) of count / scatter.
__device__ __forceinline__ int tile_of(const Segs& segs, long long tile,
                                       long long& i0, long long& i1) {
  int k = 0;
  while (k + 1 < segs.count && segs.tile0[k + 1] <= tile) ++k;
  i0 = (tile - segs.tile0[k]) * segs.tile;
  i1 = min(i0 + segs.tile, segs.n[k]);
  return k;
}

// The hash of table row t (m rows, then v rows) in registers: bucket
// coefficients, and for an m row the sign's.
struct RowHash {
  uint32_t a, b, as, bs;
  bool is_m;
  __device__ __forceinline__ RowHash(const uint32_t* __restrict__ cm,
                                     const uint32_t* __restrict__ cv, int R,
                                     int t)
      : is_m(t < R) {
    const uint32_t* c = is_m ? cm + 4 * t : cv + 4 * (t - R);
    a = c[0];
    b = c[1];
    as = c[2];
    bs = c[3];
  }
  __device__ __forceinline__ uint32_t bucket(uint32_t u,
                                             const sketch::Divisor& C,
                                             bool& neg) const {
    neg = is_m && sketch::negative(as, bs, u);
    return sketch::bucket(a, b, u, C);
  }
};

// Pass 1.  Block (tile, t): counts of the tile's entries per slab of
// table row t -> counts[tile * NB + t * NS + s], NB = 2 R NS.
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(Segs segs, const uint32_t* __restrict__ cm,
                 const uint32_t* __restrict__ cv, int R, sketch::Divisor C,
                 int NS, uint32_t* __restrict__ counts) {
  extern __shared__ uint32_t hist[];
  const long long tile = blockIdx.x;
  const int t = blockIdx.y;
  const RowHash h(cm, cv, R, t);
  for (int s = threadIdx.x; s < NS; s += kBinThreads) hist[s] = 0;
  __syncthreads();
  long long i0, i1;
  const int k = tile_of(segs, tile, i0, i1);
  const Coord at(segs, k);
  for (long long i = i0 + threadIdx.x; i < i1; i += kBinThreads) {
    const uint32_t b = sketch::bucket(h.a, h.b, at(i), C);
    atomicAdd(&hist[b >> kSlabBits], 1u);
  }
  __syncthreads();
  uint32_t* out = counts + tile * (2LL * R * NS) + (long long)t * NS;
  for (int s = threadIdx.x; s < NS; s += kBinThreads) out[s] = hist[s];
}

// Pass 2.  One thread per bin: counts over the tiles become each tile's
// exclusive start within the bin, and total[bin] the bin's size.  Eight
// tiles' counts are loaded before any is rewritten.
__global__ void bin_scan_kernel(uint32_t* __restrict__ counts, long long NB,
                                long long tiles,
                                uint32_t* __restrict__ total) {
  const long long bin = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (bin >= NB) return;
  uint32_t run = 0;
  for (long long j = 0; j < tiles; j += 8) {
    uint32_t c[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      c[q] = j + q < tiles ? counts[(j + q) * NB + bin] : 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (j + q < tiles) counts[(j + q) * NB + bin] = run;
      run += c[q];
    }
  }
  total[bin] = run;
}

// Pass 3.  One block: start[bin] = sum of total[< bin], start[NB] = all.
__global__ void __launch_bounds__(kBinThreads)
bin_offsets_kernel(const uint32_t* __restrict__ total, int NB,
                   uint32_t* __restrict__ start) {
  __shared__ uint32_t part[kBinThreads];
  const int per = (NB + kBinThreads - 1) / kBinThreads;
  const int b0 = min(NB, threadIdx.x * per), b1 = min(NB, b0 + per);
  uint32_t sum = 0;
  for (int b = b0; b < b1; ++b) sum += total[b];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int d = 1; d < kBinThreads; d <<= 1) {   // inclusive scan
    const uint32_t x = threadIdx.x >= d ? part[threadIdx.x - d] : 0u;
    __syncthreads();
    part[threadIdx.x] += x;
    __syncthreads();
  }
  uint32_t run = part[threadIdx.x] - sum;
  for (int b = b0; b < b1; ++b) {
    start[b] = run;
    run += total[b];
  }
  if (threadIdx.x == kBinThreads - 1) start[NB] = part[kBinThreads - 1];
}

// Pass 4.  Block (window w + tile * windows, t): the tile's entries of
// row t that fall in the slabs [w kWindow, (w+1) kWindow), into their
// bins' ranges for this tile, in element order.  Warp j takes the j-th
// contiguous share of the tile, 32 elements at a time.  It first counts
// its entries per slab (lanes of one slab found by __match_any_sync, the
// lowest adding their number) into its row of a per-warp table; a scan
// over the warps turns the table into each warp's first place in each
// slab's run; a second walk places every entry at its warp's place plus
// its rank among the lanes of its slab, and the lowest such lane moves
// the warp's place on.  The entries are first placed in shared memory,
// each slab's run together (the tile's count of a slab is the difference
// of two of pass 2's starts), then every run is copied to its range by
// one warp, so device memory sees contiguous runs of tile / NS entries
// rather than scattered 4-byte stores.  A window whose entries exceed the
// staging room (never at the shapes of the main path) writes them
// straight to their ranges, its warp table in 32 bits over the staging.
// The window bounds the runs a block holds.
struct WarpTable {
  unsigned char* base;
  bool wide;
  __device__ __forceinline__ uint32_t get(int q) const {
    return wide ? reinterpret_cast<const uint32_t*>(base)[q]
                : reinterpret_cast<const uint16_t*>(base)[q];
  }
  __device__ __forceinline__ void set(int q, uint32_t x) const {
    if (wide)
      reinterpret_cast<uint32_t*>(base)[q] = x;
    else
      reinterpret_cast<uint16_t*>(base)[q] = (uint16_t)x;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(Segs segs, const uint32_t* __restrict__ cm,
                   const uint32_t* __restrict__ cv, int R,
                   sketch::Divisor C, int NS, long long tiles,
                   const uint32_t* __restrict__ counts,
                   const uint32_t* __restrict__ total,
                   const uint32_t* __restrict__ start,
                   typename Entry<T>::type* __restrict__ ws) {
  using E = typename Entry<T>::type;
  constexpr int kCap = kStageBytes / (int)sizeof(E);
  __shared__ uint32_t run0[kWindow];     // a run's first staging slot
  __shared__ uint32_t dest[kWindow];     // a run's first device slot
  __shared__ uint32_t len[kWindow];      // the tile's entries of a slab
  __shared__ uint32_t part[kWarps];
  extern __shared__ __align__(16) unsigned char smem[];
  E* stage = reinterpret_cast<E*>(smem);
  const int windows = (NS + kWindow - 1) / kWindow;
  const long long tile = blockIdx.x / windows;
  const int s0 = (int)(blockIdx.x % windows) * kWindow;
  const int t = blockIdx.y;
  const int ns = min(kWindow, NS - s0);
  const RowHash h(cm, cv, R, t);
  const long long NB = 2LL * R * NS;
  const long long b0 = (long long)t * NS + s0;
  // this tile's count of each slab of the window, and an exclusive scan
  // of the counts over the window (kWindow <= kBinThreads)
  uint32_t cnt = 0;
  const int sl = threadIdx.x;
  if (sl < ns) {
    const uint32_t here = counts[tile * NB + b0 + sl];
    const uint32_t next = tile + 1 < tiles ? counts[(tile + 1) * NB + b0 + sl]
                                           : total[b0 + sl];
    cnt = next - here;
    dest[sl] = start[b0 + sl] + here;
  }
  uint32_t x = cnt;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t y = lane < kWarps ? part[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t z = __shfl_up_sync(0xffffffffu, y, d);
      if (lane >= d) y += z;
    }
    part[lane] = y;                      // inclusive over warps
  }
  __syncthreads();
  const uint32_t excl = x - cnt + (warp ? part[warp - 1] : 0u);
  const uint32_t room = part[kWarps - 1];
  const bool staged = room <= (uint32_t)kCap;
  if (sl < ns) {
    run0[sl] = excl;
    len[sl] = cnt;
  }
  const WarpTable tab{staged ? smem + kStageBytes : smem, !staged};
  for (int q = threadIdx.x; q < kWarps * kWindow; q += kBinThreads)
    tab.set(q, 0u);
  __syncthreads();
  long long i0, i1;
  const int k = tile_of(segs, tile, i0, i1);
  const T* g = static_cast<const T*>(segs.data[k]);
  const Coord at(segs, k);
  const long long per = ((i1 - i0 + kWarps - 1) / kWarps + 31) / 32 * 32;
  const long long w0 = i0 + warp * per, w1 = min(i1, w0 + per);
  const int row = warp * kWindow;
  // the warp's count of each slab
  for (long long base = w0; base < w1; base += 32) {
    const long long i = base + lane;
    uint32_t key = kNone;
    if (i < w1) {
      const int w = (int)(sketch::bucket(h.a, h.b, at(i), C) >> kSlabBits) -
                    s0;
      if (w >= 0 && w < ns) key = (uint32_t)w;
    }
    const uint32_t peers = __match_any_sync(0xffffffffu, key);
    if (key != kNone && lane == __ffs(peers) - 1)
      tab.set(row + key, tab.get(row + key) + __popc(peers));
  }
  __syncthreads();
  // each warp's first place in each slab's run, relative to the run
  if (sl < ns) {
    uint32_t run = 0;
    for (int j = 0; j < kWarps; ++j) {
      const uint32_t c = tab.get(j * kWindow + sl);
      tab.set(j * kWindow + sl, run);
      run += c;
    }
  }
  __syncthreads();
  const uint32_t below = (1u << lane) - 1u;
  for (long long base = w0; base < w1; base += 32) {
    const long long i = base + lane;
    uint32_t key = kNone, b = 0;
    bool neg = false;
    if (i < w1) {
      b = h.bucket(at(i), C, neg);
      const int w = (int)(b >> kSlabBits) - s0;
      if (w >= 0 && w < ns) key = (uint32_t)w;
    }
    const uint32_t peers = __match_any_sync(0xffffffffu, key);
    const uint32_t place = key != kNone ? tab.get(row + key) : 0u;
    __syncwarp();
    if (key != kNone) {
      const uint32_t rank = __popc(peers & below);
      const uint32_t pos = (staged ? run0[key] : dest[key]) + place + rank;
      const E e = Entry<T>::make(b & (kSlab - 1), neg, g[i]);
      if (staged)
        stage[pos] = e;
      else
        ws[pos] = e;
      if (rank == 0) tab.set(row + key, place + __popc(peers));
    }
    __syncwarp();
  }
  if (!staged) return;
  __syncthreads();
  for (int r = warp; r < ns; r += kWarps) {
    const uint32_t a = run0[r], n = len[r], d = dest[r];
    for (uint32_t j = lane; j < n; j += 32) ws[d + j] = stage[a + j];
  }
}

// Pass 5.  Block per bin (t, s): the slab's cells into shared memory
// (scaled by b in the first group), the bin's entries added there in
// entry order, the slab written back.  A chunk of kBinThreads entries at a
// time; in each round every pending entry bids for its owner slot (cell
// offset mod kOwner) with a key that is lower than any of the earlier
// rounds' and, within the round, lower for a lower thread; the slot's
// lowest bidder adds its term (the only store to its cell this round) and
// is done.  Entries of one cell share a slot, so a cell receives its terms
// in entry order; the slots are reset after the chunk.  16-byte loads and
// stores when C is a multiple of 4.
template <typename T>
__global__ void __launch_bounds__(kBinThreads)
slab_add_kernel(float* __restrict__ m, float* __restrict__ v, int R,
                uint32_t C, int NS, const uint32_t* __restrict__ start,
                const typename Entry<T>::type* __restrict__ ws, float b1,
                float b2, float a1, float a2, int scale) {
  extern __shared__ __align__(16) float slab[];
  uint32_t* owner = reinterpret_cast<uint32_t*>(slab + kSlab);
  const int bin = blockIdx.x;
  const int t = bin / NS, s = bin - t * NS;
  const bool is_m = t < R;
  float* row = is_m ? m + (size_t)t * C : v + (size_t)(t - R) * C;
  const long long c0 = (long long)s * kSlab;
  const int cells = (int)min((long long)kSlab, (long long)C - c0);
  const float b = is_m ? b1 : b2, a = is_m ? a1 : a2;
  const bool vec = C % 4 == 0;
  const int nvec = vec ? cells / 4 : 0;
  float4* slab4 = reinterpret_cast<float4*>(slab);
  const float4* row4 = reinterpret_cast<const float4*>(row + c0);
  for (int c = threadIdx.x; c < kOwner; c += kBinThreads) owner[c] = kNone;
  for (int c = threadIdx.x; c < nvec; c += kBinThreads) {
    float4 x = row4[c];
    if (scale) {
      x.x = __fmul_rn(x.x, b);
      x.y = __fmul_rn(x.y, b);
      x.z = __fmul_rn(x.z, b);
      x.w = __fmul_rn(x.w, b);
    }
    slab4[c] = x;
  }
  for (int c = 4 * nvec + threadIdx.x; c < cells; c += kBinThreads) {
    const float x = row[c0 + c];
    slab[c] = scale ? __fmul_rn(x, b) : x;
  }
  __syncthreads();
  const uint32_t e1 = start[bin + 1];
  for (uint32_t j0 = start[bin]; j0 < e1; j0 += kBinThreads) {
    const uint32_t j = j0 + threadIdx.x;
    const bool live = j < e1;
    bool pending = live;
    uint32_t off = 0;
    float add = 0.0f;
    if (live) {
      bool neg;
      float gi;
      Entry<T>::read(ws[j], off, neg, gi);
      if (is_m) {
        const float gm = __fmul_rn(a, gi);
        add = neg ? -gm : gm;
      } else {
        add = __fmul_rn(a, __fmul_rn(gi, gi));
      }
    }
    uint32_t* slot = owner + (off & (kOwner - 1));
    for (uint32_t r = 0; __syncthreads_or(pending); ++r) {
      const uint32_t key = ((kRounds - r) << 10) | threadIdx.x;
      if (pending) atomicMin(slot, key);
      __syncthreads();
      if (pending && *slot == key) {
        slab[off] = __fadd_rn(slab[off], add);
        pending = false;
      }
    }
    if (live) *slot = kNone;
  }
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(row + c0);
  for (int c = threadIdx.x; c < nvec; c += kBinThreads) out4[c] = slab4[c];
  for (int c = 4 * nvec + threadIdx.x; c < cells; c += kBinThreads)
    row[c0 + c] = slab[c];
}

// The coefficients of both tables in registers.
template <int R>
struct Coeffs {
  uint32_t c[8 * R];
  __device__ __forceinline__ Coeffs(const uint32_t* __restrict__ cm,
                                    const uint32_t* __restrict__ cv) {
#pragma unroll
    for (int k = 0; k < 4 * R; ++k) {
      c[k] = __ldg(cm + k);
      c[4 * R + k] = __ldg(cv + k);
    }
  }
};

// m_hat and v_hat of kPerThread indices u[e]: every gather issued before
// any median.
template <int R>
__device__ __forceinline__ void estimates(
    const Coeffs<R>& k, const uint32_t (&u)[kPerThread],
    const bool (&live)[kPerThread], const float* __restrict__ m,
    const float* __restrict__ v, const sketch::Divisor& C,
    float (&mh)[kPerThread],
    float (&vh)[kPerThread]) {
  float x[kPerThread][R], y[kPerThread][R];
  bool neg[kPerThread][R];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t bm = sketch::bucket(k.c[4 * r], k.c[4 * r + 1], u[e], C);
      neg[e][r] = sketch::negative(k.c[4 * r + 2], k.c[4 * r + 3], u[e]);
      const uint32_t bv =
          sketch::bucket(k.c[4 * R + 4 * r], k.c[4 * R + 4 * r + 1], u[e], C);
      x[e][r] = live[e] ? m[(size_t)r * C.d + bm] : 0.0f;
      y[e][r] = live[e] ? v[(size_t)r * C.d + bv] : 0.0f;
    }
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    float w = y[e][0];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[e][r] = neg[e][r] ? -x[e][r] : x[e][r];
      if (r) w = fminf(w, y[e][r]);
    }
    mh[e] = sketch::median<R>(x[e]);
    vh[e] = w;
  }
}

// Estimates form: m_hat, v_hat (f32, n) of one piece at ``offset`` (rows
// of ``row`` elements ``stride`` apart; row 0: contiguous).
template <int R>
__global__ void __launch_bounds__(kThreads)
retrieve_kernel(long long n, long long offset, long long row,
                long long stride, const float* __restrict__ m,
                const float* __restrict__ v,
                const uint32_t* __restrict__ cm,
                const uint32_t* __restrict__ cv, sketch::Divisor C,
                float* __restrict__ m_hat, float* __restrict__ v_hat) {
  const Coeffs<R> k(cm, cv);
  const Coord at(offset, 0, row, stride);
  const long long step = (long long)kThreads * kPerThread;
  for (long long base = (long long)blockIdx.x * step + threadIdx.x;
       base < n; base += (long long)gridDim.x * step) {
    uint32_t u[kPerThread];
    bool live[kPerThread];
    float mh[kPerThread], vh[kPerThread];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long i = base + (long long)e * kThreads;
      live[e] = i < n;
      u[e] = at(i);
    }
    estimates<R>(k, u, live, m, v, C, mh, vh);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long i = base + (long long)e * kThreads;
      if (live[e]) {
        m_hat[i] = mh[e];
        v_hat[i] = vh[e];
      }
    }
  }
}

__device__ __forceinline__ float narrow(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 narrow(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

struct AdamW {
  float inv_bc1, inv_bc2, eps, wd, lr;
};

// Fused form: block (x, piece): the piece's params p (type P) take the
// AdamW step from their estimates, in place.
template <typename P, int R>
__global__ void __launch_bounds__(kThreads)
apply_kernel(Segs segs, const float* __restrict__ m,
             const float* __restrict__ v, const uint32_t* __restrict__ cm,
             const uint32_t* __restrict__ cv, sketch::Divisor C, AdamW h) {
  const int piece = blockIdx.y;
  P* p = static_cast<P*>(const_cast<void*>(segs.data[piece]));
  const long long n = segs.n[piece];
  const Coord at(segs, piece);
  const Coeffs<R> k(cm, cv);
  const long long step = (long long)kThreads * kPerThread;
  for (long long base = (long long)blockIdx.x * step + threadIdx.x;
       base < n; base += (long long)gridDim.x * step) {
    uint32_t u[kPerThread];
    bool live[kPerThread];
    float pf[kPerThread], mh[kPerThread], vh[kPerThread];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long i = base + (long long)e * kThreads;
      live[e] = i < n;
      u[e] = at(i);
      pf[e] = live[e] ? widen(p[i]) : 0.0f;
    }
    estimates<R>(k, u, live, m, v, C, mh, vh);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const float mq = __fmul_rn(mh[e], h.inv_bc1);
      const float vc = isnan(vh[e]) ? vh[e] : fmaxf(vh[e], 0.0f);
      const float vq = __fmul_rn(vc, h.inv_bc2);
      const float den = __fadd_rn(__fsqrt_rn(vq), h.eps);
      const float d = __fadd_rn(__fdiv_rn(mq, den), __fmul_rn(h.wd, pf[e]));
      const float out = __fsub_rn(pf[e], __fmul_rn(h.lr, d));
      const long long i = base + (long long)e * kThreads;
      if (live[e]) p[i] = narrow(out, P());
    }
  }
}

int blocks_for(long long count, long long per_block) {
  const long long b = (count + per_block - 1) / per_block;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

Segs pack(const void* const* data, const long long* offset,
          const long long* n, const long long* first, const long long* row,
          const long long* stride, int count, long long tile,
          long long* tiles) {
  Segs s{};
  s.count = count;
  s.tile = tile;
  long long t = 0;
  for (int k = 0; k < count; ++k) {
    s.data[k] = data[k];
    s.offset[k] = offset[k];
    s.n[k] = n[k];
    s.first[k] = first[k];
    s.row[k] = row[k];
    s.stride[k] = stride[k];
    s.tile0[k] = t;
    t += (n[k] + tile - 1) / tile;
  }
  s.tile0[count] = t;
  *tiles = t;
  return s;
}

int set_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Rows 1..8 are instantiated (MAX_ROWS in the wrapper).
#define SKETCH_ROWS(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)

template <typename T>
int accumulate_group(const Segs& segs, long long tiles, float* m, float* v,
                     const uint32_t* cm, const uint32_t* cv, int R,
                     uint32_t C, uint32_t* counts, uint32_t* total,
                     uint32_t* start, void* ws, float b1, float b2, float a1,
                     float a2, int scale, cudaStream_t s) {
  const int NS = (int)((C + kSlab - 1) / kSlab);
  const long long NB = 2LL * R * NS;
  const int hist_bytes = NS * (int)sizeof(uint32_t);
  using E = typename Entry<T>::type;
  E* entries = static_cast<E*>(ws);
  if (tiles > 0) {
    const dim3 grid((unsigned)tiles, 2 * R);
    int err = set_smem((const void*)bin_count_kernel, hist_bytes);
    if (err) return err;
    bin_count_kernel<<<grid, kBinThreads, hist_bytes, s>>>(
        segs, cm, cv, R, sketch::make_divisor(C), NS, counts);
    if ((err = (int)cudaGetLastError())) return err;
  }
  bin_scan_kernel<<<(unsigned)((NB + 255) / 256), 256, 0, s>>>(counts, NB,
                                                               tiles, total);
  bin_offsets_kernel<<<1, kBinThreads, 0, s>>>(total, (int)NB, start);
  if (tiles > 0) {
    const int windows = (NS + kWindow - 1) / kWindow;
    const int scatter_bytes = kStageBytes + kWarpTable16;
    const int err =
        set_smem((const void*)bin_scatter_kernel<T>, scatter_bytes);
    if (err) return err;
    bin_scatter_kernel<T><<<dim3((unsigned)(tiles * windows), 2 * R),
                            kBinThreads, scatter_bytes, s>>>(
        segs, cm, cv, R, sketch::make_divisor(C), NS, tiles, counts, total,
        start, entries);
  }
  const int slab_bytes = (kSlab + kOwner) * (int)sizeof(float);
  int err = set_smem((const void*)slab_add_kernel<T>, slab_bytes);
  if (err) return err;
  slab_add_kernel<T><<<(unsigned)NB, kBinThreads, slab_bytes, s>>>(
      m, v, R, C, NS, start, entries, b1, b2, a1, a2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Sizes the wrapper needs: cells a slab, the most pieces a launch, the
// most slabs a table row, the slabs a scatter block writes into and the
// bytes of its staging.
extern "C" void sketch_update_limits(long long* out) {
  out[0] = kSlab;
  out[1] = kMaxSegs;
  out[2] = kMaxBinsPerRow;
  out[3] = kWindow;
  out[4] = kStageBytes;
}

// Accumulate one group of ``count`` segments (g_bf16: bf16, else f32) into
// the (R, C) tables: passes 1-5, five launches (three when the group has
// no elements), the tables scaled by b1 / b2 first when ``scale``; a1 and
// a2 are 1-b1 and 1-b2.  Count and scatter blocks take ``tile`` elements
// of a piece (the wrapper sizes it so that a window's entries of a tile
// fit the scatter's staging).
// Work space: counts (tiles x 2 R NS), total (2 R NS), start (2 R NS + 1)
// uint32, and ``ws`` room for every entry of the group (2 R x elements,
// 4 bytes each for bf16 g, 8 for f32).
extern "C" int sketch_update_accumulate_launch(
    const void* const* g, const long long* offset, const long long* n,
    const long long* first, const long long* row, const long long* stride,
    int count, long long tile, int g_bf16, void* m, void* v, const void* cm,
    const void* cv, int R, long long C, void* counts, void* total,
    void* start, void* ws, float b1, float b2, float a1, float a2,
    int scale, void* stream) {
  if (count < 0 || count > kMaxSegs || tile < 1)
    return (int)cudaErrorInvalidValue;
  long long tiles = 0;
  const Segs segs = pack(g, offset, n, first, row, stride, count, tile,
                         &tiles);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* cmu = static_cast<const uint32_t*>(cm);
  const uint32_t* cvu = static_cast<const uint32_t*>(cv);
  uint32_t* cnt = static_cast<uint32_t*>(counts);
  uint32_t* tot = static_cast<uint32_t*>(total);
  uint32_t* st = static_cast<uint32_t*>(start);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  if (g_bf16)
    return accumulate_group<__nv_bfloat16>(segs, tiles, mf, vf, cmu, cvu, R,
                                           (uint32_t)C, cnt, tot, st, ws, b1,
                                           b2, a1, a2, scale, s);
  return accumulate_group<float>(segs, tiles, mf, vf, cmu, cvu, R,
                                 (uint32_t)C, cnt, tot, st, ws, b1, b2, a1,
                                 a2, scale, s);
}

// Estimates form: m_hat, v_hat (f32, n) for the piece at ``offset``
// (rows of ``row`` elements ``stride`` apart; row 0: contiguous).
extern "C" int sketch_update_retrieve_launch(
    long long n, long long offset, long long row, long long stride,
    const void* m, const void* v,
    const void* cm, const void* cv, int R, long long C, void* m_hat,
    void* v_hat, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nb = blocks_for(n, (long long)kThreads * kPerThread);
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  const uint32_t* cmu = static_cast<const uint32_t*>(cm);
  const uint32_t* cvu = static_cast<const uint32_t*>(cv);
  float* mh = static_cast<float*>(m_hat);
  float* vh = static_cast<float*>(v_hat);
  const sketch::Divisor Cd = sketch::make_divisor((uint32_t)C);
#define SKETCH_RET_CASE(RR)                                              \
  case RR:                                                               \
    retrieve_kernel<RR><<<nb, kThreads, 0, s>>>(n, offset, row, stride, \
                                                mf, vf, cmu, cvu, Cd, mh,  \
                                                vh);                       \
    break;
  switch (R) {
    SKETCH_ROWS(SKETCH_RET_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SKETCH_RET_CASE
  return (int)cudaGetLastError();
}

// Fused form: the AdamW step of ``count`` param pieces (p_bf16: bf16,
// else f32) from the updated tables, in place; one launch.  inv_bc1 and
// inv_bc2 are the f32 reciprocals of the bias corrections.
extern "C" int sketch_update_apply_launch(
    void* const* p, const long long* offset, const long long* n,
    const long long* first, const long long* row, const long long* stride,
    int count,
    int p_bf16, const void* m, const void* v, const void* cm, const void* cv,
    int R, long long C, float inv_bc1, float inv_bc2, float eps, float wd,
    float lr, void* stream) {
  if (count < 1 || count > kMaxSegs) return (int)cudaErrorInvalidValue;
  long long tiles = 0, most = 0;
  const Segs segs = pack(p, offset, n, first, row, stride, count, 1,
                         &tiles);
  for (int k = 0; k < count; ++k) most = n[k] > most ? n[k] : most;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(most, (long long)kThreads * kPerThread), count);
  const AdamW h{inv_bc1, inv_bc2, eps, wd, lr};
  const sketch::Divisor Cd = sketch::make_divisor((uint32_t)C);
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  const uint32_t* cmu = static_cast<const uint32_t*>(cm);
  const uint32_t* cvu = static_cast<const uint32_t*>(cv);
#define SKETCH_APPLY_CASE(RR)                                              \
  case RR:                                                                 \
    if (p_bf16)                                                            \
      apply_kernel<__nv_bfloat16, RR><<<grid, kThreads, 0, s>>>(           \
          segs, mf, vf, cmu, cvu, Cd, h);                                  \
    else                                                                   \
      apply_kernel<float, RR><<<grid, kThreads, 0, s>>>(                   \
          segs, mf, vf, cmu, cvu, Cd, h);                                  \
    break;
  switch (R) {
    SKETCH_ROWS(SKETCH_APPLY_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SKETCH_APPLY_CASE
  return (int)cudaGetLastError();
}
