// A stable lexicographic sort over a few int32 columns on Hopper, in one
// launch, for the port's two sorts on the card:
//  - the sibling sort under RGA linearize: the permutation of
//    np.lexsort((-actor, -ctr, parent, where(valid, obj, 2**30))), as
//    automerge_tpu_torch/ops/list_rank.py::sibling_sort computes it with
//    four stable torch sorts (the JAX package: jnp.lexsort at
//    automerge_tpu/ops/list_rank.py:73, inside linearize);
//  - the step's register order: rows of D docs x T by (doc, group, time)
//    with each doc's padding (group -1) first, the key
//    d * (n_groups + 1) + group + 1 then the time, as
//    automerge_tpu_torch/parallel/mesh.py::register_order computes it
//    with two stable torch sorts (the JAX package: jnp.lexsort((time,
//    group)) at automerge_tpu/ops/registers.py:267, vmapped over docs).
// Neither replaces a Pallas kernel: the JAX package leaves both sorts to
// XLA.  Rows equal on every key keep their index order.  The keys are
// built here from the raw columns with the callers' arithmetic: -x wraps
// in int32 (-INT_MIN == INT_MIN), an invalid row's first key is 2**30,
// the register key is int64 (wrapping as torch's does).
//
// Design: LSD radix over the bits that vary.  One reduction finds each
// key's least and largest value; a row's composite key is the
// concatenation of (key - least), each in bit_length(largest - least)
// bits, most significant key first, at most 128 bits.  That is an order
// isomorphism, so a stable sort on the composite is the lexsort, and it
// pays only for the bits that vary: a text typed at its head (every
// parent -1) costs no pass for the parent.  Invalid rows key as one
// sentinel just above the largest valid object when that lies below
// 2**30 (the same order, without 2**30's 31 bits).  The composite's
// 8-bit digits go to byte planes in the scratch; each pass is a stable
// counting sort on one digit, least significant first, and a pass whose
// digit puts every row in one bucket is skipped.  A pass: each warp owns
// a contiguous segment of positions, walks it 32 at a time (four steps'
// loads issued together) and ranks equal digits by their lanes' ballots,
// its counts kept in a per-warp row of the block's histogram; a scan
// turns the counts into offsets (digit, then block, then warp, then the
// running count), and the same walk scatters.  Segments are ordered, so
// the sort is stable.
//  - L <= kOneCtaMax (route a): one block of 1,024 threads, the
//    permutation double-buffered in shared memory, block barriers.
//  - larger L (route b): one cooperative launch of at most as many
//    blocks as are resident at once, contiguous ranges a block, the
//    permutation double-buffered in the scratch, each block's digit
//    totals in the scratch, summed by every block for its own offsets,
//    grid barriers (two a pass).  The wrapper never lets two such grids share the card.
// One launch, no host read, no allocation, no synchronize: it captures
// in a CUDA graph.
//
// Bound: bytes.  The sibling sort reads obj, parent, ctr, actor (4 bytes
// each) and valid (1) and writes the permutation (4): 21 bytes a row,
// 0.10 us at L = 16,384 on 3.35 TB/s.  The register order reads group
// and time and writes the permutation: 12 bytes a row.  The time is the
// passes' barriers and gathers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kMaxKeys = 4;
//: 128 composite bits in 8-bit digits
constexpr int kMaxPasses = 16;
//: a walk's steps whose loads issue together
constexpr int kUnroll = 4;
//: route (a)'s largest L (the two permutation rows in shared memory, 8
//: bytes a row, beside the histograms; up to 16,384 fit): the cooperative
//: grid's passes overtake one block's between 4,096 and 6,144 rows
//: (tools/lexsort_routes.py on an H100)
constexpr int64_t kOneCtaMax = 4096;
//: an invalid row's first sibling key (`list_rank.sibling_sort`)
constexpr int64_t kSentinel = int64_t(1) << 30;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// an int64 word another block wrote, through L2
__device__ __forceinline__ int64_t ldcg64(const int64_t* p) {
  return static_cast<int64_t>(__ldcg(reinterpret_cast<const long long*>(p)));
}

__device__ __forceinline__ int32_t neg32(int32_t x) {
  return static_cast<int32_t>(0u - static_cast<uint32_t>(x));
}

// The sibling sort's keys: where(valid, obj, sentinel), parent, -ctr,
// -actor.
struct SiblingKeys {
  static constexpr int kKeys = 4;
  const int32_t* obj;
  const int32_t* parent;
  const int32_t* ctr;
  const int32_t* actor;
  const bool* valid;
  __device__ bool sentinel(int64_t i) const { return !valid[i]; }
  __device__ int64_t key(int k, int64_t i) const {
    switch (k) {
      case 0: return obj[i];
      case 1: return parent[i];
      case 2: return neg32(ctr[i]);
      default: return neg32(actor[i]);
    }
  }
};

// The register order's keys: doc * (n_groups + 1) + group + 1 (int64,
// wrapping), time.
struct RegisterKeys {
  static constexpr int kKeys = 2;
  const int32_t* rg;
  const int32_t* rt;
  int64_t T;
  int64_t n_groups;
  __device__ bool sentinel(int64_t) const { return false; }
  __device__ int64_t key(int k, int64_t i) const {
    if (k == 0) {
      const uint64_t d = static_cast<uint64_t>(i / T);
      return static_cast<int64_t>(
          d * static_cast<uint64_t>(n_groups + 1) +
          static_cast<uint64_t>(static_cast<int64_t>(rg[i])) + 1u);
    }
    return rt[i];
  }
};

// Per-key least and largest value (the sentinel rows' first key left
// out) and whether any row is a sentinel.
struct Range {
  int64_t lo[kMaxKeys];
  int64_t hi[kMaxKeys];
  int any_sentinel;
};
constexpr int kRangeWords = 2 * kMaxKeys + 1;  // int64 words in scratch

// The plan every thread reads: each key's least value and bit shift in
// the composite, the sentinel's value and the number of digits.
struct Plan {
  int64_t lo[kMaxKeys];
  int shift[kMaxKeys];
  int width[kMaxKeys];
  int64_t sentinel;
  int passes;
};

//: route (b): the block's threads read the grid's histogram a digit
//: each, in this many interleaved sets of blocks
constexpr int kQuarters = kThreads / kRadix;

struct Shared {
  int32_t hist[kWarps * kRadix];  // [warp][digit]: counts, then offsets
  int32_t quarter[2][kQuarters][kRadix];  // route b: before, all blocks
  int32_t digit_base[kRadix];
  int32_t warp_sum[kWarps];
  int64_t red[kWarps][kRangeWords];
  Range range;
  Plan plan;
};

// Route (a): one block, plain loads (the permutation lies in shared
// memory, the planes were written by this block).  Route (b): the
// cooperative grid, loads of what other blocks wrote through L2.
struct BlockSync {
  static constexpr bool kGrid = false;
  __device__ void barrier() const { __syncthreads(); }
  template <class T>
  __device__ T ld(const T* p) const { return *p; }
};
struct GridSync {
  static constexpr bool kGrid = true;
  __device__ void barrier() const { cg::this_grid().sync(); }
  template <class T>
  __device__ T ld(const T* p) const { return __ldcg(p); }
};

__device__ __forceinline__ void range_identity(Range& r) {
  for (int k = 0; k < kMaxKeys; ++k) {
    r.lo[k] = INT64_MAX;
    r.hi[k] = INT64_MIN;
  }
  r.any_sentinel = 0;
}

__device__ __forceinline__ void range_merge(Range& a, const Range& b) {
  for (int k = 0; k < kMaxKeys; ++k) {
    a.lo[k] = lmin(a.lo[k], b.lo[k]);
    a.hi[k] = lmax(a.hi[k], b.hi[k]);
  }
  a.any_sentinel |= b.any_sentinel;
}

// Reduces every thread's `r` over the block into sh.range.
__device__ void block_range(Range r, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    Range o;
    for (int k = 0; k < kMaxKeys; ++k) {
      o.lo[k] = __shfl_down_sync(0xffffffffu, r.lo[k], off);
      o.hi[k] = __shfl_down_sync(0xffffffffu, r.hi[k], off);
    }
    o.any_sentinel = __shfl_down_sync(0xffffffffu, r.any_sentinel, off);
    range_merge(r, o);
  }
  if (lane == 0) {
    for (int k = 0; k < kMaxKeys; ++k) {
      sh.red[warp][k] = r.lo[k];
      sh.red[warp][kMaxKeys + k] = r.hi[k];
    }
    sh.red[warp][2 * kMaxKeys] = r.any_sentinel;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Range t;
    range_identity(t);
    for (int w = 0; w < kWarps; ++w) {
      Range o;
      for (int k = 0; k < kMaxKeys; ++k) {
        o.lo[k] = sh.red[w][k];
        o.hi[k] = sh.red[w][kMaxKeys + k];
      }
      o.any_sentinel = static_cast<int>(sh.red[w][2 * kMaxKeys]);
      range_merge(t, o);
    }
    sh.range = t;
  }
  __syncthreads();
}

// Thread 0: the plan from the whole input's range.
template <class K>
__device__ void make_plan(Shared& sh) {
  Range r = sh.range;
  Plan p;
  p.sentinel = kSentinel;
  if (r.any_sentinel) {
    // the sentinel just above the largest other first key keeps the
    // order when that lies below 2**30 (no other key between them)
    if (r.lo[0] <= r.hi[0] && r.hi[0] < kSentinel) p.sentinel = r.hi[0] + 1;
    r.lo[0] = lmin(r.lo[0], p.sentinel);
    r.hi[0] = lmax(r.hi[0], p.sentinel);
  }
  int bits = 0;
  for (int k = K::kKeys - 1; k >= 0; --k) {
    const uint64_t span = static_cast<uint64_t>(r.hi[k]) -
                          static_cast<uint64_t>(r.lo[k]);
    p.lo[k] = r.lo[k];
    p.width[k] = span == 0 ? 0 : 64 - __clzll(static_cast<long long>(span));
    p.shift[k] = bits;
    bits += p.width[k];
  }
  for (int k = K::kKeys; k < kMaxKeys; ++k) {
    p.lo[k] = 0;
    p.width[k] = 0;
    p.shift[k] = 0;
  }
  p.passes = (bits + kDigitBits - 1) / kDigitBits;
  sh.plan = p;
}

// The lanes whose digit equals this lane's (digits 0..kRadix, kRadix
// past the segment): one ballot a bit, cheaper than __match_any_sync.
__device__ __forceinline__ unsigned peers_of(int d) {
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit <= kDigitBits; ++bit) {
    const bool on = (d >> bit) & 1;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    m &= on ? bal : ~bal;
  }
  return m;
}

// One walk of a warp over its positions [w0, w1), 32 a step and kUnroll
// steps' loads together: fn(row, digit, peers) on every lane of each
// step, digit kRadix (and row -1) past the segment.
template <class S, class F>
__device__ __forceinline__ void walk(const uint8_t* plane, const int32_t* in,
                                     int64_t w0, int64_t w1, const S& sync,
                                     F fn) {
  const int lane = threadIdx.x & 31;
  for (int64_t base = w0; base < w1; base += 32 * kUnroll) {
    int32_t r[kUnroll];
    int d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * 32 + lane;
      r[u] = i < w1 ? (in ? sync.ld(in + i) : static_cast<int32_t>(i)) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      d[u] = r[u] >= 0 ? static_cast<int>(sync.ld(plane + r[u])) : kRadix;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned peers = peers_of(d[u]);
      fn(r[u], d[u], peers);
      __syncwarp();
    }
  }
}

// Stable counting sort of positions [0, n) of `in` (nullptr: the
// identity) into `out` by the digit plane `plane`; the block owns
// positions [b0, b1), its warp w the `seg` positions from b0 + w * seg.
// ghist: the grid's histogram ([block][digit], route b), one of two
// buffers that the passes take in turn: a block may start the next pass
// (a skipped pass ends with no grid barrier) while another still reads
// this one.  Returns whether the pass moved anything (false: one bucket
// held every row, the pass is the identity).
template <class S>
__device__ bool radix_pass(const uint8_t* plane, const int32_t* in,
                           int32_t* out, int64_t n, int64_t b0, int64_t b1,
                           int64_t seg, Shared& sh, int32_t* ghist,
                           const S& sync) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w0 = lmin(b0 + warp * seg, b1), w1 = lmin(w0 + seg, b1);
  int32_t* hist = sh.hist + warp * kRadix;
  for (int t = threadIdx.x; t < kWarps * kRadix; t += kThreads)
    sh.hist[t] = 0;
  __syncthreads();

  // counts: the leader of each group of equal digits adds the group
  walk(plane, in, w0, w1, sync,
       [&](int32_t, int d, unsigned peers) {
         if (d < kRadix && lane == __ffs(peers) - 1) hist[d] += __popc(peers);
       });
  __syncthreads();

  // per digit: the warps' exclusive offsets within the block and the
  // block's total
  int32_t total = 0;
  if (threadIdx.x < kRadix) {
    const int d = threadIdx.x;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = sh.hist[w * kRadix + d];
      sh.hist[w * kRadix + d] = total;
      total += c;
    }
  }
  int32_t block_off = 0;
  if constexpr (S::kGrid) {
    // the grid: every block's row of totals, then each block sums, per
    // digit, the rows of the blocks before it and of all blocks
    const int G = gridDim.x, b = blockIdx.x;
    if (threadIdx.x < kRadix) ghist[b * kRadix + threadIdx.x] = total;
    sync.barrier();
    const int d = threadIdx.x % kRadix, q = threadIdx.x / kRadix;
    int32_t before = 0, all = 0;
    for (int j = q; j < G; j += kQuarters) {
      const int32_t v = __ldcg(ghist + j * kRadix + d);
      all += v;
      if (j < b) before += v;
    }
    sh.quarter[0][q][d] = before;
    sh.quarter[1][q][d] = all;
    __syncthreads();
    if (threadIdx.x < kRadix) {
      total = 0;
      for (int k = 0; k < kQuarters; ++k) {
        block_off += sh.quarter[0][k][d];
        total += sh.quarter[1][k][d];
      }
    }
  }

  // digits' exclusive offsets (8 warps of 32 digits)
  int32_t x = total;
  if (threadIdx.x < kRadix) {
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) sh.warp_sum[warp] = x;
  }
  __syncthreads();
  const bool full = threadIdx.x < kRadix && total == n;
  if (threadIdx.x < kRadix) {
    int32_t before = 0;
    for (int w = 0; w < warp; ++w) before += sh.warp_sum[w];
    sh.digit_base[threadIdx.x] = before + x - total + block_off;
  }
  // `full` is the same on every block: the totals are the grid's
  if (__syncthreads_or(full)) return false;
  for (int t = threadIdx.x; t < kWarps * kRadix; t += kThreads)
    sh.hist[t] += sh.digit_base[t % kRadix];
  __syncthreads();

  // scatter: the same walk, each row to its digit's running offset
  walk(plane, in, w0, w1, sync,
       [&](int32_t r, int d, unsigned peers) {
         const int leader = __ffs(peers) - 1;
         int32_t at = 0;
         if (d < kRadix && lane == leader) {
           at = hist[d];
           hist[d] = at + __popc(peers);
         }
         at = __shfl_sync(0xffffffffu, at, leader);
         if (d < kRadix) out[at + __popc(peers & ((1u << lane) - 1u))] = r;
       });
  sync.barrier();
  return true;
}

// The whole sort.  `perm0`, `perm1`: the two permutation rows (shared
// memory on route a, scratch on route b); `planes`: kMaxPasses rows of
// L digits; `part`: the blocks' ranges (route b).
template <class K, class S>
__device__ void lexsort_body(const K& keys, int64_t L, int32_t* out,
                             int32_t* perm0, int32_t* perm1, uint8_t* planes,
                             int64_t* part, int32_t* ghist, const S& sync) {
  __shared__ Shared sh;
  const int64_t G = S::kGrid ? gridDim.x : 1;
  const int64_t b = S::kGrid ? blockIdx.x : 0;
  const int64_t i0 = b * kThreads + threadIdx.x, di = G * kThreads;

  // 1. each key's range
  Range r;
  range_identity(r);
  for (int64_t i = i0; i < L; i += di) {
    const bool s = keys.sentinel(i);
    r.any_sentinel |= s;
    for (int k = 0; k < K::kKeys; ++k) {
      if (k == 0 && s) continue;
      const int64_t v = keys.key(k, i);
      r.lo[k] = lmin(r.lo[k], v);
      r.hi[k] = lmax(r.hi[k], v);
    }
  }
  block_range(r, sh);
  if constexpr (S::kGrid) {
    if (threadIdx.x == 0) {
      int64_t* p = part + b * kRangeWords;
      for (int k = 0; k < kMaxKeys; ++k) {
        p[k] = sh.range.lo[k];
        p[kMaxKeys + k] = sh.range.hi[k];
      }
      p[2 * kMaxKeys] = sh.range.any_sentinel;
    }
    sync.barrier();
    range_identity(r);
    for (int64_t j = threadIdx.x; j < G; j += kThreads) {
      const int64_t* p = part + j * kRangeWords;
      Range o;
      for (int k = 0; k < kMaxKeys; ++k) {
        o.lo[k] = ldcg64(p + k);
        o.hi[k] = ldcg64(p + kMaxKeys + k);
      }
      o.any_sentinel = static_cast<int>(ldcg64(p + 2 * kMaxKeys));
      range_merge(r, o);
    }
    block_range(r, sh);
  }
  if (threadIdx.x == 0) make_plan<K>(sh);
  __syncthreads();
  const Plan& p = sh.plan;

  // 2. the composite key's digits, a byte plane each
  for (int64_t i = i0; i < L && p.passes > 0; i += di) {
    const bool s = keys.sentinel(i);
    uint64_t lo = 0, hi = 0;
    for (int k = 0; k < K::kKeys; ++k) {
      if (p.width[k] == 0) continue;
      const int64_t v = k == 0 && s ? p.sentinel : keys.key(k, i);
      const uint64_t u = static_cast<uint64_t>(v) -
                         static_cast<uint64_t>(p.lo[k]);
      const int at = p.shift[k];
      if (at < 64) {
        lo |= u << at;
        if (at > 0) hi |= u >> (64 - at);
      } else {
        hi |= u << (at - 64);
      }
    }
    for (int q = 0; q < p.passes; ++q) {
      const int o = q * kDigitBits;
      planes[q * L + i] =
          static_cast<uint8_t>(o < 64 ? lo >> o : hi >> (o - 64));
    }
  }
  sync.barrier();

  // 3. the passes, least significant digit first
  const int64_t per_block = (L + G - 1) / G;
  const int64_t span = (per_block + kThreads - 1) / kThreads * kThreads;
  const int64_t b0 = lmin(b * span, L), b1 = lmin(b0 + span, L);
  const int64_t seg = span / kWarps;
  const int32_t* cur = nullptr;  // the identity
  int32_t* bufs[2] = {perm0, perm1};
  int next = 0;
  for (int q = 0; q < p.passes; ++q) {
    if (radix_pass(planes + q * L, cur, bufs[next], L, b0, b1, seg, sh,
                   S::kGrid ? ghist + (q & 1) * G * kRadix : nullptr,
                   sync)) {
      cur = bufs[next];
      next ^= 1;
    }
  }

  // 4. the permutation out
  for (int64_t i = i0; i < L; i += di)
    out[i] = cur ? sync.ld(cur + i) : static_cast<int32_t>(i);
}

template <class K>
__global__ void __launch_bounds__(kThreads)
    one_cta_kernel(K keys, int64_t L, int32_t* out, uint8_t* planes) {
  extern __shared__ int32_t perm_sm[];
  lexsort_body(keys, L, out, perm_sm, perm_sm + L, planes, nullptr, nullptr,
               BlockSync{});
}

struct Layout {
  int64_t part, ghist, perm0, perm1, planes, bytes;
};

__host__ __device__ inline int64_t align16(int64_t x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets in the scratch for L rows on a grid of G blocks (G = 0:
// route a, the planes alone).
__host__ __device__ inline Layout layout(int64_t L, int64_t G) {
  Layout o{};
  int64_t at = 0;
  if (G > 0) {
    o.part = at;
    at = align16(at + G * kRangeWords * 8);
    o.ghist = at;
    at = align16(at + 2 * kRadix * G * 4);
    o.perm0 = at;
    at = align16(at + L * 4);
    o.perm1 = at;
    at = align16(at + L * 4);
  }
  o.planes = at;
  o.bytes = at + kMaxPasses * L;
  return o;
}

// scratch: the blocks' ranges, the grid's two histograms, the two
// permutation rows, the digit planes (`layout`)
template <class K>
__global__ void __launch_bounds__(kThreads)
    grid_kernel(K keys, int64_t L, int32_t* out, uint8_t* scratch) {
  const Layout o = layout(L, gridDim.x);
  lexsort_body(keys, L, out, reinterpret_cast<int32_t*>(scratch + o.perm0),
               reinterpret_cast<int32_t*>(scratch + o.perm1),
               scratch + o.planes,
               reinterpret_cast<int64_t*>(scratch + o.part),
               reinterpret_cast<int32_t*>(scratch + o.ghist), GridSync{});
}

// Per device: route (a)'s shared-memory attribute set per key site,
// route (b)'s co-resident blocks (0: not yet asked).
bool g_smem_set[2][kMaxDevices];
int g_grid_blocks[kMaxDevices];

template <class K>
constexpr int site() { return K::kKeys == 4 ? 0 : 1; }

int current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < 0 || *dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  return 0;
}

// Route (b)'s grid on `dev`: every SM's co-resident blocks.
int grid_blocks(int dev, int* blocks) {
  if (g_grid_blocks[dev] == 0) {
    int coop = 0, sms = 0, a = 0, b = 0;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                           dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &a, grid_kernel<SiblingKeys>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, grid_kernel<RegisterKeys>, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int per_sm = a < b ? a : b;
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    g_grid_blocks[dev] = sms * per_sm;
  }
  *blocks = g_grid_blocks[dev];
  return 0;
}

template <class K>
int launch(const K& keys, int64_t L, void* out, void* scratch,
           void* stream) {
  if (L <= 0) return 0;
  if (L > 2147483647LL || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  int err = current_device(&dev);
  if (err) return err;
  int32_t* o = static_cast<int32_t*>(out);
  uint8_t* scr = static_cast<uint8_t*>(scratch);
  if (L <= kOneCtaMax) {
    if (!g_smem_set[site<K>()][dev]) {
      cudaError_t e = cudaFuncSetAttribute(
          one_cta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(8 * kOneCtaMax));
      if (e != cudaSuccess) return static_cast<int>(e);
      g_smem_set[site<K>()][dev] = true;
    }
    one_cta_kernel<K><<<1, kThreads, 8 * L, s>>>(keys, L, o, scr);
    return static_cast<int>(cudaGetLastError());
  }
  int most = 0;
  err = grid_blocks(dev, &most);
  if (err) return err;
  const int64_t want = (L + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < most ? want : most);
  K k = keys;
  int64_t n = L;
  void* args[] = {&k, &n, &o, &scr};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(grid_kernel<K>), dim3(blocks), dim3(kThreads),
      args, 0, s));
}

}  // namespace

// Bytes of scratch a sort of L rows needs on the current device (either
// entry point); -1 on a CUDA error.
extern "C" int64_t amtpu_torch_lexsort_scratch(int64_t L) {
  if (L <= 0) return 0;
  if (L <= kOneCtaMax) return layout(L, 0).bytes;
  int dev = 0, blocks = 0;
  if (current_device(&dev) || grid_blocks(dev, &blocks)) return -1;
  return layout(L, blocks).bytes;
}

// obj/parent/ctr/actor [L] int32, valid [L] bool; writes out [L] int32,
// the permutation of np.lexsort((-actor, -ctr, parent, where(valid, obj,
// 2**30))).  scratch: amtpu_torch_lexsort_scratch(L) bytes, 16-byte
// aligned.  Returns a cudaError_t.
extern "C" int amtpu_torch_sibling_sort(const void* obj, const void* parent,
                                        const void* ctr, const void* actor,
                                        const void* valid, void* out,
                                        void* scratch, int64_t L,
                                        void* stream) {
  SiblingKeys k{static_cast<const int32_t*>(obj),
                static_cast<const int32_t*>(parent),
                static_cast<const int32_t*>(ctr),
                static_cast<const int32_t*>(actor),
                static_cast<const bool*>(valid)};
  return launch(k, L, out, scratch, stream);
}

// rg/rt [D, T] int32 (rows d * T + t); writes out [D * T] int32, the
// rows by (d * (n_groups + 1) + rg + 1, rt), stable.  scratch:
// amtpu_torch_lexsort_scratch(D * T) bytes.  Returns a cudaError_t.
extern "C" int amtpu_torch_register_sort(const void* rg, const void* rt,
                                         void* out, void* scratch, int64_t D,
                                         int64_t T, int64_t n_groups,
                                         void* stream) {
  if (D < 0 || T < 0 || n_groups < 0 || (T > 0 && D > INT64_MAX / T))
    return static_cast<int>(cudaErrorInvalidValue);
  RegisterKeys k{static_cast<const int32_t*>(rg),
                 static_cast<const int32_t*>(rt), T, n_groups};
  return launch(k, D * T, out, scratch, stream);
}
