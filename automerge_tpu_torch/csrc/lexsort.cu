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
// The keys: one reduction finds each key's least and largest value; a
// row's composite key is the concatenation of (key - least), each in
// bit_length(largest - least) bits, most significant key first, at most
// 128 bits: an order isomorphism, so a stable sort on the composite is
// the lexsort, and it pays only for the bits that vary.  Invalid rows key
// as one sentinel just above the largest valid object when that lies
// below 2**30.  A row carries a 64-bit window of its composite with it;
// a pass whose digit leaves the window re-keys the rows from the columns
// through their index (only composites over 64 bits).
//
// One launch; the route by L on the host, by the data on the card:
//  - L <= the cluster's capacity (kTileMax = 4,096 rows a CTA times the
//    largest cluster the card schedules: 16 CTAs where
//    cudaOccupancyMaxActiveClusters allows the non-portable size, else 8;
//    65,536 or 32,768 rows): one thread-block cluster of
//    C = pow2ceil(L / kClusterRows) CTAs (at most the largest) of 512
//    threads, launched with cudaLaunchKernelEx, not cooperative.  Each
//    CTA holds ceil(L / C) rows as 16-byte (key, index) words in shared
//    memory.  No CTA writes a peer's shared memory before a cluster
//    barrier shows every peer started (arrived at on entry, waited on
//    after the CTA's range).  A pass: each warp loads its rows into
//    registers and ranks equal digits by the lanes' ballots into its own
//    histogram row; a scan gives each warp's offset per digit; the CTA
//    stores its digit counts into every peer's shared memory; a cluster
//    barrier; each CTA sums the peers' counts before it, and sends each
//    row from registers to its place in the peer's tile (one 16-byte
//    remote store; a warp's lanes of one digit land side by side); a
//    second cluster barrier.
//    Nothing is read remotely, so no CTA waits for a peer at its exit.  A
//    pass whose digit puts every row in one bucket sends nothing (one
//    barrier).  C = 1 is the one-CTA sort with block barriers alone.
//  - larger L: one cooperative launch of one block an SM.  A grid barrier
//    after the ranges; one sweep then counts every pass's digits into
//    global totals and writes each row's key for the first pass (one
//    more grid barrier for all passes).  A pass ranks each tile of rows
//    locally as above, stages them by digit in shared memory, publishes
//    the tile's digit counts and sums those of the tiles before it as
//    they are published (a look-back without a chain: each thread a
//    digit and a share of the tiles, 16 loads in flight; every tile waits
//    only on lower ones' local ranks, all resident), and writes its runs
//    to the other buffer, or the permutation on the last pass; one grid
//    barrier a pass but the last.  Passes whose digit is one bucket
//    everywhere are known from the totals and skipped.  The wrapper
//    never lets two such grids share the card.
//  - the register order with every group id in [-1, n_groups) (decided
//    after the first barrier of either route, from the reduction: a
//    global fact, since an out-of-range id in one doc keys among another
//    doc's rows): each doc's rows are sorted within [d T, (d + 1) T) by
//    (group, time, row).  T <= 32: a warp a doc, each lane counting the
//    doc's rows before its own (32-bit keys read back from shared memory
//    where the group's and time's widths allow; 8 docs a warp loaded at
//    once).  32 < T <= the CTA's tile: each CTA sorts batches of whole
//    docs by (doc in batch, group, time) with local passes.  Larger T:
//    the cluster's or grid's radix (with D = 1, the doc alone: its key
//    holds no doc bits).
// No host read, no allocation, no synchronize: it captures in a CUDA
// graph.  `info` (nullable, kInfoWords int32) gets the route readout.
// The constants marked for tools/lexsort_routes.py pick between designs
// measured with it on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
//
// Capacity: a CTA's tile is 4,096 rows of 16 bytes (64 KB) beside 16 KB
// of per-warp histograms and 32 KB of its peers' counts; a pass's rows
// sit in registers (kSteps = 8 a thread).  16 CTAs hold 65,536 rows:
// 16,384 to 65,536 fit, 262,144 and 393,216 take the grid.
//
// Bound: bytes.  The sibling sort reads obj, parent, ctr, actor (4 bytes
// each) and valid (1) and writes the permutation (4): 21 bytes a row,
// 0.10 us at L = 16,384 on 3.35 TB/s.  The register order reads group
// and time and writes the permutation: 12 bytes a row.  The time is the
// barriers and each pass's latency chain: on the cluster 7-15 us a pass
// of which the local rank is half and the remote stores a fifth; on the
// grid 9-10 us a pass of which a barrier is 1.5 (tools/lexsort_routes.py
// with its `phases` build, on the H100 above).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

//: a CTA's threads: 512 leave each 128 registers for its rows
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeys = 4;
//: the most key slots of a range (the sibling sort's four keys; the
//: register order's two and its raw group id)
constexpr int kSlots = kMaxKeys;
//: the digit of both routes (a digit a thread; per-warp histograms of
//: 16 KB)
constexpr int kDigitBits = 8;
//: 32-row steps a warp holds in registers during a pass
constexpr int kSteps = 8;
//: a CTA's most rows
constexpr int kTileMax = kThreads * kSteps;
static_assert((1 << kDigitBits) <= kThreads, "a thread a digit");
//: the cluster's rows a CTA it aims at: C = pow2ceil(L / kClusterRows)
constexpr int kClusterRows = 1024;
//: the largest cluster asked for (0: every L on the grid)
constexpr int kClusterMax = 16;
//: the register order's per-doc routes (false: the radix for every input)
constexpr bool kSegmented = true;
//: an invalid row's first sibling key (`list_rank.sibling_sort`)
constexpr int64_t kSentinel = int64_t(1) << 30;
constexpr int kMaxDevices = 64;
//: the cluster's peer slots (arrays of at least one)
constexpr int kPeers = kClusterMax > 0 ? kClusterMax : 1;

//: the readout: route, CTAs (cluster size or grid blocks), digit bits,
//: the sorted key's bits, passes planned, run, skipped (bit mask),
//: barriers (cluster or grid), every group id in range, rows a CTA,
//: tiles (grid), the largest cluster the card schedules, then ns from
//: CTA or block 0's start to its plan, to the end of each of the first
//: kStampPasses passes (0: not reached; on the grid, skipped), to its end
constexpr int kStampPasses = 8;
enum Info {
  kInfoRoute, kInfoCtas, kInfoDigitBits, kInfoBits, kInfoPasses, kInfoRun,
  kInfoSkipped, kInfoBarriers, kInfoInRange, kInfoRows, kInfoTiles,
  kInfoClusterMax, kInfoPlanNs, kInfoPassNs,
  kInfoEndNs = kInfoPassNs + kStampPasses, kInfoWords
};
enum Route { kRouteCluster = 0, kRouteGrid = 1, kRouteWarp = 2,
             kRouteBlock = 3 };

__host__ __device__ constexpr int grid_max_passes() {
  return (128 + kDigitBits - 1) / kDigitBits;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ int bit_length(uint64_t x) {
  return x == 0 ? 0 : 64 - __clzll(static_cast<long long>(x));
}

// an int64 word another block wrote, through L2
__device__ __forceinline__ int64_t ldcg64(const int64_t* p) {
  return static_cast<int64_t>(__ldcg(reinterpret_cast<const long long*>(p)));
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The two halves of a cluster barrier (every thread of every CTA calls
// both, in turn): arrive without ordering this thread's earlier memory
// operations, then wait for every thread of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ int32_t neg32(int32_t x) {
  return static_cast<int32_t>(0u - static_cast<uint32_t>(x));
}

// The sibling sort's keys: where(valid, obj, sentinel), parent, -ctr,
// -actor.
struct SiblingKeys {
  static constexpr int kKeys = 4;
  static constexpr int kRangeSlots = 4;
  static constexpr bool kRegister = false;
  const int32_t* obj;
  const int32_t* parent;
  const int32_t* ctr;
  const int32_t* actor;
  const bool* valid;
  // the columns are read-only for the launch: loads through the
  // read-only path, free to move past the kernel's stores
  __device__ bool sentinel(int64_t i) const {
    return !__ldg(reinterpret_cast<const unsigned char*>(valid) + i);
  }
  __device__ int64_t key(int k, int64_t i) const {
    switch (k) {
      case 0: return __ldg(obj + i);
      case 1: return __ldg(parent + i);
      case 2: return neg32(__ldg(ctr + i));
      default: return neg32(__ldg(actor + i));
    }
  }
  __device__ bool in_range(int64_t, int64_t) const { return false; }
};

// The register order's keys: doc * (n_groups + 1) + group + 1 (int64,
// wrapping), time; the raw group id beside them (range slot kKeys).
struct RegisterKeys {
  static constexpr int kKeys = 2;
  static constexpr int kRangeSlots = 3;  // the keys and the raw group id
  static constexpr bool kRegister = true;
  const int32_t* rg;
  const int32_t* rt;
  int64_t T;
  int64_t n_groups;
  __device__ bool sentinel(int64_t) const { return false; }
  __device__ int64_t key(int k, int64_t i) const {
    if (k == 0) {
      // i < 2**31 (L is): a 32-bit division
      const uint64_t d = static_cast<uint32_t>(i) / static_cast<uint32_t>(T);
      return static_cast<int64_t>(
          d * static_cast<uint64_t>(n_groups + 1) +
          static_cast<uint64_t>(static_cast<int64_t>(__ldg(rg + i))) + 1u);
    }
    return __ldg(rt + i);
  }
  __device__ int64_t group(int64_t i) const { return __ldg(rg + i); }
  // every group id in [-1, n_groups): the flattened key is the per-doc
  // lexsort, each doc's rows within its own range
  __device__ bool in_range(int64_t lo, int64_t hi) const {
    return lo >= -1 && hi < n_groups;
  }
};

// Per-slot least and largest value (the sentinel rows' first key left
// out) and whether any row is a sentinel.  K's slots: its keys, then the
// raw group id (register).
struct Range {
  int64_t lo[kSlots];
  int64_t hi[kSlots];
  int any_sentinel;
};
constexpr int kRangeWords = 2 * kSlots + 1;  // int64 words in scratch

// The plan every thread reads: each key's least value and bit shift in
// the composite, the sentinel's value, the composite's bits, and the
// register order's per-doc facts.
struct Plan {
  int64_t lo[kMaxKeys];
  int shift[kMaxKeys];
  int width[kMaxKeys];
  int64_t sentinel;
  int bits;
  int in_range;
  int64_t g_lo;  // the least raw group id
  int g_width;   // bit_length(largest - least raw group id)
};

__device__ __forceinline__ void range_identity(Range& r) {
  for (int k = 0; k < kSlots; ++k) {
    r.lo[k] = INT64_MAX;
    r.hi[k] = INT64_MIN;
  }
  r.any_sentinel = 0;
}

template <int NS>
__device__ __forceinline__ void range_merge(Range& a, const Range& b) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    a.lo[k] = lmin(a.lo[k], b.lo[k]);
    a.hi[k] = lmax(a.hi[k], b.hi[k]);
  }
  a.any_sentinel |= b.any_sentinel;
}

template <class K>
__device__ __forceinline__ void range_add(const K& keys, int64_t i,
                                          Range& r) {
  const bool s = keys.sentinel(i);
  r.any_sentinel |= s;
  for (int k = 0; k < K::kKeys; ++k) {
    if (k == 0 && s) continue;
    const int64_t v = keys.key(k, i);
    r.lo[k] = lmin(r.lo[k], v);
    r.hi[k] = lmax(r.hi[k], v);
  }
  if constexpr (K::kRegister) {
    const int64_t g = keys.group(i);
    r.lo[K::kKeys] = lmin(r.lo[K::kKeys], g);
    r.hi[K::kKeys] = lmax(r.hi[K::kKeys], g);
  }
}

template <int NS>
__device__ __forceinline__ void warp_range(Range& r) {
  for (int off = 16; off > 0; off >>= 1) {
    Range o;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      o.lo[k] = __shfl_down_sync(0xffffffffu, r.lo[k], off);
      o.hi[k] = __shfl_down_sync(0xffffffffu, r.hi[k], off);
    }
    o.any_sentinel = __shfl_down_sync(0xffffffffu, r.any_sentinel, off);
    range_merge<NS>(r, o);
  }
}

// The scratch of the small per-CTA state.
template <int B>
struct Small {
  static constexpr int kRadix = 1 << B;
  int32_t dbase[kRadix];    // the tile's digit starts
  int32_t ctot[2][kRadix];  // the tile's digit counts, by pass parity
  int32_t obase[kRadix];    // a digit's destination less its start
  int32_t gstart[kRadix];   // a digit's start over all rows (grid)
  int32_t look[kThreads];   // the look-back's partial sums (grid)
  unsigned skip;            // the passes skipped (grid)
  int32_t warp_sum[kWarps];
  uint32_t stamp[kInfoWords - kInfoPlanNs];  // CTA 0: ns since t0
  uint64_t t0;
  Range red[kWarps];
  Range range;  // this CTA's
  Plan plan;
};

// Thread 0 of CTA or block 0 notes the ns since the start at `slot`.
template <int B>
__device__ __forceinline__ void stamp(Small<B>& sm, bool first, int slot) {
  if (first && threadIdx.x == 0)
    sm.stamp[slot - kInfoPlanNs] = static_cast<uint32_t>(now_ns() - sm.t0);
}

//: stamp the phases of the second pass in the pass slots, in place of
//: each pass's end (tools/lexsort_routes.py's `phases` build)
constexpr bool kStampPhases = false;

template <int B>
__device__ __forceinline__ void stamp_pass(Small<B>& sm, bool first, int q) {
  if (!kStampPhases && q < kStampPasses) stamp(sm, first, kInfoPassNs + q);
}

template <int B>
__device__ __forceinline__ void stamp_phase(Small<B>& sm, bool first, int q,
                                            int slot) {
  if (kStampPhases && q == 1) stamp(sm, first, kInfoPassNs + slot);
}

// Reduces every thread's `r` over the block into `out` (warp 0 merges
// the warps').
template <int NS, int B>
__device__ void block_range(Range r, Small<B>& sm, Range& out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_range<NS>(r);
  if (lane == 0) sm.red[warp] = r;
  __syncthreads();
  if (warp == 0) {
    if (lane < kWarps) r = sm.red[lane];
    else range_identity(r);
    warp_range<NS>(r);
    if (lane == 0) out = r;
  }
  __syncthreads();
}

// The plan from the whole input's range (one thread).
template <class K>
__device__ void make_plan(const K& keys, Range r, Plan& out) {
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
    p.width[k] = bit_length(span);
    p.shift[k] = bits;
    bits += p.width[k];
  }
  for (int k = K::kKeys; k < kMaxKeys; ++k) {
    p.lo[k] = 0;
    p.width[k] = 0;
    p.shift[k] = 0;
  }
  p.bits = bits;
  constexpr int g = K::kKeys < kSlots ? K::kKeys : 0;  // the group's slot
  p.in_range = K::kRegister && keys.in_range(r.lo[g], r.hi[g]);
  p.g_lo = K::kRegister ? r.lo[g] : 0;
  p.g_width =
      K::kRegister ? bit_length(static_cast<uint64_t>(r.hi[g] - r.lo[g])) : 0;
  out = p;
}

// Row i's composite key, bits 0-63 and 64-127.
template <class K>
__device__ __forceinline__ void composite(const K& keys, const Plan& p,
                                          int64_t i, uint64_t& lo,
                                          uint64_t& hi) {
  const bool s = keys.sentinel(i);
  lo = 0;
  hi = 0;
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
}

// Bits [at, at + 64) of a composite.
__device__ __forceinline__ uint64_t window(uint64_t lo, uint64_t hi,
                                           int at) {
  return at == 0 ? lo : at < 64 ? (lo >> at) | (hi << (64 - at))
                                : hi >> (at - 64);
}

template <class K>
__device__ __forceinline__ uint64_t window_of(const K& keys, const Plan& p,
                                              int64_t i, int at) {
  uint64_t lo, hi;
  composite(keys, p, i, lo, hi);
  return window(lo, hi, at);
}

// The window a pass at digit offset o reads, given the window the rows
// carry: unchanged while the digit lies inside it.
template <int B>
__device__ __forceinline__ int window_for(int o, int carried) {
  return o + B > carried + 64 ? o : carried;
}

// The lanes whose digit equals this lane's (digits 0..2**B, 2**B past
// the rows): one ballot a bit.
template <int B>
__device__ __forceinline__ unsigned peers_of(int d) {
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit <= B; ++bit) {
    const bool on = (d >> bit) & 1;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    m &= on ? bal : ~bal;
  }
  return m;
}

// Exclusive scan of v over threads [0, R) (every thread calls it; one
// barrier).
template <int R>
__device__ __forceinline__ int32_t digit_scan(int32_t v, int32_t* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
  if (threadIdx.x < R) {
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
  }
  __syncthreads();
  int32_t before = 0;
  if (threadIdx.x < R)
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
  return before + x - v;  // warp_sum is free after the caller's next barrier
}

// A CTA's tile in dynamic shared memory: the per-warp histograms, then
// the rows, a 16-byte word each (key, index, pad): one store a row to a
// peer.
struct Tile {
  int32_t* hist;
  uint4* row;
  __device__ __forceinline__ uint64_t key_at(int pos) const {
    return static_cast<uint64_t>(row[pos].x) |
           static_cast<uint64_t>(row[pos].y) << 32;
  }
  __device__ __forceinline__ int32_t idx_at(int pos) const {
    return static_cast<int32_t>(row[pos].z);
  }
};

__device__ __forceinline__ uint4 row_word(uint64_t k, int32_t v) {
  return make_uint4(static_cast<uint32_t>(k), static_cast<uint32_t>(k >> 32),
                    static_cast<uint32_t>(v), 0u);
}

template <int B>
__host__ __device__ constexpr int64_t tile_bytes(int64_t rows) {
  return int64_t(kWarps) * (int64_t(1) << B) * 4 + rows * 16;
}

template <int B>
__device__ __forceinline__ Tile tile_at(unsigned char* dyn) {
  Tile t;
  t.hist = reinterpret_cast<int32_t*>(dyn);
  t.row = reinterpret_cast<uint4*>(dyn + kWarps * (1 << B) * 4);
  return t;
}

// The CTA's n rows (positions 0..n-1 in their current order, load(pos,
// key, idx) giving each) ranked stably by the digit at bit `sh` of the
// key and staged in that order in the tile; sm.dbase the digits' starts,
// sm.ctot[par] their counts.  Warp w loads positions from w * seg, 32 a
// step, and counts in its own histogram row, which it zeroes again after
// its stage (zero on entry; `zero_hist` at the kernel's start).  Four
// block barriers.  Returns whether one digit holds all n rows (the staged
// order is then the order loaded).
// A warp's rows of one pass, held in registers: keys, indices (-1 past
// the rows) and each step's lanes of equal digits.
struct Rows {
  uint64_t k[kSteps];
  int32_t v[kSteps];
  unsigned peers[kSteps];
};

// Step s's digit at bit `sh`; 2**B for a lane past the rows.
template <int B>
__device__ __forceinline__ int row_digit(const Rows& r, int s, int sh) {
  return r.v[s] < 0 ? (1 << B)
                    : static_cast<int>((r.k[s] >> sh) & ((1 << B) - 1));
}

// The first half of a local rank: the CTA's n rows (positions 0..n-1 in
// their current order, load(pos, key, idx) giving each) into `r`, warp w
// loading positions from w * seg (returned), 32 a step, and counting in
// its own histogram row (zero on entry; `zero_hist` at the kernel's
// start); then per digit the warps' exclusive offsets in place of the
// counts, sm.dbase the digits' starts and sm.ctot[par] their counts.
// Three block barriers.  Returns whether one digit holds all n rows.
template <int B, class Load>
__device__ __forceinline__ bool local_count(const Tile& t, Small<B>& sm,
                                            int n, int sh, int par,
                                            Load load, Rows& r, int& seg) {
  constexpr int R = 1 << B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  seg = ((n + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int w0 = warp * seg;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int p = w0 + s * 32 + lane;
    r.k[s] = 0;
    r.v[s] = -1;
    if (s * 32 < seg && p < n) load(p, r.k[s], r.v[s]);
  }
  int32_t* hist = t.hist + warp * R;
  // counts: the leader of each group of equal digits adds the group
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    r.peers[s] = 0;
    if (s * 32 < seg) {
      const int d = row_digit<B>(r, s, sh);
      r.peers[s] = peers_of<B>(d);
      if (d < R && lane == __ffs(r.peers[s]) - 1)
        hist[d] += __popc(r.peers[s]);
      __syncwarp();
    }
  }
  __syncthreads();
  // per digit: the warps' exclusive offsets and the tile's count
  int32_t total = 0;
  if (threadIdx.x < R) {
    const int x = threadIdx.x;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = t.hist[w * R + x];
      t.hist[w * R + x] = total;
      total += c;
    }
    sm.ctot[par][x] = total;
  }
  const int32_t start = digit_scan<R>(total, sm.warp_sum);
  if (threadIdx.x < R) sm.dbase[threadIdx.x] = start;
  return __syncthreads_or(threadIdx.x < R && total == n);
}

// The second half: each row to base[digit], its warp's offset and its
// place among the warp's equal digits, through put(place, key, idx); the
// warp's histogram row zeroed again.
template <int B, class Put>
__device__ __forceinline__ void local_place(const Tile& t, const int32_t* base,
                                            int sh, int seg, const Rows& r,
                                            Put put) {
  constexpr int R = 1 << B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* hist = t.hist + warp * R;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (s * 32 < seg) {
      const int d = row_digit<B>(r, s, sh);
      const int leader = __ffs(r.peers[s]) - 1;
      int at = 0;
      if (d < R && lane == leader) {
        at = hist[d];
        hist[d] = at + __popc(r.peers[s]);
        at += base[d];
      }
      at = __shfl_sync(0xffffffffu, at, leader);
      if (d < R) put(at + __popc(r.peers[s] & ((1u << lane) - 1u)), r.k[s],
                     r.v[s]);
      __syncwarp();
    }
  }
  for (int x = lane; x < R; x += 32) hist[x] = 0;
}

// The CTA's rows ranked stably by the digit at bit `sh` and staged in
// that order in the tile (local_count, then local_place at the digits'
// starts); four block barriers.  Returns whether one digit holds all n
// rows (the staged order is then the order loaded).
template <int B, class Load>
__device__ __forceinline__ bool local_rank(const Tile& t, Small<B>& sm,
                                           int n, int sh, int par,
                                           Load load) {
  Rows r;
  int seg = 0;
  const bool one = local_count<B>(t, sm, n, sh, par, load, r, seg);
  local_place<B>(t, sm.dbase, sh, seg, r,
                 [&](int at, uint64_t k, int32_t v) {
                   t.row[at] = row_word(k, v);
                 });
  __syncthreads();
  return one;
}

// Every warp's histogram row zeroed (before a kernel's first local_rank).
template <int B>
__device__ __forceinline__ void zero_hist(const Tile& t) {
  for (int x = threadIdx.x; x < kWarps * (1 << B); x += kThreads)
    t.hist[x] = 0;
  __syncthreads();
}

//: the docs a warp loads before it ranks any (the warp route)
constexpr int kDocBatch = 8;
//: the warp route's narrow key: (group, time) in at most this many bits,
//: the lane below them, in 32 bits
constexpr int kNarrowBits = 27;

// The register order, a warp a doc (T <= 32): each lane's rank is the
// count of the doc's rows before it by (group, time, row).  A row's key
// is (group - least, time - least) in the plan's widths.  Where that fits
// kNarrowBits, its lane goes below it and the rank is the count of
// smaller 32-bit keys: the warp stores its docs' keys in `mine` (its
// histogram row, kDocBatch x 32 words, idle on this route) and each lane
// reads them back four at a time, the same words in every lane (one
// broadcast a read); else the rows compare as 64-bit keys and lanes
// through shuffles.  A warp takes its docs kDocBatch at a time: it loads
// all of them (one load latency a batch), then ranks them.
__device__ void warp_docs(const RegisterKeys& keys, const Plan& p, int64_t D,
                          int64_t gw, int64_t nw, uint32_t* mine,
                          int32_t* out) {
  const int lane = threadIdx.x & 31;
  const int T = static_cast<int>(keys.T);
  const int wt = p.width[1];
  const bool narrow = p.g_width + wt <= kNarrowBits;
  for (int64_t d0 = gw; d0 < D; d0 += nw * kDocBatch) {
    // the batch's docs: d0 + b nw for b < nb
    const int nb = static_cast<int>(lmin(kDocBatch, (D - d0 + nw - 1) / nw));
    uint64_t k[kDocBatch];
    int rank[kDocBatch];
#pragma unroll
    for (int b = 0; b < kDocBatch; ++b) {
      const int64_t d = d0 + b * nw;
      k[b] = ~0ull;  // past the doc's rows: the largest key
      rank[b] = 0;
      if (b < nb && lane < T) {
        const int64_t i = d * T + lane;
        k[b] = static_cast<uint64_t>(int64_t(__ldg(keys.rg + i)) - p.g_lo)
                   << wt |
               static_cast<uint64_t>(int64_t(__ldg(keys.rt + i)) - p.lo[1]);
        if (narrow) k[b] = k[b] << 5 | static_cast<uint64_t>(lane);
      }
    }
    if (narrow) {
#pragma unroll
      for (int b = 0; b < kDocBatch; ++b)
        mine[b * 32 + lane] = static_cast<uint32_t>(k[b]);
      __syncwarp();
#pragma unroll
      for (int b = 0; b < kDocBatch; ++b) {
        if (b >= nb) break;
        const uint32_t key = static_cast<uint32_t>(k[b]);
        const uint4* row = reinterpret_cast<const uint4*>(mine + b * 32);
        int r = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 w = row[j];
          r += (w.x < key) + (w.y < key) + (w.z < key) + (w.w < key);
        }
        rank[b] = r;
      }
      __syncwarp();  // read before the next batch overwrites
    } else {
      for (int j = 0; j < T; ++j) {
#pragma unroll
        for (int b = 0; b < kDocBatch; ++b) {
          if (b >= nb) break;
          const uint64_t kj = __shfl_sync(0xffffffffu, k[b], j);
          rank[b] += kj < k[b] || (kj == k[b] && j < lane);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kDocBatch; ++b) {
      const int64_t d = d0 + b * nw;
      if (b < nb && lane < T)
        out[d * T + rank[b]] = static_cast<int32_t>(d * T + lane);
    }
  }
}

// The bits of the block route's local key: (doc in batch, group, time).
__device__ __forceinline__ int block_bits(const Plan& p, int per) {
  return bit_length(static_cast<uint64_t>(per - 1)) + p.g_width +
         p.width[1];
}

// The register order, batches of `per` whole docs a CTA (32 < T <=
// rows): batch j = first, first + stride, ...; each sorted in the tile by
// (doc in batch, group, time) with local passes.  Returns the passes.
template <int B>
__device__ int block_docs(const RegisterKeys& keys, const Plan& p,
                          int64_t D, int rows, int64_t first,
                          int64_t stride, const Tile& t, Small<B>& sm,
                          int32_t* out) {
  const int64_t T = keys.T;
  const int per = static_cast<int>(rows / T);
  const int wt = p.width[1];
  const int wgt = p.g_width + wt;
  const int passes = (block_bits(p, per) + B - 1) / B;
  for (int64_t j = first; j * per < D; j += stride) {
    const int64_t d0 = j * per;
    const int n = static_cast<int>(lmin(per, D - d0) * T);
    const int64_t row0 = d0 * T;
    for (int q = 0; q < passes; ++q) {
      local_rank<B>(t, sm, n, q * B, q & 1,
                    [&](int pos, uint64_t& k, int32_t& v) {
                      if (q == 0) {
                        const int64_t i = row0 + pos;
                        k = (static_cast<uint64_t>(pos / T) << wgt) |
                            (static_cast<uint64_t>(
                                 int64_t(keys.rg[i]) - p.g_lo) << wt) |
                            (static_cast<uint64_t>(int64_t(keys.rt[i]) -
                                                   p.lo[1]));
                        v = static_cast<int32_t>(i);
                      } else {
                        k = t.key_at(pos);
                        v = t.idx_at(pos);
                      }
                    });
    }
    for (int pos = threadIdx.x; pos < n; pos += kThreads)
      out[row0 + pos] = passes ? t.idx_at(pos)
                               : static_cast<int32_t>(row0 + pos);
    __syncthreads();
  }
  return passes;
}

// The route the data takes once the plan is known: the register order's
// per-doc routes where every group id is in range, else the radix.
template <class K>
__device__ __forceinline__ int data_route(const K& keys, const Plan& p,
                                          int rows, int radix) {
  if constexpr (K::kRegister) {
    if (kSegmented && p.in_range) {
      if (keys.T <= 32) return kRouteWarp;
      if (keys.T <= rows &&
          block_bits(p, static_cast<int>(rows / keys.T)) <= 64)
        return kRouteBlock;
    }
  }
  return radix;
}

// The register order's per-doc routes on `ctas` CTAs (this one `c`);
// sets the local key's bits and passes (block route).
template <int B, class K>
__device__ void segmented(const K& keys, const Plan& p, int route,
                          int64_t L, int rows, int c, int ctas,
                          const Tile& t, Small<B>& sm, int32_t* out,
                          int* bits, int* passes) {
  if constexpr (K::kRegister) {
    if (route == kRouteWarp) {
      static_assert(kDocBatch * 32 <= (1 << B), "a warp's keys in its row");
      warp_docs(keys, p, L / keys.T,
                int64_t(c) * kWarps + (threadIdx.x >> 5),
                int64_t(ctas) * kWarps,
                reinterpret_cast<uint32_t*>(t.hist + (threadIdx.x >> 5) *
                                                         (1 << B)),
                out);
      *bits = 0;
      *passes = 0;
    } else {
      *bits = block_bits(p, static_cast<int>(rows / keys.T));
      *passes = block_docs<B>(keys, p, L / keys.T, rows, c, ctas, t, sm, out);
    }
  }
}

template <int B>
__device__ void write_info(int32_t* info, const Small<B>& sm, int route,
                           int ctas, int bits, int passes, int run,
                           unsigned skipped, int barriers, int in_range,
                           int rows, int tiles, int cmax) {
  if (info == nullptr) return;
  info[kInfoRoute] = route;
  info[kInfoCtas] = ctas;
  info[kInfoDigitBits] = B;
  info[kInfoBits] = bits;
  info[kInfoPasses] = passes;
  info[kInfoRun] = run;
  info[kInfoSkipped] = static_cast<int32_t>(skipped);
  info[kInfoBarriers] = barriers;
  info[kInfoInRange] = in_range;
  info[kInfoRows] = rows;
  info[kInfoTiles] = tiles;
  info[kInfoClusterMax] = cmax;
  for (int j = kInfoPlanNs; j < kInfoWords; ++j)
    info[j] = static_cast<int32_t>(sm.stamp[j - kInfoPlanNs]);
}

template <int B>
__device__ __forceinline__ void stamps_start(Small<B>& sm) {
  if (threadIdx.x == 0) {
    sm.t0 = now_ns();
    for (int j = 0; j < kInfoWords - kInfoPlanNs; ++j) sm.stamp[j] = 0;
  }
}

// The cluster route: C CTAs of `rows` rows each (the last fewer).  Every
// exchange is pushed: a CTA stores its range and its digit counts into
// each peer's shared memory before a cluster barrier and reads only its
// own after it, so no CTA reads a peer's memory and none waits at exit.
// A peer's shared memory may be written only once the peer has started:
// each CTA arrives at a barrier on entry and waits on it before its first
// push, the wait overlapping its range reduction.
template <class K>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_kernel(K keys, int64_t L, int rows, int32_t* out, int32_t* info,
                   int cmax) {
  constexpr int B = kDigitBits, R = 1 << B, NS = K::kRangeSlots;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Small<B> sm;
  __shared__ Range peer_range[kPeers];
  __shared__ int32_t peer_ctot[2][kPeers][R];
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int c = static_cast<int>(cl.block_rank());
  const Tile t = tile_at<B>(dyn);
  const int64_t base = int64_t(c) * rows;
  const int n = static_cast<int>(lmax(0, lmin(rows, L - base)));
  const bool first = c == 0;
  int barriers = 0;
  stamps_start(sm);
  if (C > 1) cluster_arrive_relaxed();

  // 1. ranges: this CTA's rows, pushed to every peer once all have
  // started, then the cluster's
  Range r;
  range_identity(r);
  for (int pos = threadIdx.x; pos < n; pos += kThreads)
    range_add(keys, base + pos, r);
  block_range<NS>(r, sm, sm.range);
  if (C > 1) {
    cluster_wait();
    ++barriers;
  }
  if (threadIdx.x < C)
    *cl.map_shared_rank(&peer_range[c], threadIdx.x) = sm.range;
  zero_hist<B>(t);
  cl.sync();
  ++barriers;
  if (threadIdx.x < 32) {
    range_identity(r);
    if (threadIdx.x < C) r = peer_range[threadIdx.x];
    warp_range<NS>(r);
    if (threadIdx.x == 0) make_plan(keys, r, sm.plan);
  }
  __syncthreads();
  stamp(sm, first, kInfoPlanNs);
  const Plan& p = sm.plan;
  const int route = data_route(keys, p, rows, kRouteCluster);
  int bits = p.bits, passes = 0, run = 0;
  unsigned skipped = 0;

  if (route == kRouteWarp || route == kRouteBlock) {
    segmented<B>(keys, p, route, L, rows, c, C, t, sm, out, &bits, &passes);
    run = passes;
  } else {
    // 2. the passes, least significant digit first
    passes = (p.bits + B - 1) / B;
    int win = 0;
    bool fresh = true;
    // a row to place g of the cluster: its CTA's tile
    auto send = [&](int g, uint64_t k, int32_t v) {
      const int to = g / rows;
      cl.map_shared_rank(t.row, to)[g - to * rows] = row_word(k, v);
    };
    for (int q = 0; q < passes; ++q) {
      const int o = q * B, par = q & 1;
      const int carried = win;
      const bool was_fresh = fresh;
      win = window_for<B>(o, carried);
      const bool rekey = win != carried;
      const int sh = o - win;
      stamp_phase(sm, first, q, 0);
      auto load = [&](int pos, uint64_t& k, int32_t& v) {
        if (was_fresh) {
          v = static_cast<int32_t>(base + pos);
          k = window_of(keys, p, v, win);
        } else {
          v = t.idx_at(pos);
          k = rekey ? window_of(keys, p, v, win) : t.key_at(pos);
        }
      };
      fresh = false;
      if (C == 1) {
        if (local_rank<B>(t, sm, n, sh, par, load)) skipped |= 1u << q;
        else ++run;
        stamp_pass(sm, first, q);
        continue;
      }
      Rows r;
      int seg = 0;
      local_count<B>(t, sm, n, sh, par, load, r, seg);
      stamp_phase(sm, first, q, 1);
      // this CTA's digit counts to every peer
      for (int x = threadIdx.x; x < C * R; x += kThreads)
        *cl.map_shared_rank(&peer_ctot[par][c][x % R], x / R) =
            sm.ctot[par][x % R];
      stamp_phase(sm, first, q, 2);
      cl.sync();
      ++barriers;
      stamp_phase(sm, first, q, 3);
      // each digit's start in the cluster, and this CTA's rows before it
      int32_t all = 0, before = 0;
      if (threadIdx.x < R) {
#pragma unroll
        for (int j = 0; j < kPeers; ++j) {
          if (j < C) {
            const int32_t m = peer_ctot[par][j][threadIdx.x];
            all += m;
            if (j < c) before += m;
          }
        }
      }
      const int32_t start = digit_scan<R>(all, sm.warp_sum);
      if (threadIdx.x < R)
        sm.obase[threadIdx.x] = start + before;
      const bool skip = __syncthreads_or(threadIdx.x < R && all == L);
      stamp_phase(sm, first, q, 4);
      if (skip) {
        // the rows keep their order: the tile is untouched (its window
        // and freshness as before); the warps' histogram rows zeroed
        skipped |= 1u << q;
        fresh = was_fresh;
        win = carried;
        for (int x = threadIdx.x & 31; x < R; x += 32)
          t.hist[(threadIdx.x >> 5) * R + x] = 0;
        stamp_pass(sm, first, q);
        continue;
      }
      local_place<B>(t, sm.obase, sh, seg, r, send);
      stamp_phase(sm, first, q, 5);
      cl.sync();
      ++barriers;
      stamp_phase(sm, first, q, 6);
      ++run;
      stamp_pass(sm, first, q);
    }
    for (int pos = threadIdx.x; pos < n; pos += kThreads)
      out[base + pos] = passes ? t.idx_at(pos)
                               : static_cast<int32_t>(base + pos);
  }
  if (first && threadIdx.x == 0) {
    stamp(sm, first, kInfoEndNs);
    write_info(info, sm, route, C, bits, passes, run, skipped, barriers,
               p.in_range, rows, 0, cmax);
  }
}

struct Layout {
  int64_t part, totals, status, key0, key1, idx0, idx1, bytes;
};

__host__ __device__ inline int64_t align16(int64_t x) {
  return (x + 15) / 16 * 16;
}

// Byte offsets in the grid route's scratch for L rows, G blocks, tiles of
// `rows`.
__host__ __device__ inline Layout grid_layout(int64_t L, int64_t G,
                                              int64_t rows) {
  constexpr int64_t R = int64_t(1) << kDigitBits;
  const int64_t tiles = (L + rows - 1) / rows;
  Layout o{};
  int64_t at = 0;
  o.part = at;
  at = align16(at + G * kRangeWords * 8);
  o.totals = at;
  at = align16(at + grid_max_passes() * R * 4);
  o.status = at;
  at = align16(at + 2 * tiles * R * 4);
  o.key0 = at;
  at = align16(at + L * 8);
  o.key1 = at;
  at = align16(at + L * 8);
  o.idx0 = at;
  at = align16(at + L * 4);
  o.idx1 = at;
  o.bytes = align16(at + L * 4);
  return o;
}

//: a published count: flag bit 31 beside a tile's count (< 2**31)
constexpr uint32_t kPublished = 1u << 31;

__device__ __forceinline__ void st_relaxed32(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ uint32_t ld_relaxed32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The rows before tile j per digit, without a chain: the tile publishes
// its digit counts (sm.ctot[0]) in `st` ([tiles][R], flag kPublished),
// then kThreads / R threads a digit sum the counts of tiles 0..j-1, each
// every (kThreads / R)-th tile, kLookBatch loads in flight at once and
// those not yet published polled again (a warp's loads are 32 digits of
// one tile: one line).  A tile waits only for its predecessors' local
// ranks, never for their sums.  Sets sm.obase = the digit's start + the
// rows before this tile - its staged start.
constexpr int kLookBatch = 16;

template <int B>
__device__ void look_back(uint32_t* st, int64_t j, Small<B>& sm) {
  constexpr int R = 1 << B, P = kThreads / R;
  const int d = threadIdx.x % R, part = threadIdx.x / R;
  if (threadIdx.x < R)
    st_relaxed32(st + j * R + d,
                 kPublished | static_cast<uint32_t>(sm.ctot[0][d]));
  uint32_t sum = 0;
  for (int64_t k0 = part; k0 < j; k0 += int64_t(P) * kLookBatch) {
    uint32_t w[kLookBatch];
#pragma unroll
    for (int x = 0; x < kLookBatch; ++x) {
      const int64_t k = k0 + int64_t(x) * P;
      w[x] = k < j ? ld_relaxed32(st + k * R + d) : kPublished;
    }
    for (bool missing = true; missing;) {
      missing = false;
#pragma unroll
      for (int x = 0; x < kLookBatch; ++x) {
        if (!(w[x] & kPublished)) {
          w[x] = ld_relaxed32(st + (k0 + int64_t(x) * P) * R + d);
          missing = true;
        }
      }
    }
#pragma unroll
    for (int x = 0; x < kLookBatch; ++x) sum += w[x] & ~kPublished;
  }
  sm.look[threadIdx.x] = static_cast<int32_t>(sum);
  __syncthreads();
  if (threadIdx.x < R) {
    int32_t before = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) before += sm.look[q * R + d];
    sm.obase[d] = sm.gstart[d] + before - sm.dbase[d];
  }
  __syncthreads();
}

// The grid route: one cooperative launch; tiles of `rows` (tile j on
// block j % G); scratch as `grid_layout`.
template <class K>
__global__ void __launch_bounds__(kThreads, 1)
    grid_kernel(K keys, int64_t L, int rows, int32_t* out, uint8_t* scratch,
                int32_t* info, int cmax) {
  constexpr int B = kDigitBits, R = 1 << B, NS = K::kRangeSlots;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Small<B> sm;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const Layout o = grid_layout(L, G, rows);
  int64_t* part = reinterpret_cast<int64_t*>(scratch + o.part);
  int32_t* totals = reinterpret_cast<int32_t*>(scratch + o.totals);
  uint32_t* status = reinterpret_cast<uint32_t*>(scratch + o.status);
  uint64_t* keys_buf[2] = {reinterpret_cast<uint64_t*>(scratch + o.key0),
                           reinterpret_cast<uint64_t*>(scratch + o.key1)};
  int32_t* idx_buf[2] = {reinterpret_cast<int32_t*>(scratch + o.idx0),
                         reinterpret_cast<int32_t*>(scratch + o.idx1)};
  const Tile t = tile_at<B>(dyn);
  const int64_t tiles = (L + rows - 1) / rows;
  const int64_t i0 = int64_t(b) * kThreads + threadIdx.x;
  const int64_t di = int64_t(G) * kThreads;
  const bool first = b == 0;
  int barriers = 0;
  stamps_start(sm);

  // 1. each key's range; the totals and both look-back rows zeroed
  Range r;
  range_identity(r);
#pragma unroll 4
  for (int64_t i = i0; i < L; i += di) range_add(keys, i, r);
  for (int64_t x = i0; x < grid_max_passes() * R; x += di) totals[x] = 0;
  for (int64_t j = b; j < tiles; j += G)
    for (int x = threadIdx.x; x < 2 * R; x += kThreads)
      status[((x / R) * tiles + j) * R + (x % R)] = 0;
  block_range<NS>(r, sm, sm.range);
  if (threadIdx.x == 0) {
    int64_t* w = part + int64_t(b) * kRangeWords;
    for (int k = 0; k < kSlots; ++k) {
      w[k] = sm.range.lo[k];
      w[kSlots + k] = sm.range.hi[k];
    }
    w[2 * kSlots] = sm.range.any_sentinel;
  }
  zero_hist<B>(t);
  grid.sync();
  ++barriers;
  range_identity(r);
  for (int64_t j = threadIdx.x; j < G; j += kThreads) {
    const int64_t* w = part + j * kRangeWords;
    Range m;
    for (int k = 0; k < kSlots; ++k) {
      m.lo[k] = ldcg64(w + k);
      m.hi[k] = ldcg64(w + kSlots + k);
    }
    m.any_sentinel = static_cast<int>(ldcg64(w + 2 * kSlots));
    range_merge<NS>(r, m);
  }
  block_range<NS>(r, sm, sm.range);
  if (threadIdx.x == 0) make_plan(keys, sm.range, sm.plan);
  __syncthreads();
  stamp(sm, first, kInfoPlanNs);
  const Plan& p = sm.plan;
  const int route = data_route(keys, p, rows, kRouteGrid);
  if (route == kRouteWarp || route == kRouteBlock) {
    int bits = 0, passes = 0;
    segmented<B>(keys, p, route, L, rows, b, G, t, sm, out, &bits, &passes);
    if (first && threadIdx.x == 0) {
      stamp(sm, first, kInfoEndNs);
      write_info(info, sm, route, G, bits, passes, passes, 0, barriers,
                 p.in_range, rows, static_cast<int>(tiles), cmax);
    }
    return;
  }

  // 2. one sweep: every pass's digit counts, into the totals (the
  // histogram rows hold them, then are zeroed again; the leader of each
  // warp's group of equal digits adds the group), and each row's low
  // composite word for the first pass (buffer 1)
  const int passes = (p.bits + B - 1) / B;
#pragma unroll 4
  for (int64_t i0w = i0 - (threadIdx.x & 31); i0w < L && passes > 0;
       i0w += di) {
    const int64_t i = i0w + (threadIdx.x & 31);
    uint64_t lo = 0, hi = 0;
    if (i < L) {
      composite(keys, p, i, lo, hi);
      keys_buf[1][i] = lo;
    }
    for (int q = 0; q < passes; ++q) {
      const int dg = i < L ? static_cast<int>(window(lo, hi, q * B) & (R - 1))
                           : R;
      const unsigned peers = peers_of<B>(dg);
      if (dg < R && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(t.hist + q * R + dg, __popc(peers));
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < passes * R; x += kThreads) {
    if (t.hist[x]) atomicAdd(totals + x, t.hist[x]);
    t.hist[x] = 0;
  }
  grid.sync();
  ++barriers;
  if (kStampPhases) stamp(sm, first, kInfoPassNs + 6);

  // the passes that move rows: a digit that holds every row is skipped
  // (every pass's totals loaded at once)
  unsigned mine = 0;
  if (threadIdx.x < R) {
#pragma unroll
    for (int q = 0; q < grid_max_passes(); ++q)
      if (q < passes && __ldcg(totals + q * R + threadIdx.x) == L)
        mine |= 1u << q;
  }
  if (threadIdx.x == 0) sm.skip = 0;
  __syncthreads();
  if (mine) atomicOr(&sm.skip, mine);
  __syncthreads();
  const unsigned skipped = sm.skip;
  int last = -1;
  for (int q = 0; q < passes; ++q)
    if (!(skipped & (1u << q))) last = q;

  // 3. the passes, least significant digit first
  int run = 0, win = 0;
  for (int q = 0; q < passes; ++q) {
    if (skipped & (1u << q)) continue;
    const int o = q * B;
    const int next = window_for<B>(o, win);
    const bool rekey = next != win;
    win = next;
    stamp_phase(sm, first, q, 0);
    // each digit's start over all rows
    const int32_t tot =
        threadIdx.x < R ? __ldcg(totals + q * R + threadIdx.x) : 0;
    const int32_t gstart = digit_scan<R>(tot, sm.warp_sum);
    if (threadIdx.x < R) sm.gstart[threadIdx.x] = gstart;
    // the look-back row of this run; the other one, used the run before,
    // zeroed for the next
    uint32_t* st = status + int64_t(run & 1) * tiles * R;
    if (run > 0)
      for (int64_t j = b; j < tiles; j += G)
        for (int x = threadIdx.x; x < R; x += kThreads)
          status[(int64_t((run + 1) & 1) * tiles + j) * R + x] = 0;
    stamp_phase(sm, first, q, 1);
    const uint64_t* src_key = keys_buf[(run + 1) & 1];
    const int32_t* src_idx = idx_buf[(run + 1) & 1];
    for (int64_t j = b; j < tiles; j += G) {
      const int64_t row0 = j * rows;
      const int n = static_cast<int>(lmin(rows, L - row0));
      local_rank<B>(t, sm, n, o - win, 0,
                    [&](int pos, uint64_t& k, int32_t& v) {
                      const int64_t at = row0 + pos;
                      if (run == 0) {
                        v = static_cast<int32_t>(at);
                        k = rekey ? window_of(keys, p, at, win)
                                  : static_cast<uint64_t>(__ldcg(
                                        reinterpret_cast<const unsigned long long*>(
                                            src_key + at)));
                      } else {
                        v = __ldcg(src_idx + at);
                        k = rekey ? window_of(keys, p, v, win)
                                  : static_cast<uint64_t>(__ldcg(
                                        reinterpret_cast<const unsigned long long*>(
                                            src_key + at)));
                      }
                    });
      stamp_phase(sm, first, q, 2);
      look_back<B>(st, j, sm);
      stamp_phase(sm, first, q, 3);
      // the staged runs to their places
      for (int pos = threadIdx.x; pos < n; pos += kThreads) {
        const uint64_t k = t.key_at(pos);
        const int dg = static_cast<int>((k >> (o - win)) & (R - 1));
        const int g = sm.obase[dg] + pos;
        if (q == last) {
          out[g] = t.idx_at(pos);
        } else {
          keys_buf[run & 1][g] = k;
          idx_buf[run & 1][g] = t.idx_at(pos);
        }
      }
      __syncthreads();
    }
    stamp_phase(sm, first, q, 4);
    if (q != last) {
      grid.sync();
      ++barriers;
    }
    stamp_phase(sm, first, q, 5);
    if (kStampPhases && run == 0) stamp(sm, first, kInfoPassNs + 7);
    stamp_pass(sm, first, q);
    ++run;
  }
  if (run == 0)
    for (int64_t i = i0; i < L; i += di) out[i] = static_cast<int32_t>(i);
  if (first && threadIdx.x == 0) {
    stamp(sm, first, kInfoEndNs);
    write_info(info, sm, kRouteGrid, G, p.bits, passes, run, skipped,
               barriers, p.in_range, rows, static_cast<int>(tiles), cmax);
  }
}

// Per device: the largest cluster the card schedules (0: none) and the
// grid's co-resident blocks.  Filled once under g_state_mutex, then
// published by a release store of g_ready[dev]; read only after an
// acquire load of it finds true, so a thread sees all of a device's
// state or none of it.
struct DeviceState {
  int cluster_max;
  int grid_blocks;
};
std::mutex g_state_mutex;
std::atomic<bool> g_ready[kMaxDevices];
DeviceState g_state[kMaxDevices];  // guarded-by: g_state_mutex

int current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < 0 || *dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  return 0;
}

template <class K>
int set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      cluster_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tile_bytes<kDigitBits>(kTileMax)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cluster_kernel<K>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        grid_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_bytes<kDigitBits>(kTileMax)));
  return static_cast<int>(e);
}

// Whether one cluster of `size` CTAs of cluster_kernel<K> at its largest
// tile fits the card.
template <class K>
int cluster_fits(int size, bool* fits) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = tile_bytes<kDigitBits>(kTileMax);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = size;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<void*>(cluster_kernel<K>), &cfg);
  if (e != cudaSuccess) {
    // a size the card refuses (above 8 without the non-portable sizes)
    (void)cudaGetLastError();
    *fits = false;
    return size == 1 ? static_cast<int>(e) : 0;
  }
  *fits = clusters >= 1;
  return 0;
}

// The device's routes, asked for once: attributes set, the largest
// cluster and the grid.  A failure stores nothing, so the next call asks
// again.  Caller holds g_state_mutex.
int init_state(int dev, DeviceState* out) {
  int err = set_attributes<SiblingKeys>();
  if (!err) err = set_attributes<RegisterKeys>();
  if (err) return err;
  int size = kClusterMax;
  for (; size >= 1; size /= 2) {
    bool a = false, b = false;
    err = cluster_fits<SiblingKeys>(size, &a);
    if (!err) err = cluster_fits<RegisterKeys>(size, &b);
    if (err) return err;
    if (a && b) break;
  }
  int coop = 0, sms = 0, pa = 0, pb = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop,
                                         cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = tile_bytes<kDigitBits>(kTileMax);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &pa, grid_kernel<SiblingKeys>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &pb, grid_kernel<RegisterKeys>, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_sm = pa < pb ? pa : pb;
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  out->cluster_max = size > 0 ? size : 0;
  out->grid_blocks = sms * per_sm;
  return 0;
}

// The device's state, filled at its first call from any thread; after
// that one acquire load and no lock.
int device_state(int dev, const DeviceState** out) {
  if (!g_ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_state_mutex);
    if (!g_ready[dev].load(std::memory_order_relaxed)) {
      DeviceState s;
      const int err = init_state(dev, &s);
      if (err) return err;
      g_state[dev] = s;
      g_ready[dev].store(true, std::memory_order_release);
    }
  }
  *out = &g_state[dev];
  return 0;
}

int64_t cluster_capacity(const DeviceState& s) {
  return int64_t(s.cluster_max) * kTileMax;
}

int grid_rows(int64_t L, int G) {
  const int64_t per = (L + G - 1) / G;
  return static_cast<int>(per < kTileMax ? per : kTileMax);
}

template <class K>
int launch(const K& keys, int64_t L, void* out, void* scratch, void* info,
           void* stream) {
  if (L <= 0) return 0;
  if (L > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  int err = current_device(&dev);
  if (err) return err;
  const DeviceState* st = nullptr;
  err = device_state(dev, &st);
  if (err) return err;
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* inf = static_cast<int32_t*>(info);
  if (L <= cluster_capacity(*st)) {
    int C = 1;
    while (C < st->cluster_max && int64_t(C) * kClusterRows < L) C *= 2;
    const int rows = static_cast<int>((L + C - 1) / C);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = tile_bytes<kDigitBits>(rows);
    cfg.stream = s;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = C;
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, cluster_kernel<K>, keys,
                                               L, rows, o, inf,
                                               st->cluster_max));
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int G = st->grid_blocks;
  int rows = grid_rows(L, G);
  K k = keys;
  int64_t n = L;
  uint8_t* scr = static_cast<uint8_t*>(scratch);
  int cmax = st->cluster_max;
  void* args[] = {&k, &n, &rows, &o, &scr, &inf, &cmax};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(grid_kernel<K>), dim3(G), dim3(kThreads), args,
      tile_bytes<kDigitBits>(rows), s));
}

}  // namespace

// Bytes of scratch a sort of L rows needs on the current device (either
// entry point): 0 on the cluster route, which needs none and is not
// cooperative; above it the grid route's (`grid_layout`), a cooperative
// launch.  -1 on a CUDA error.
extern "C" int64_t amtpu_torch_lexsort_scratch(int64_t L) {
  if (L <= 0) return 0;
  int dev = 0;
  const DeviceState* st = nullptr;
  if (current_device(&dev) || device_state(dev, &st)) return -1;
  if (L <= cluster_capacity(*st)) return 0;
  return grid_layout(L, st->grid_blocks, grid_rows(L, st->grid_blocks))
      .bytes;
}

// obj/parent/ctr/actor [L] int32, valid [L] bool; writes out [L] int32,
// the permutation of np.lexsort((-actor, -ctr, parent, where(valid, obj,
// 2**30))).  scratch: amtpu_torch_lexsort_scratch(L) bytes, 16-byte
// aligned (null when 0).  info: null or kInfoWords int32, the route
// readout.  Returns a cudaError_t.
extern "C" int amtpu_torch_sibling_sort(const void* obj, const void* parent,
                                        const void* ctr, const void* actor,
                                        const void* valid, void* out,
                                        void* scratch, void* info, int64_t L,
                                        void* stream) {
  SiblingKeys k{static_cast<const int32_t*>(obj),
                static_cast<const int32_t*>(parent),
                static_cast<const int32_t*>(ctr),
                static_cast<const int32_t*>(actor),
                static_cast<const bool*>(valid)};
  return launch(k, L, out, scratch, info, stream);
}

// rg/rt [D, T] int32 (rows d * T + t); writes out [D * T] int32, the
// rows by (d * (n_groups + 1) + rg + 1, rt), stable.  scratch:
// amtpu_torch_lexsort_scratch(D * T) bytes; info as above.  Returns a
// cudaError_t.
extern "C" int amtpu_torch_register_sort(const void* rg, const void* rt,
                                         void* out, void* scratch,
                                         void* info, int64_t D, int64_t T,
                                         int64_t n_groups, void* stream) {
  if (D < 0 || T < 0 || n_groups < 0 || (T > 0 && D > INT64_MAX / T))
    return static_cast<int>(cudaErrorInvalidValue);
  RegisterKeys k{static_cast<const int32_t*>(rg),
                 static_cast<const int32_t*>(rt), T, n_groups};
  return launch(k, D * T, out, scratch, info, stream);
}
