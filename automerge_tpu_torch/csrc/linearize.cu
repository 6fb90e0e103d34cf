// RGA list linearization on Hopper: the total element order of every
// list object in one launch.
//
// Replaces automerge_tpu/ops/list_rank.py::linearize, which the JAX
// package leaves to XLA (its two pointer-doubling loops are
// lax.fori_loops inside one jitted dispatch); same contract as the plain
// version automerge_tpu_torch/ops/list_rank.py::linearize, given the
// sibling sort `sort_idx` (a permutation of [0, L)):
//  1. sibling links, in sorted order: a row's next sibling is the next
//     sorted row when the two share (obj, parent), an invalid row keying
//     as obj -2 and parent -3; the first row of each group with parent
//     >= 0 is its parent's first child (on well-formed input a parent is
//     the target of one group: its children share its object);
//  2. escapes: esc = the next sibling, else -2 at a head (parent -1),
//     else -1 (unresolved), and link = parent; n_iters + 1 synchronous
//     rounds, each reading the previous round's state:
//       where esc[i] == -1 and link[i] >= 0, with j = min(link[i], L - 1):
//         esc[i] <- esc[j] if esc[j] != -1;  link[i] <- link[j]
//  3. ranking: nxt = the first child, else the escape (-2 read as -1),
//     -1 on an invalid row; dist = (nxt >= 0); n_iters synchronous
//     rounds of dist[i] += dist[j], nxt[i] <- nxt[j] where nxt[i] >= 0,
//     j = min(nxt[i], L - 1);
//  4. rank = size(o) - 1 - dist on valid rows, -1 elsewhere, with
//     o = clamp(obj, 0, L) and size(o) the valid rows of that o.
// Every gather index is clamped as the plain version clamps it: invalid
// rows may carry any parent and object.  Sums wrap as int32.
//
// Two routes of one launch compute that function; which one runs is
// decided on the card from phase 1's by-products, with no host read:
//  - the tour (list ranking), where every valid row is well formed
//    (0 <= obj < L; parent -1, or a valid row of the same object with a
//    smaller index: the valid rows form a forest per object) and no
//    object has more than 2**n_iters rows (at each object's first sorted
//    row, the row 2**n_iters later is of another object).  There the
//    rounds converge: a row's escape distance is at most its depth, at
//    most size - 1, so the n_iters + 1 escape rounds (pointer jumping:
//    2**(n_iters + 1) ancestors) resolve every escape; the dfs list of
//    an object is its preorder, one path of size rows, and Wyllie's
//    ranking after n rounds counts min(hops, 2**n) with hops <= size - 1.
//    So dist is the count of rows after the row in its object's
//    preorder, and rank is the row's preorder position, which the tour
//    computes directly.  Every caller passes ceil_log2(largest object)
//    + 1 rounds on such an arena;
//  - the rounds otherwise (malformed rows, n_iters too short for a
//    converged result): phases 2-4 as written, each loop stopping after
//    its first round that changed nothing (a fixpoint), so the result is
//    the plain version's at any n_iters.
//
// The tour.  Row v has a down half-edge 2v and an up half-edge 2v + 1;
// the successor of down(v) is down(first child), else up(v); of up(v)
// down(next sibling), else up(parent), else END.  A row's node pair
// holds its two successors (8 bytes; a walk loads two rows' at once, one
// 16-byte load, as a chain steps to the next row).  Each object's tour
// starts at down of its first head; a row's rank is the count of down
// half-edges before its own.  Splitters: every start and, in each window
// of 2**lk rows, one row's down and one row's up at offsets hashed from
// the window (level-1 slots 2w and 2w + 1; a chain's downs and ups each
// meet one a window, where a plain stride of the half-edge index would
// put every splitter on one parity).  Walk 1, from each splitter to the
// next: the slot reached gets (its predecessor splitter, the downs
// between), each down row (its owner splitter, the downs before it).
// The slots' prefix sums: route (a) by pointer doubling in the block;
// route (b) by a second level of the same scheme (slots hashed one down
// and one up in each window of 2**log_k2 slot pairs, and the tails,
// slots whose walk ended a tour, walk back to the previous such slot,
// giving each slot passed its link: that splitter, the downs between),
// then those splitters, at most kTopCap in shared memory, by pointer
// doubling in the last block through the level-2 walks.  A last
// parallel pass adds each row's offset to its owner's prefix sum.  O(L)
// work; route (b) runs 4 grid barriers at every L.  The time is the
// passes, the barriers and the longest walk's
// dependent loads: a chain's walks meet a splitter within two windows, a
// random tree's within about window x ln(slots) (tools/
// linearize_routes.py prints each phase's end from the readout).
//
// Design: one launch, no host read, no allocation, no synchronize.
//  - L <= kOneCtaMax (route a): one block of 1,024 threads holds the
//    state in shared memory, about 16 bytes an element (the node pairs;
//    the sorted keys, then the slots and each row's owner and offset, or
//    the rounds' second state row); block barriers.
//  - larger L (route b): one cooperative launch of as many blocks as are
//    resident at once (SMs x occupancy), grid-stride loops (the walks
//    spread over every block), grid barriers, the state in a scratch the
//    wrapper allocates (amtpu_torch_linearize_scratch); what another SM
//    wrote is read from L2 (ld.global.cg).  The rounds route keeps a
//    flag a round in global memory (three, rotated) for the early stop.
// An optional int32 readout `info` (kInfoWords; nullptr on the main path)
// gets the route taken, the barriers run, the longest walks, the ranked
// splitters and doubling rounds, why the rounds ran, and each phase's
// end (ns from the start, the leader's clock).
//
// Bound: bytes, 17 an element (obj, parent, sort_idx and the rank at 4,
// valid at 1, each moved once): 0.08 us at L = 16,384 and 2 us at
// 393,216 on 3.35 TB/s, under the launch, the barriers and the walks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
//: route (a)'s largest L (about 16 bytes an element in shared memory;
//: the block's 227 KB would hold 14,336): one SM is ahead of route (b)'s
//: grid on chains up to about 8,192 and on forests up to 6,144 on an
//: H100 (tools/linearize_routes.py)
constexpr int64_t kOneCtaMax = 8192;
//: the list-ranking route (tools/linearize_routes.py builds the kernel
//: with it off to time the rounds route on the same inputs)
constexpr bool kTour = true;
//: level-1 splitters: one down and one up in each window of 2**lk rows;
//: route (a) takes lk = kTourLogK (8 rows); route (b) takes 2 to 8 rows,
//: as many as keep the level-2 walks and the level-1 walks about equal
//: (grid_log_k)
constexpr int kTourLogK = 3;
//: route (b)'s level-2 window: 2**log_k2 slot pairs, log_k2 >= kL2MinLog
//: and large enough that the hashed level-2 slots fill at most half of
//: kTopCap (a window of 4 keeps short arenas' doubling rounds few:
//: tools/linearize_routes.py --define kL2MinLog=...)
constexpr int kL2MinLog = 2;
//: the level-2 splitters route (b) ranks in shared memory (two int2
//: rows: 192 KB); more are ranked in global memory by the same block
constexpr int kTopCap = 12288;
constexpr uint32_t kSalt1 = 0x9E3779B9u;
constexpr uint32_t kSalt2 = 0x7F4A7C15u;
//: the largest L is kMaxTourL - 1: 2 L half-edge indices below 2**31,
//: END and the start bit apart
constexpr int64_t kMaxTourL = int64_t(1) << 30;
constexpr uint32_t kEnd = 0x7FFFFFFFu;
constexpr uint32_t kStartBit = 0x80000000u;
//: a slot's predecessor: the object's start, or no walker reached it
constexpr int32_t kStart = -1;
constexpr int32_t kDead = -2;
constexpr int kMaxDevices = 64;

//: the readout's words (tests/torch_linearize_cases.py: INFO_*)
constexpr int kInfoWords = 16;
enum {
  kInfoRoute,      // 1 the tour, 0 the rounds
  kInfoGrid,       // 1 route (b), 0 route (a)
  kInfoBarriers,   // grid barriers (route b) or block barriers (route a)
  kInfoWalk1,      // the longest walk over the tour (steps)
  kInfoWalk2,      // the longest walk over the level-1 slots (route b)
  kInfoTop,        // splitters ranked by pointer doubling
  kInfoTopRounds,  // its rounds
  kInfoWhy,        // why the rounds: kBadRow | kBigObject (0: the tour)
  kInfoStamps,     // ns from the start to barrier 1, 2, ... (5 words)
  kInfoTopLoaded = 13,  // route (b): the top's block has them loaded
  kInfoTopDone,         // and ranked (that block's clock)
  kInfoEnd,        // ns from the start to the last phase's end
};
//: rows a thread loads at once in the phase-1 passes
constexpr int kU = 4;
//: what sends a call to the rounds: a valid row not well formed, an
//: object of more than 2**n_iters rows
constexpr int32_t kBadRow = 1;
constexpr int32_t kBigObject = 2;

struct Cols {
  const int32_t* obj;
  const int32_t* parent;
  const bool* valid;
  const int32_t* sort_idx;
  int32_t* rank;
  int32_t* info;
  int64_t L;
  int64_t n_iters;
};

// Words both routes keep beside the state.
struct Counters {
  int32_t extra;     // valid rows whose clamped object is L (rounds)
  int32_t why;       // kBadRow | kBigObject as seen
  int32_t n_top;     // route (b)'s level-2 splitters
  int32_t done;      // route (b)'s blocks through the level-2 walks
  int32_t flags[3];  // route (b)'s rounds: round k changed anything
};

// Route (a): one block, state in shared memory, block barriers.
struct BlockSync {
  Counters* k;
  __device__ int64_t first() const { return threadIdx.x; }
  __device__ int64_t stride() const { return blockDim.x; }
  __device__ bool leader() const { return threadIdx.x == 0; }
  // the walks' order: consecutive items on different blocks
  __device__ int64_t spread() const { return threadIdx.x; }
  template <class T> __device__ T ld(const T* p) const { return *p; }
  __device__ void barrier() const { __syncthreads(); }
  __device__ bool any(bool changed, int64_t) const {
    return __syncthreads_or(changed) != 0;
  }
};

// Route (b): the cooperative grid, state in global memory.
struct GridSync {
  Counters* k;
  __device__ int64_t first() const {
    return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  }
  __device__ int64_t stride() const {
    return static_cast<int64_t>(gridDim.x) * blockDim.x;
  }
  __device__ bool leader() const {
    return blockIdx.x == 0 && threadIdx.x == 0;
  }
  // the walks' order: consecutive items on different blocks, so a short
  // list of walkers still spreads over every SM
  __device__ int64_t spread() const {
    return static_cast<int64_t>(threadIdx.x) * gridDim.x + blockIdx.x;
  }
  template <class T> __device__ T ld(const T* p) const { return __ldcg(p); }
  __device__ void barrier() const { cg::this_grid().sync(); }
  // flags[(k + 1) % 3] was last read by round k - 2's check, which every
  // thread finished before the barrier that ended round k - 1
  __device__ bool any(bool changed, int64_t r) const {
    const int slot = static_cast<int>(r % 3);
    if (leader()) k->flags[(slot + 1) % 3] = 0;
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicOr(k->flags + slot, 1);
    cg::this_grid().sync();
    return __ldcg(k->flags + slot) != 0;
  }
};

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The barriers run and, with a readout, when each ended (the leader's
// clock).
struct Phases {
  int32_t* info;
  uint64_t t0;
  int n = 0;
  __device__ explicit Phases(int32_t* i) : info(i), t0(i ? now_ns() : 0) {}
  template <class S> __device__ void mark(const S& sync) {
    ++n;
    if (info && sync.leader() && n <= kInfoTopLoaded - kInfoStamps)
      info[kInfoStamps + n - 1] = static_cast<int32_t>(now_ns() - t0);
  }
  template <class S> __device__ void bar(const S& sync) {
    sync.barrier();
    mark(sync);
  }
  template <class S> __device__ bool any(const S& sync, bool c, int64_t r) {
    const bool more = sync.any(c, r);
    mark(sync);
    return more;
  }
  template <class S> __device__ void end(const S& sync) {
    if (info && sync.leader())
      info[kInfoEnd] = static_cast<int32_t>(now_ns() - t0);
  }
};

// an input flag through the read-only path
__device__ __forceinline__ bool ld_flag(const bool* p, int64_t i) {
  return __ldg(reinterpret_cast<const unsigned char*>(p) + i) != 0;
}

// the readout's longest walk: one atomic a warp
__device__ __forceinline__ void note_max(int32_t* info, int word,
                                         int32_t v) {
  v = __reduce_max_sync(0xffffffffu, v);
  if (info && v && (threadIdx.x & 31) == 0) atomicMax(info + word, v);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// level-1 slots of an arena of L rows: two a window of 2**lk rows
__host__ __device__ __forceinline__ int64_t n_slots(int64_t L, int lk) {
  return 2 * ((L + (int64_t(1) << lk) - 1) >> lk);
}

// the half-edge of level-1 slot s
__device__ __forceinline__ uint32_t slot_edge(uint32_t s, int lk) {
  const uint32_t v = ((s >> 1) << lk) + (mix32(s + kSalt1) & ((1u << lk) - 1));
  return 2u * v + (s & 1u);
}

// the slot of half-edge h, and whether h is that slot's splitter
__device__ __forceinline__ uint32_t edge_slot(uint32_t h, int lk) {
  return (((h >> 1) >> lk) << 1) | (h & 1u);
}
__device__ __forceinline__ bool is_split(uint32_t h, int lk) {
  const uint32_t m = (1u << lk) - 1;
  return ((h >> 1) & m) == (mix32(edge_slot(h, lk) + kSalt1) & m);
}

// whether level-1 slot s is a level-2 splitter
__device__ __forceinline__ bool is_l2(uint32_t s, int log_k2) {
  const uint32_t w = s >> 1, m = (1u << log_k2) - 1u;
  return (w & m) ==
         (mix32((((w >> log_k2) << 1) | (s & 1u)) + kSalt2) & m);
}

__host__ __device__ __forceinline__ int l2_log(int64_t M1) {
  int b = kL2MinLog;
  while ((M1 + (int64_t(1) << b) - 1) >> b > kTopCap / 2) ++b;
  return b;
}

// route (b)'s level-1 window: 2**lk rows, lk = ceil(log2(the windows
// the hashed level-2 splitters would need)) / 2 rounded up, in [1, 3]
__host__ __device__ __forceinline__ int grid_log_k(int64_t L) {
  const int64_t ratio = (2 * L + kTopCap / 2 - 1) / (kTopCap / 2);
  int b = 0;
  while ((int64_t(1) << b) < ratio) ++b;
  const int lk = (b + 1) / 2;
  return lk < 1 ? 1 : lk > kTourLogK ? kTourLogK : lk;
}

// Row v's node pair: x the successor of down(v) (kEnd: v is invalid), y
// the successor of up(v) with kStartBit where v starts its object's
// tour.
__device__ __forceinline__ bool is_row(int2 e) {
  return static_cast<uint32_t>(e.x) != kEnd;
}
__device__ __forceinline__ bool is_start(int2 e) {
  return static_cast<uint32_t>(e.y) & kStartBit;
}

struct Walk {
  uint32_t at;  // the splitter reached, or kEnd
  int32_t downs;
  int32_t steps;
};

// Node pairs are read two at a time (16 bytes, one load): a chain's walk
// steps to the next or previous row, often the other half of the pair.
// The node rows start 16-byte aligned and hold an even count.
__host__ __device__ __forceinline__ int64_t even(int64_t L) {
  return (L + 1) & ~int64_t(1);
}

struct PairCache {
  uint32_t have = 0xFFFFFFFFu;
  int4 pr;
  template <class S>
  __device__ int2 get(const int2* nodes, uint32_t v, const S& sync) {
    if ((v >> 1) != have) {
      have = v >> 1;
      pr = sync.ld(reinterpret_cast<const int4*>(nodes) + have);
    }
    return (v & 1u) ? make_int2(pr.z, pr.w) : make_int2(pr.x, pr.y);
  }
};

// A walk from half-edge h to the next splitter or END, handing each down
// half-edge's row and the downs before it to emit(v, downs).  On input
// outside the contract (sort_idx not a permutation) it also stops after
// 2 L steps, so no input hangs the card.
template <class S, class Emit>
__device__ Walk walk(const int2* nodes, uint32_t h, PairCache& pc, int64_t L,
                     int lk, const S& sync, Emit emit) {
  int32_t downs = 0, steps = 0;
  for (;;) {
    const int2 e = pc.get(nodes, h >> 1, sync);
    uint32_t nx;
    if (h & 1u) {
      nx = static_cast<uint32_t>(e.y) & kEnd;
    } else {
      emit(h >> 1, downs);
      ++downs;
      nx = static_cast<uint32_t>(e.x);
    }
    ++steps;
    if (nx == kEnd || is_split(nx, lk)) return Walk{nx, downs, steps};
    if (steps > 2 * L) return Walk{kEnd, downs, steps};
    h = nx;
  }
}

// Phase 1 of both routes: the sorted keys (a valid row's object outside
// [0, L) is malformed), then the node pairs, the rest of the
// well-formedness check and, at each object's first sorted row, whether
// the row 2**n_iters after it is still of that object.  kU rows a thread
// at once, their loads issued together.
template <class S>
__device__ void phase1(const Cols& c, int2* keys, int2* nodes, const S& sync,
                       Phases& ph) {
  const int64_t L = c.L;
  const int64_t i0 = sync.first(), di = sync.stride();
  Counters* k = sync.k;
  if (sync.leader()) {
    k->extra = k->why = k->n_top = k->done = 0;
    k->flags[0] = k->flags[1] = k->flags[2] = 0;
    if (c.info)
      for (int j = 0; j < kInfoWords; ++j) c.info[j] = 0;
  }
  int32_t why = 0;
  for (int64_t base = i0; base < L; base += kU * di) {
    int32_t si[kU];
    bool vr[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const int64_t r = base + j * di;
      si[j] = r < L ? __ldg(c.sort_idx + r) : -1;
      vr[j] = r < L && ld_flag(c.valid, r);
    }
    int2 key[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const bool v = si[j] >= 0 && si[j] < L && ld_flag(c.valid, si[j]);
      key[j] = v ? make_int2(__ldg(c.obj + si[j]), __ldg(c.parent + si[j]))
                 : make_int2(-2, -3);
      if (v && (key[j].x < 0 || key[j].x >= L)) why |= kBadRow;
    }
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const int64_t r = base + j * di;
      if (r >= L) break;
      keys[r] = key[j];
      nodes[r] = make_int2(
          static_cast<int32_t>(vr[j] ? static_cast<uint32_t>(2 * r + 1)
                                     : kEnd),
          static_cast<int32_t>(kEnd));
    }
  }
  if (why) atomicOr(&k->why, why);
  ph.bar(sync);
  why = 0;
  const int64_t span = c.n_iters < 31 ? int64_t(1) << c.n_iters : L;
  for (int64_t base = i0; base < L; base += kU * di) {
    int32_t si[kU], ns[kU];
    int2 key[kU], k0[kU];
    bool next_same[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const int64_t r = base + j * di;
      si[j] = r < L ? __ldg(c.sort_idx + r) : -1;
      ns[j] = r + 1 < L ? __ldg(c.sort_idx + r + 1) : -1;
      key[j] = r < L ? sync.ld(keys + r) : make_int2(-2, -3);
      const int2 k1 = r + 1 < L ? sync.ld(keys + r + 1) : make_int2(-4, -4);
      k0[j] = r > 0 && r < L ? sync.ld(keys + r - 1) : make_int2(-4, -4);
      next_same[j] = k1.x == key[j].x && k1.y == key[j].y;
    }
    // a group's parent: a valid row of the group's object (the group's
    // first row asks); an object's first row: the row 2**n_iters later
    bool pok[kU], big[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const int64_t r = base + j * di;
      const int32_t par = key[j].y;
      const bool first = k0[j].x != key[j].x || k0[j].y != key[j].y;
      const bool ask = si[j] >= 0 && si[j] < L && key[j].x >= 0 && first &&
                       par >= 0 && par < L;
      pok[j] = !ask ||
              (ld_flag(c.valid, par) && __ldg(c.obj + par) == key[j].x);
      big[j] = key[j].x >= 0 && k0[j].x != key[j].x && r + span < L &&
               sync.ld(keys + r + span).x == key[j].x;
    }
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      if (si[j] < 0 || si[j] >= L) continue;
      const int32_t par = key[j].y;
      const bool prev_same = k0[j].x == key[j].x && k0[j].y == key[j].y;
      // a valid row with its object in range (the others are invalid or
      // already malformed)
      const bool vv = key[j].x >= 0;
      uint32_t up = next_same[j]
                        ? 2u * static_cast<uint32_t>(ns[j])
                        : (vv && par >= 0 && par < L
                               ? 2u * static_cast<uint32_t>(par) + 1u
                               : kEnd);
      if (vv && !prev_same && par == -1) up |= kStartBit;
      reinterpret_cast<int32_t*>(nodes + si[j])[1] = static_cast<int32_t>(up);
      if (!prev_same && par >= 0 && par < L)
        reinterpret_cast<int32_t*>(nodes + par)[0] = 2 * si[j];
      if (vv && !((par == -1 || (par >= 0 && par < si[j])) && pok[j]))
        why |= kBadRow;
      if (big[j]) why |= kBigObject;
    }
  }
  if (why) atomicOr(&k->why, why);
  ph.bar(sync);
}

template <class S>
__device__ bool takes_tour(const S& sync) {
  return kTour && sync.ld(&sync.k->why) == 0;
}

// The rounds route (phases 2-4 as the header writes them) over two int2
// rows of L, the node pairs in `nxt` on entry.
template <class S>
__device__ void rounds_route(const Cols& c, int2* cur, int2* nxt,
                             const S& sync, Phases& ph) {
  const int64_t L = c.L;
  const int64_t i0 = sync.first(), di = sync.stride();
  // (esc, link) into cur, the first children into the rank row
  for (int64_t i = i0; i < L; i += di) {
    const int2 e = sync.ld(nxt + i);
    const uint32_t up = static_cast<uint32_t>(e.y) & kEnd;
    const int32_t par = c.parent[i];
    const int32_t ns =
        up != kEnd && !(up & 1u) ? static_cast<int32_t>(up >> 1) : -1;
    cur[i] = make_int2(ns >= 0 ? ns : (par == -1 ? -2 : -1), par);
    c.rank[i] = (e.x & 1) ? -1 : e.x >> 1;
  }
  ph.bar(sync);

  // 2. escapes: Jacobi rounds of (esc, link) from cur into nxt
  int64_t k = 0;  // rounds run (route b's flag rotation)
  for (int64_t it = 0; it <= c.n_iters; ++it) {
    bool changed = false;
    for (int64_t i = i0; i < L; i += di) {
      int2 v = sync.ld(cur + i);
      if (v.x == -1 && v.y >= 0) {
        const int2 w = sync.ld(cur + (v.y < L ? v.y : L - 1));
        changed |= w.x != -1 || w.y != v.y;
        if (w.x != -1) v.x = w.x;
        v.y = w.y;
      }
      nxt[i] = v;
    }
    const bool more = ph.any(sync, changed, k++);
    int2* t = cur; cur = nxt; nxt = t;
    if (!more) break;
  }

  // 3. dfs_next and the hop counts, in place: (nxt, dist) over cur
  for (int64_t i = i0; i < L; i += di) {
    const int32_t e = sync.ld(cur + i).x, fc = sync.ld(c.rank + i);
    const int32_t d = !c.valid[i] ? -1 : fc >= 0 ? fc : (e == -2 ? -1 : e);
    cur[i] = make_int2(d, d >= 0 ? 1 : 0);
  }
  ph.bar(sync);

  // list ranking: Jacobi rounds of (nxt, dist) from cur into nxt
  for (int64_t it = 0; it < c.n_iters; ++it) {
    bool changed = false;
    for (int64_t i = i0; i < L; i += di) {
      int2 v = sync.ld(cur + i);
      if (v.x >= 0) {
        const int2 w = sync.ld(cur + (v.x < L ? v.x : L - 1));
        changed |= w.y != 0 || w.x != v.x;
        v = make_int2(w.x, wrap_add(v.y, w.y));
      }
      nxt[i] = v;
    }
    const bool more = ph.any(sync, changed, k++);
    int2* t = cur; cur = nxt; nxt = t;
    if (!more) break;
  }

  // 4. object sizes in the free buffer (objects clamped to [0, L]; L in
  // `extra`), then the rank
  int32_t* size = reinterpret_cast<int32_t*>(nxt);
  for (int64_t i = i0; i < L; i += di) size[i] = 0;
  if (sync.leader()) sync.k->extra = 0;
  ph.bar(sync);
  for (int64_t i = i0; i < L; i += di) {
    if (!c.valid[i]) continue;
    const int32_t o = c.obj[i];
    atomicAdd(o >= L ? &sync.k->extra : size + (o > 0 ? o : 0), 1);
  }
  ph.bar(sync);
  for (int64_t i = i0; i < L; i += di) {
    const int32_t o = c.obj[i];
    const int32_t n =
        sync.ld(o >= L ? &sync.k->extra : size + (o > 0 ? o : 0));
    const uint32_t d = static_cast<uint32_t>(sync.ld(cur + i).y);
    c.rank[i] = c.valid[i]
                    ? static_cast<int32_t>(static_cast<uint32_t>(n) - 1u - d)
                    : -1;
  }
}

// Walk 1 from every splitter: at the slot reached, (the walker's slot or
// kStart, the downs from the walker's half-edge to it), and each down
// row's owner splitter and the downs before it in the sublist
// (emit(v, owner, downs)).  A slot walker that reaches END marks its slot
// a tail (route b).  Returns whether a slot got a slot as its
// predecessor.
template <class S, class Emit>
__device__ bool walk1(const Cols& c, const int2* nodes, int2* rec,
                      int32_t* tail, int lk, const S& sync, Emit emit) {
  const int64_t L = c.L, M1 = n_slots(L, lk);
  const int64_t di = sync.stride();
  int32_t longest = 0;
  bool linked = false;
  // each slot's splitter: a valid row's down (unless it starts the tour:
  // the start's walker covers that sublist) or up
  for (int64_t s = sync.spread(); s < M1; s += di) {
    const uint32_t h = slot_edge(static_cast<uint32_t>(s), lk);
    if ((h >> 1) >= L) continue;
    PairCache pc;
    const int2 e = pc.get(nodes, h >> 1, sync);
    if (!is_row(e) || (!(h & 1u) && is_start(e))) continue;
    const int32_t owner = static_cast<int32_t>(s);
    const Walk w = walk(nodes, h, pc, L, lk, sync,
                        [&](uint32_t v, int32_t d) { emit(v, owner, d); });
    longest = max(longest, w.steps);
    if (w.at == kEnd) {
      if (tail) tail[s] = 1;
    } else {
      rec[edge_slot(w.at, lk)] = make_int2(owner, w.downs);
      linked = true;
    }
  }
  for (int64_t v = sync.first(); v < L; v += di) {
    PairCache pc;
    if (!is_start(pc.get(nodes, static_cast<uint32_t>(v), sync))) continue;
    const Walk w = walk(nodes, static_cast<uint32_t>(2 * v), pc, L, lk, sync,
                        [&](uint32_t u, int32_t d) { emit(u, kStart, d); });
    longest = max(longest, w.steps);
    if (w.at != kEnd) rec[edge_slot(w.at, lk)] = make_int2(kStart, w.downs);
  }
  note_max(c.info, kInfoWalk1, longest);
  return linked;
}

// Pointer doubling over n (predecessor, count) pairs in cur (nxt: the
// second buffer) by one block: each pair's count summed with every pair
// before it.  Returns the buffer holding the sums; *rounds the rounds
// (at most 32: chains are shorter than 2**31).
__device__ __forceinline__ int2* block_double(int2* cur, int2* nxt, int n,
                                              bool more, int* rounds) {
  int r = 0;
  while (more && r < 32) {
    bool again = false;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int2 a = cur[i];
      if (a.x >= 0) {
        const int2 b = cur[a.x];
        a = make_int2(b.x, wrap_add(a.y, b.y));
        again |= b.x >= 0;
      }
      nxt[i] = a;
    }
    more = __syncthreads_or(again) != 0;
    int2* t = cur; cur = nxt; nxt = t;
    ++r;
  }
  *rounds = r;
  return cur;
}

__device__ void write_info(const Cols& c, bool tour, bool grid, int nb,
                           int64_t top, int rounds, int32_t why) {
  c.info[kInfoRoute] = tour;
  c.info[kInfoGrid] = grid;
  c.info[kInfoBarriers] = nb;
  c.info[kInfoTop] = static_cast<int32_t>(top);
  c.info[kInfoTopRounds] = rounds;
  c.info[kInfoWhy] = why;
}

// Route (a)'s shared memory in bytes: the node pairs (an even count of
// int2), then the keys (L int2), which become the slots' two doubling
// rows (2 M1 int2) and each row's owner and offset (L int32), or the
// rounds' state.
__host__ __device__ __forceinline__ int64_t one_cta_smem(int64_t L) {
  const int64_t tour = 16 * n_slots(L, kTourLogK) + 4 * L;
  return 8 * even(L) + (tour > 8 * L ? tour : 8 * L);
}

// route (a)'s packed owner and offset: (slot + 1) << kOwnerShift | downs
constexpr int kOwnerShift = 18;

__global__ void __launch_bounds__(kThreads) one_cta_kernel(Cols c) {
  extern __shared__ int4 sm4[];
  __shared__ Counters k;
  const BlockSync sync{&k};
  const int64_t L = c.L, M1 = n_slots(L, kTourLogK);
  int2* nodes = reinterpret_cast<int2*>(sm4);
  int2* keys = nodes + even(L);
  Phases ph(c.info);
  phase1(c, keys, nodes, sync, ph);
  if (!takes_tour(sync)) {
    rounds_route(c, keys, nodes, sync, ph);
    if (c.info && sync.leader()) write_info(c, false, false, ph.n, 0, 0,
                                            k.why);
    ph.end(sync);
    return;
  }
  int2* rec = keys;
  int32_t* own = reinterpret_cast<int32_t*>(keys + 2 * M1);
  for (int64_t s = threadIdx.x; s < M1; s += blockDim.x)
    rec[s] = make_int2(kDead, 0);
  ph.bar(sync);
  const bool linked = walk1(c, nodes, rec, nullptr, kTourLogK, sync,
                            [&](uint32_t v, int32_t owner, int32_t d) {
    own[v] = ((owner + 1) << kOwnerShift) | d;
  });
  const bool more = ph.any(sync, linked, 0);
  int rounds;
  const int2* sums = block_double(rec, rec + M1, static_cast<int>(M1), more,
                                  &rounds);
  ph.n += rounds;
  for (int64_t v = threadIdx.x; v < L; v += blockDim.x) {
    if (!is_row(nodes[v])) {
      c.rank[v] = -1;
      continue;
    }
    const int32_t w = own[v], owner = (w >> kOwnerShift) - 1;
    c.rank[v] = wrap_add(w & ((1 << kOwnerShift) - 1),
                         owner >= 0 ? sums[owner].y : 0);
  }
  if (c.info && sync.leader())
    write_info(c, true, false, ph.n, M1, rounds, 0);
  ph.end(sync);
}

// Route (b)'s scratch, in int32 words: the node pairs (an even count of
// int2, 16-byte aligned), the keys (L int2; with the node pairs the
// rounds' two state rows), each row's (owner splitter, offset) (L int2),
// per level-1 slot (M1) its record (predecessor, downs) and its level-2
// link (the id of the level-2 splitter after it, the downs between), per
// level-2 splitter its record (predecessor slot, downs) and two doubling
// rows; then per slot its tail flag and level-2 id, per level-2 splitter
// its prefix sum, the counters.
struct Scratch {
  int2* nodes;
  int2* keys;
  int2* ol;
  int2* rec1;
  int2* up2;
  int2* rec2;
  int2* dbl;
  int32_t* tail;
  int32_t* id;
  int32_t* ptop;
  Counters* k;
  __host__ __device__ static int64_t words(int64_t L) {
    return 2 * even(L) + 4 * L + 13 * n_slots(L, grid_log_k(L)) + 8;
  }
  __device__ Scratch(int32_t* w, int64_t L) {
    const int64_t M1 = n_slots(L, grid_log_k(L));
    nodes = reinterpret_cast<int2*>(w);
    keys = nodes + even(L);
    ol = keys + L;
    rec1 = ol + L;
    up2 = rec1 + M1;
    rec2 = up2 + M1;
    dbl = rec2 + M1;
    tail = reinterpret_cast<int32_t*>(dbl + 2 * M1);
    id = tail + M1;
    ptop = id + M1;
    k = reinterpret_cast<Counters*>(ptop + M1);
  }
};

// Route (b)'s top, by one block: the level-2 splitters' (predecessor id,
// downs) into cur (2 n int2), 8 records a thread loaded at once, their
// prefix sums by pointer doubling, into ptop.  Inlined at each call, so
// the compiler knows which memory `cur` is in.
__device__ __forceinline__ void top_rank(const Cols& c, const Scratch& w,
                                         int2* cur, int n, uint64_t t0,
                                         int* rounds) {
  bool linked = false;
  constexpr int kR = 8;
  for (int b = threadIdx.x; b < n; b += kR * blockDim.x) {
    int2 r[kR];
    int32_t p[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int i = b + j * blockDim.x;
      r[j] = i < n ? __ldcg(w.rec2 + i) : make_int2(kDead, 0);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j)
      p[j] = r[j].x >= 0 ? __ldcg(w.id + r[j].x) : -1;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int i = b + j * blockDim.x;
      if (i < n) cur[i] = make_int2(p[j], r[j].y);
      linked |= p[j] >= 0;
    }
  }
  const bool more = __syncthreads_or(linked) != 0;
  if (c.info && threadIdx.x == 0)
    c.info[kInfoTopLoaded] = static_cast<int32_t>(now_ns() - t0);
  const int2* sums = block_double(cur, cur + n, n, more, rounds);
  if (c.info && threadIdx.x == 0)
    c.info[kInfoTopDone] = static_cast<int32_t>(now_ns() - t0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) w.ptop[i] = sums[i].y;
}

__global__ void __launch_bounds__(kThreads) grid_kernel(Cols c,
                                                        int32_t* words) {
  extern __shared__ int4 sm4[];
  const int64_t L = c.L;
  const int lk = grid_log_k(L);
  const int64_t M1 = n_slots(L, lk);
  const Scratch w(words, L);
  const GridSync sync{w.k};
  const int64_t i0 = sync.first(), di = sync.stride();
  Phases ph(c.info);
  for (int64_t s = i0; s < M1; s += di) {
    w.rec1[s] = make_int2(kDead, 0);
    w.tail[s] = 0;
  }
  phase1(c, w.keys, w.nodes, sync, ph);
  if (!takes_tour(sync)) {
    rounds_route(c, w.keys, w.nodes, sync, ph);
    if (c.info && sync.leader())
      write_info(c, false, true, ph.n, 0, 0, __ldcg(&w.k->why));
    ph.end(sync);
    return;
  }
  walk1(c, w.nodes, w.rec1, w.tail, lk, sync,
        [&](uint32_t v, int32_t owner, int32_t d) {
    w.ol[v] = make_int2(owner, d);
  });
  ph.bar(sync);

  // level 2: each hashed live slot and each tail takes an id, then walks
  // back to the previous hashed slot or the start, summing the downs and
  // giving each slot it passes its link (this id, the downs between)
  const int log_k2 = l2_log(M1);
  int32_t longest = 0;
  for (int64_t s = sync.spread(); s < M1; s += di) {
    int2 q = __ldcg(w.rec1 + s);
    if (q.x == kDead ||
        !(is_l2(static_cast<uint32_t>(s), log_k2) || __ldcg(w.tail + s)))
      continue;
    const int32_t id = atomicAdd(&w.k->n_top, 1);
    w.id[s] = id;
    w.up2[s] = make_int2(id, 0);
    int32_t acc = 0, steps = 0;
    for (;;) {
      acc = wrap_add(acc, q.y);
      ++steps;
      if (q.x < 0 || is_l2(static_cast<uint32_t>(q.x), log_k2) ||
          steps > M1)
        break;
      w.up2[q.x] = make_int2(id, acc);
      q = __ldcg(w.rec1 + q.x);
    }
    w.rec2[id] = make_int2(q.x, acc);
    longest = max(longest, steps);
  }
  note_max(c.info, kInfoWalk2, longest);

  // the level-2 splitters' prefix sums by pointer doubling in the last
  // block through the level-2 walks (every other block's records fenced
  // before it counted itself done): in shared memory up to kTopCap, else
  // in the scratch
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&w.k->done, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    const int n = __ldcg(&w.k->n_top);
    int rounds = 0;
    if (n <= kTopCap)
      top_rank(c, w, reinterpret_cast<int2*>(sm4), n, ph.t0, &rounds);
    else
      top_rank(c, w, w.dbl, n, ph.t0, &rounds);
    if (c.info && threadIdx.x == 0) {
      c.info[kInfoTop] = n;
      c.info[kInfoTopRounds] = rounds;
    }
  }
  ph.bar(sync);

  // each row's rank: its offset in its sublist plus its owner's prefix
  // sum (the owner's level-2 splitter's, less the downs between)
  for (int64_t v = i0; v < L; v += di) {
    if (!ld_flag(c.valid, v)) {
      c.rank[v] = -1;
      continue;
    }
    const int2 o = __ldcg(w.ol + v);
    int32_t p = 0;
    if (o.x >= 0) {
      const int2 u = __ldcg(w.up2 + o.x);
      p = wrap_add(__ldcg(w.ptop + u.x), -u.y);
    }
    c.rank[v] = wrap_add(o.y, p);
  }
  if (c.info && sync.leader()) {
    c.info[kInfoRoute] = 1;
    c.info[kInfoGrid] = 1;
    c.info[kInfoBarriers] = ph.n;
  }
  ph.end(sync);
}

//: route (b)'s dynamic shared memory: the level-2 splitters
constexpr int kGridSmem = 16 * kTopCap;

// Per device: route (b)'s co-resident blocks.  Set once under
// g_state_mutex, after both kernels' shared-memory attributes, then
// published by a release store of g_ready[dev]; a launch reads it, or
// launches either kernel, only after an acquire load of it finds true.
std::mutex g_state_mutex;
std::atomic<bool> g_ready[kMaxDevices];
int g_grid_blocks[kMaxDevices];  // guarded-by: g_state_mutex

// The device's launch state, set at its first call from any thread: the
// shared-memory attributes of both routes and route (b)'s co-resident
// blocks.  A failure publishes nothing, so the next call tries again.
// After the first call: one acquire load and no lock.
int device_ready(int dev) {
  if (g_ready[dev].load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(g_state_mutex);
  if (g_ready[dev].load(std::memory_order_relaxed)) return 0;
  cudaError_t e = cudaSuccess;
  if (kOneCtaMax > 0) {
    e = cudaFuncSetAttribute(one_cta_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(one_cta_smem(kOneCtaMax)));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaFuncSetAttribute(grid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGridSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int coop = 0, sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_kernel,
                                                    kThreads, kGridSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  g_grid_blocks[dev] = sms * per_sm;
  g_ready[dev].store(true, std::memory_order_release);
  return 0;
}

}  // namespace

// int32 words of scratch the call needs at L (0 on route a).
extern "C" int64_t amtpu_torch_linearize_scratch(int64_t L) {
  return L > kOneCtaMax ? Scratch::words(L) : 0;
}

// obj/parent/sort_idx [L] int32, valid [L] bool; writes rank [L] int32.
// scratch: amtpu_torch_linearize_scratch(L) int32 words (none on route
// a).  info: nullptr, or kInfoWords int32 the kernel fills (the route
// readout).  n_iters >= 0, L < 2**30.  Returns a cudaError_t.
extern "C" int amtpu_torch_linearize(const void* obj, const void* parent,
                                     const void* valid, const void* sort_idx,
                                     void* rank, void* scratch, void* info,
                                     int64_t L, int64_t n_iters,
                                     void* stream) {
  if (L <= 0) return 0;
  if (n_iters < 0 || L >= kMaxTourL)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c{static_cast<const int32_t*>(obj), static_cast<const int32_t*>(parent),
         static_cast<const bool*>(valid),
         static_cast<const int32_t*>(sort_idx), static_cast<int32_t*>(rank),
         static_cast<int32_t*>(info), L, n_iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int err = device_ready(dev);
  if (err) return err;
  if (L <= kOneCtaMax) {
    one_cta_kernel<<<1, kThreads, one_cta_smem(L), s>>>(c);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(g_grid_blocks[dev]);
  int32_t* scr = static_cast<int32_t*>(scratch);
  void* args[] = {&c, &scr};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(grid_kernel), dim3(blocks), dim3(kThreads),
      args, kGridSmem, s));
}
