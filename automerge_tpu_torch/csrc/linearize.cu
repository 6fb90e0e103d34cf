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
// A round that changes nothing leaves a fixpoint, so each loop stops
// after its first such round and the result is the plain version's at
// any n_iters.  Every gather index is clamped as the plain version
// clamps it: invalid rows may carry any parent and object.  Sums wrap
// as int32 (the plain version's arithmetic).
//
// Design: one launch, no host read, no allocation, no synchronize.  The
// work is a chain of dependent rounds (about log2 of the longest
// sibling chain, nesting depth and list, plus four phases), each a
// gather over the L elements, so the time is the rounds' barriers and
// gather latency, not bytes.  The eager plain version issues every
// round from the host as several torch launches (about 380 a call).
//  - L <= kOneCtaMax (route a): one block of 1,024 threads holds the
//    state in shared memory, a double-buffered int2 pair (16 bytes an
//    element; a pair moves as one 8-byte access), and __syncthreads_or
//    ends each round, telling every thread whether it changed anything.
//    The first-child links wait in the output row, which the last phase
//    overwrites.
//  - larger L (route b): one cooperative launch of at most as many
//    blocks as are resident at once (SMs x occupancy), grid-stride
//    loops, a grid barrier between phases and rounds, a flag a round in
//    global memory (three, rotated) for the early stop.  The state lives
//    in a scratch the wrapper allocates (amtpu_torch_linearize_scratch);
//    rounds read it from L2 (ld.global.cg): another SM wrote it.
//
// Bound: bytes, 17 an element (obj, parent, sort_idx and the rank at 4,
// valid at 1, each moved once): 0.08 us at L = 16,384 and 2 us at
// 393,216 on 3.35 TB/s, under the launch and the barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
//: route (a)'s largest L (192 KB of state; the block's 227 KB would hold
//: 14,528): one SM's shared-memory rounds keep up with route (b)'s grid
//: up to about here on an H100 (both routes timed from 64 to 14,336)
constexpr int64_t kOneCtaMax = 12288;
constexpr int kMaxDevices = 64;

struct Cols {
  const int32_t* obj;
  const int32_t* parent;
  const bool* valid;
  const int32_t* sort_idx;
  int32_t* rank;
  int64_t L;
  int64_t n_iters;
};

// Route (a): one block, state in shared memory, block barriers.
struct BlockSync {
  int32_t* extra;  // valid rows whose clamped object is L
  __device__ int64_t first() const { return threadIdx.x; }
  __device__ int64_t stride() const { return blockDim.x; }
  __device__ bool leader() const { return threadIdx.x == 0; }
  __device__ int32_t ld(const int32_t* p) const { return *p; }
  __device__ int2 ld(const int2* p) const { return *p; }
  __device__ void reset() const {}
  __device__ void barrier() const { __syncthreads(); }
  __device__ bool any(bool changed, int64_t) const {
    return __syncthreads_or(changed) != 0;
  }
};

// Route (b): the cooperative grid, state in global memory.
struct GridSync {
  int32_t* extra;
  int32_t* flags;  // round k sets flags[k % 3] when it changed anything
  __device__ int64_t first() const {
    return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  }
  __device__ int64_t stride() const {
    return static_cast<int64_t>(gridDim.x) * blockDim.x;
  }
  __device__ bool leader() const {
    return blockIdx.x == 0 && threadIdx.x == 0;
  }
  __device__ int32_t ld(const int32_t* p) const { return __ldcg(p); }
  __device__ int2 ld(const int2* p) const { return __ldcg(p); }
  __device__ void reset() const { flags[0] = flags[1] = flags[2] = 0; }
  __device__ void barrier() const { cg::this_grid().sync(); }
  // flags[(k + 1) % 3] was last read by round k - 2's check, which every
  // thread finished before the barrier that ended round k - 1
  __device__ bool any(bool changed, int64_t k) const {
    const int slot = static_cast<int>(k % 3);
    if (leader()) flags[(slot + 1) % 3] = 0;
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicOr(flags + slot, 1);
    cg::this_grid().sync();
    return __ldcg(flags + slot) != 0;
  }
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// The whole function over two state rows of L int2 pairs, a double
// buffer: (esc, link) during the escapes, then (nxt, dist) during the
// ranking; each pair moves as one 8-byte load or store.  `S` is the
// route.
template <class S>
__device__ void linearize_body(const Cols& c, int2* cur, int2* nxt,
                               const S& sync) {
  const int64_t L = c.L;
  const int64_t i0 = sync.first(), di = sync.stride();
  if (sync.leader()) sync.reset();

  // 1a. sorted rows: the group keys (obj, parent) into nxt; the
  // first-child row cleared
  for (int64_t r = i0; r < L; r += di) {
    const int32_t si = c.sort_idx[r];
    const bool v = si >= 0 && si < L && c.valid[si];
    nxt[r] = v ? make_int2(c.obj[si], c.parent[si]) : make_int2(-2, -3);
    c.rank[r] = -1;
  }
  sync.barrier();

  // 1b. sibling links: the escapes' start and links into cur in arena
  // order, and each group's first row as its parent's first child
  for (int64_t r = i0; r < L; r += di) {
    const int32_t si = c.sort_idx[r];
    if (si < 0 || si >= L) continue;
    const int2 key = sync.ld(nxt + r);
    bool next_same = false, prev_same = false;
    if (r + 1 < L) {
      const int2 k1 = sync.ld(nxt + r + 1);
      next_same = k1.x == key.x && k1.y == key.y;
    }
    if (r > 0) {
      const int2 k0 = sync.ld(nxt + r - 1);
      prev_same = k0.x == key.x && k0.y == key.y;
    }
    const int32_t par = c.parent[si];
    cur[si] = make_int2(
        next_same ? c.sort_idx[r + 1] : (par == -1 ? -2 : -1), par);
    if (!prev_same && key.y >= 0 && key.y < L) c.rank[key.y] = si;
  }
  sync.barrier();

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
    const bool more = sync.any(changed, k++);
    int2* t = cur; cur = nxt; nxt = t;
    if (!more) break;
  }

  // 3. dfs_next and the hop counts, in place: (nxt, dist) over cur
  for (int64_t i = i0; i < L; i += di) {
    const int32_t e = sync.ld(cur + i).x, fc = sync.ld(c.rank + i);
    const int32_t d = !c.valid[i] ? -1 : fc >= 0 ? fc : (e == -2 ? -1 : e);
    cur[i] = make_int2(d, d >= 0 ? 1 : 0);
  }
  sync.barrier();

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
    const bool more = sync.any(changed, k++);
    int2* t = cur; cur = nxt; nxt = t;
    if (!more) break;
  }

  // 4. object sizes in the free buffer (objects clamped to [0, L]; L in
  // `extra`), then the rank
  int32_t* size = reinterpret_cast<int32_t*>(nxt);
  for (int64_t i = i0; i < L; i += di) size[i] = 0;
  if (sync.leader()) *sync.extra = 0;
  sync.barrier();
  for (int64_t i = i0; i < L; i += di) {
    if (!c.valid[i]) continue;
    const int32_t o = c.obj[i];
    atomicAdd(o >= L ? sync.extra : size + (o > 0 ? o : 0), 1);
  }
  sync.barrier();
  for (int64_t i = i0; i < L; i += di) {
    const int32_t o = c.obj[i];
    const int32_t n = sync.ld(o >= L ? sync.extra : size + (o > 0 ? o : 0));
    const uint32_t d = static_cast<uint32_t>(sync.ld(cur + i).y);
    c.rank[i] = c.valid[i]
                    ? static_cast<int32_t>(static_cast<uint32_t>(n) - 1u - d)
                    : -1;
  }
}

__global__ void __launch_bounds__(kThreads) one_cta_kernel(Cols c) {
  extern __shared__ int2 sm[];
  __shared__ int32_t extra;
  linearize_body(c, sm, sm + c.L, BlockSync{&extra});
}

// scratch: the two state rows (2 L pairs), then `extra` and the flags
__global__ void __launch_bounds__(kThreads) grid_kernel(Cols c,
                                                        int32_t* scratch) {
  const int64_t L = c.L;
  int2* rows = reinterpret_cast<int2*>(scratch);
  linearize_body(c, rows, rows + L,
                 GridSync{scratch + 4 * L, scratch + 4 * L + 1});
}

// Per device: route (a)'s shared-memory attribute set, route (b)'s
// co-resident blocks (0: not yet asked).
bool g_smem_set[kMaxDevices];
int g_grid_blocks[kMaxDevices];

}  // namespace

// int32 words of scratch the call needs at L (0 on route a).
extern "C" int64_t amtpu_torch_linearize_scratch(int64_t L) {
  return L > kOneCtaMax ? 4 * L + 4 : 0;
}

// obj/parent/sort_idx [L] int32, valid [L] bool; writes rank [L] int32.
// scratch: amtpu_torch_linearize_scratch(L) int32 words (none on route
// a).  n_iters >= 0.  Returns a cudaError_t.
extern "C" int amtpu_torch_linearize(const void* obj, const void* parent,
                                     const void* valid, const void* sort_idx,
                                     void* rank, void* scratch, int64_t L,
                                     int64_t n_iters, void* stream) {
  if (L <= 0) return 0;
  if (n_iters < 0 || L > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c{static_cast<const int32_t*>(obj), static_cast<const int32_t*>(parent),
         static_cast<const bool*>(valid),
         static_cast<const int32_t*>(sort_idx), static_cast<int32_t*>(rank),
         L, n_iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (L <= kOneCtaMax) {
    if (!g_smem_set[dev]) {
      e = cudaFuncSetAttribute(
          one_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(16 * kOneCtaMax));
      if (e != cudaSuccess) return static_cast<int>(e);
      g_smem_set[dev] = true;
    }
    one_cta_kernel<<<1, kThreads, 16 * L, s>>>(c);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (g_grid_blocks[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_kernel,
                                                      kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    g_grid_blocks[dev] = sms * per_sm;
  }
  const int64_t want = (L + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(
      want < g_grid_blocks[dev] ? want : g_grid_blocks[dev]);
  int32_t* scr = static_cast<int32_t*>(scratch);
  void* args[] = {&c, &scr};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(grid_kernel), dim3(blocks), dim3(kThreads),
      args, 0, s));
}
