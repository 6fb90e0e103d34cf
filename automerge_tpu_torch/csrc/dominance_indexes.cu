// Whole-doc dominance indexes on Hopper: the step's list-index route.
//
// Replaces automerge_tpu/ops/list_rank.py::dominance_indexes (single-
// device form, vmapped over docs), which the JAX package leaves to XLA;
// same contract as the plain version automerge_tpu_torch/ops/
// list_rank.py::dominance_indexes at `chunk`:
//   index(t) = #{e : obj(e) = o_t, rank(e) < r_t, visible just before t}
// counted the way the JAX scan counts it, chunk by chunk.
//
// Each doc decides on the card which of two branches it takes; the
// wrapper reads nothing back.  A doc "regroups" when every element has
// 0 <= obj < L, vis0 in {0, 1} and -1 <= rank < (elements of its
// object); every valid op touches an element 0 <= e < L whose object and
// rank are the op's; every invalid op has obj -2 and delta 0 (as
// parallel/mesh.py makes them).  Then an op's index does not depend on
// the chunking: its object's visible elements of lower rank at batch
// start plus the deltas of the earlier valid ops of its object at lower
// rank (invalid ops: 0).  That is the fast branch.  Any other doc takes
// the chunk-scan branch, the JAX scan's walk at `chunk`:
//   base[k] = sum over elements l of vis[l] * (obj[l] == o[k]) *
//             (rank[l] < r[k])            -- at the chunk's start
//   corr[k] = sum over earlier ops j of the chunk of d[j] * (o[j] == o[k])
//             * (r[j] < r[k])             -- valid or not
//   index[k] = int(base[k] + corr[k]); then vis[e[j]] += d[j] for the
//   chunk's valid ops j with 0 <= e[j] < L
// in float32, as the scan (exact for integer-valued sums below 2^24).
// Each doc adds one to its branch's device counter.
//
// Fast branch, long docs (L > 32 or T > 32), two launches:
//  - prep_kernel, one block per doc: the regroup test, then dense
//    positions.  An object o spans count(o) + 1 positions from
//    start(o) = sum over o' < o of (count(o') + 1), an element sits at
//    start(obj) + rank + 1, so "same object, lower rank" is the position
//    range [start(o_t), pos_t) and the 2L positions hold every doc.  The
//    block writes each visible element's position and each valid op's
//    position and object start.
//  - query_kernel, one block per (doc, chunk of kChunk ops): the count
//    of each position at the chunk's start (the visible elements plus
//    the deltas of the earlier chunks' ops) is rebuilt with shared-memory
//    atomics, window by window of at most kWindow positions, and scanned
//    (exclusive prefix H, a carry across windows); an op at position p
//    with object start lo then has index H(p) - H(lo) plus the deltas of
//    its own chunk's earlier ops at positions in [lo, p), walked in
//    shared memory.  Chunks run in parallel on as many SMs; each reads
//    the doc's positions once per window, so the work is chunks x L plus
//    T^2 / (2 kChunk), all of it shared-memory traffic but the reads.
// Fast branch, short docs (L <= 32 and T <= 32; the step's many-doc
// batches): one warp per doc, eight docs to a block, everything in
// registers; lane l holds element l and op l and the counts are warp
// shuffles over the 32 lanes.  One launch.
// The chunk-scan branch runs in the same launch that decided it (prep or
// the warp kernel): the whole block walks that doc's chunks.
//
// Bound: bytes on the fast branch (each column read once; the positions
// are re-read from L2 by every chunk's block); the chunk-scan branch is
// operations (L x T compares per doc) and is off the step's path.  The
// per-doc work in one block (prep) is latency-bound on one SM, so it is
// kept to the test and the positions; a prefix table of the deltas over
// (chunk, position tile) would put its scans and atomics there too,
// while each chunk's block rebuilds its own start state in parallel.
// Counts are exact int32 on the fast branch; the plain version's float32
// sums are exact below 2^24, so the integers agree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
//: ops per query block: the fast branch's time chunk
constexpr int kChunk = 256;
//: positions a query block counts in shared memory at once
constexpr int64_t kWindow = 49152;
//: docs (warps) per block of the short-doc kernel
constexpr int kWarps = 8;
//: items a thread loads before it uses any (the prep's passes are
//: latency-bound on one SM)
constexpr int kUnroll = 4;
//: dynamic shared memory a block may ask for (bytes): the card's 227 KB
//: less room for the kernels' static arrays
constexpr int64_t kSmemMax = 226 * 1024;

__host__ __device__ inline int64_t pad(int64_t i) { return i + (i >> 5); }

// Per-doc scratch of the long-doc kernels (int32 words):
//   start [L + 1]  object counts, then starts  | elem_pos [L] | op_pos [T]
//   | op_lo [T]; one flag per doc after the D docs.
struct Layout {
  int64_t L, T, nC, W, per_doc;
};

__host__ __device__ inline Layout layout(int64_t L, int64_t T) {
  Layout g;
  g.L = L;
  g.T = T;
  g.nC = (T + kChunk - 1) / kChunk;
  g.W = 2 * L < kWindow ? 2 * L : kWindow;
  if (g.W < 1) g.W = 1;
  g.per_doc = (L + 1) + L + 2 * T;
  return g;
}

inline bool short_docs(int64_t L, int64_t T) { return L <= 32 && T <= 32; }

__device__ __forceinline__ int32_t warp_inclusive(int32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive prefix of one value a thread over the block; `red` is 32
// words of shared memory; *total gets the block's sum.  The caller
// barriers before `red` is written again.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* red,
                                              int32_t* total) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = (blockDim.x + 31) >> 5;
  const int32_t incl = warp_inclusive(v);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = lane < nw ? red[lane] : 0;
    red[lane] = warp_inclusive(w);
  }
  __syncthreads();
  *total = red[nw - 1];
  return (warp ? red[warp - 1] : 0) + incl - v;
}

//: items a thread per tile of `tiled_exclusive_scan`
constexpr int kItems = 8;

// Shared words `tiled_exclusive_scan` needs at `threads` a block.
__host__ __device__ inline int64_t scan_tile_words(int threads) {
  const int64_t n = static_cast<int64_t>(threads) * kItems;
  return n + n / 32;
}

// In-place exclusive prefix of (x[i] + add) over x[0, n) (device or
// shared memory) by the whole block: tiles of blockDim * kItems words
// come in and go out with coalesced accesses through `tile` (shared,
// padded against bank conflicts); each thread scans kItems contiguous
// words of the tile, the block scans the threads' sums, a carry runs
// across tiles.  Ends with a barrier.
__device__ void tiled_exclusive_scan(int32_t* x, int64_t n, int32_t add,
                                      int32_t* red, int32_t* tile) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t span = static_cast<int64_t>(nt) * kItems;
  int32_t carry = 0;
  for (int64_t base = 0; base < n; base += span) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * nt + tid;
      tile[pad(j)] = base + j < n ? x[base + j] + add : 0;
    }
    __syncthreads();
    int32_t v[kItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      v[k] = tile[pad(tid * kItems + k)];
      sum += v[k];
    }
    int32_t total;
    int32_t run = carry + block_scan(sum, red, &total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      tile[pad(tid * kItems + k)] = run;
      run += v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * nt + tid;
      if (base + j < n) x[base + j] = tile[pad(j)];
    }
    carry += total;
    __syncthreads();
  }
}

// atomicAdd(base + key, 1) from every lane with key >= 0, one atomic per
// distinct key of the warp (a doc's elements crowd into few objects).
// Every lane of the warp must call it.
__device__ __forceinline__ void warp_count(int32_t* base, int64_t key) {
  const unsigned grp = __match_any_sync(kFull, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(grp) - 1)
    atomicAdd(base + key, __popc(grp));
}

// In-place exclusive prefix of x[0, n) held padded (x[pad(i)]) in shared
// memory, by the whole block, each thread a contiguous run (the padding
// keeps a warp's runs on distinct banks); returns the total.  Ends with a
// barrier.
__device__ int32_t padded_exclusive_scan(int32_t* x, int64_t n,
                                         int32_t* red) {
  const int nt = blockDim.x;
  const int64_t per = (n + nt - 1) / nt;
  const int64_t lo = threadIdx.x * per < n ? threadIdx.x * per : n;
  const int64_t hi = lo + per < n ? lo + per : n;
  int32_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += x[pad(i)];
  int32_t total;
  int32_t off = block_scan(sum, red, &total);
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t v = x[pad(i)];
    x[pad(i)] = off;
    off += v;
  }
  __syncthreads();
  return total;
}

struct Cols {
  const int32_t* eo;
  const int32_t* er;
  const float* vis0;
  const int32_t* oe;
  const int32_t* oo;
  const int32_t* orr;
  const int32_t* od;
  const bool* ov;
  int32_t* index;
};

// The chunk-scan branch for doc d by the whole block: `v` is an [L]
// float row of scratch, `sh` 3 * K words of shared memory.
__device__ void scan_doc(const Cols& c, int64_t d, int64_t L, int64_t T,
                         int K, float* v, int32_t* sh) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int32_t* eo = c.eo + d * L;
  const int32_t* er = c.er + d * L;
  int32_t* s_obj = sh;
  int32_t* s_rank = sh + K;
  int32_t* s_delta = sh + 2 * K;
  for (int64_t l = tid; l < L; l += nt) v[l] = c.vis0[d * L + l];
  __syncthreads();
  for (int64_t c0 = 0; c0 < T; c0 += K) {
    for (int k = tid; k < K; k += nt) {
      const int64_t t = c0 + k;
      const bool real = t < T;
      s_obj[k] = real ? c.oo[d * T + t] : -2;
      s_rank[k] = real ? c.orr[d * T + t] : -1;
      s_delta[k] = real ? c.od[d * T + t] : 0;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) {
      const int64_t t = c0 + k;
      if (t >= T) continue;
      const int32_t o = s_obj[k];
      const int32_t r = s_rank[k];
      float base = 0.0f;
      for (int64_t l = 0; l < L; ++l)
        if (eo[l] == o && er[l] < r) base += v[l];
      float corr = 0.0f;
      for (int j = 0; j < k; ++j)
        if (s_obj[j] == o && s_rank[j] < r)
          corr += static_cast<float>(s_delta[j]);
      c.index[d * T + t] = static_cast<int32_t>(base + corr);
    }
    __syncthreads();  // every base read before any update
    for (int k = tid; k < K; k += nt) {
      const int64_t t = c0 + k;
      if (t < T && c.ov[d * T + t]) {
        const int32_t e = c.oe[d * T + t];
        if (e >= 0 && e < L) atomicAdd(v + e, static_cast<float>(s_delta[k]));
      }
    }
    __syncthreads();  // updates visible to the next chunk
  }
}

// -- long docs ------------------------------------------------------------

__global__ void __launch_bounds__(1024)
prep_kernel(Cols c, int32_t* __restrict__ scratch,
            int32_t* __restrict__ flags,
            unsigned long long* __restrict__ branch, Layout g, int K,
            int front, bool start_in_smem) {
  // [front words: the chunk-scan branch's 3 * K, or the scan's tile]
  // [L + 1 words: the object counts and starts, when they fit]
  extern __shared__ int32_t s_dyn[];
  __shared__ int32_t red[32];
  const int64_t d = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t L = g.L, T = g.T;
  const int64_t stride = static_cast<int64_t>(nt) * kUnroll;
  const int32_t* eo = c.eo + d * L;
  const int32_t* er = c.er + d * L;
  const float* vis = c.vis0 + d * L;
  const int32_t* oe = c.oe + d * T;
  const int32_t* oo = c.oo + d * T;
  const int32_t* orr = c.orr + d * T;
  const int32_t* od = c.od + d * T;
  const bool* ov = c.ov + d * T;
  int32_t* g_start = scratch + d * g.per_doc;
  int32_t* elem_pos = g_start + L + 1;
  int32_t* op_pos = elem_pos + L;
  int32_t* op_lo = op_pos + T;
  int32_t* start = start_in_smem ? s_dyn + front : g_start;

  // -- the regroup test (object counts first) --
  for (int64_t o = tid; o < L; o += nt) start[o] = 0;
  __syncthreads();
  bool ok = true;
  // whole warps walk the loop that calls warp_count
  for (int64_t l0 = 0; l0 < L; l0 += stride) {
    int32_t o[kUnroll], r[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t l = l0 + u * nt + tid;
      o[u] = l < L ? __ldg(eo + l) : 0;
      r[u] = l < L ? __ldg(er + l) : -1;
      v[u] = l < L ? __ldg(vis + l) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = l0 + u * nt + tid < L;
      const bool obj_ok = o[u] >= 0 && o[u] < L;
      ok = ok && (!in || (obj_ok && (v[u] == 0.0f || v[u] == 1.0f) &&
                          r[u] >= -1));
      warp_count(start, in && obj_ok ? o[u] : -1);
    }
  }
  __syncthreads();
  for (int64_t l0 = tid; l0 < L; l0 += stride) {
    int32_t o[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t l = l0 + u * nt;
      o[u] = l < L ? __ldg(eo + l) : -1;
      r[u] = l < L ? __ldg(er + l) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (o[u] >= 0 && o[u] < L) ok = ok && r[u] < start[o[u]];
  }
  for (int64_t t0 = tid; t0 < T; t0 += stride) {
    int32_t e[kUnroll], oob[kUnroll], rk[kUnroll], dl[kUnroll];
    bool va[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = t0 + u * nt;
      const bool in = t < T;
      e[u] = in ? __ldg(oe + t) : 0;
      oob[u] = in ? __ldg(oo + t) : -2;
      rk[u] = in ? __ldg(orr + t) : 0;
      dl[u] = in ? __ldg(od + t) : 0;
      va[u] = in && ov[t];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (va[u]) {
        const bool hit = e[u] >= 0 && e[u] < L;
        ok = ok && hit && oob[u] == __ldg(eo + (hit ? e[u] : 0)) &&
             rk[u] == __ldg(er + (hit ? e[u] : 0));
      } else {
        ok = ok && oob[u] == -2 && dl[u] == 0;
      }
    }
  }
  const bool regroup = __syncthreads_and(ok) != 0;
  if (tid == 0) {
    flags[d] = regroup ? 1 : 0;
    atomicAdd(branch + (regroup ? 0 : 1), 1ULL);
  }
  if (!regroup) {
    scan_doc(c, d, L, T, K, reinterpret_cast<float*>(elem_pos), s_dyn);
    return;
  }

  // -- dense positions: object starts, then each element's and op's --
  tiled_exclusive_scan(start, L, 1, red, s_dyn);
  for (int64_t l0 = tid; l0 < L; l0 += stride) {
    int32_t o[kUnroll], r[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t l = l0 + u * nt;
      o[u] = l < L ? __ldg(eo + l) : 0;
      r[u] = l < L ? __ldg(er + l) : 0;
      v[u] = l < L ? __ldg(vis + l) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t l = l0 + u * nt;
      if (l < L) elem_pos[l] = v[u] != 0.0f ? start[o[u]] + r[u] + 1 : -1;
    }
  }
  for (int64_t t0 = tid; t0 < T; t0 += stride) {
    int32_t oob[kUnroll], rk[kUnroll];
    bool va[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = t0 + u * nt;
      va[u] = t < T && ov[t];
      oob[u] = va[u] ? __ldg(oo + t) : 0;
      rk[u] = va[u] ? __ldg(orr + t) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t t = t0 + u * nt;
      if (t >= T) continue;
      const int32_t lo = va[u] ? start[oob[u]] : 0;
      op_lo[t] = lo;
      op_pos[t] = va[u] ? lo + rk[u] + 1 : -1;
    }
  }
}

// One block per (doc, chunk of kChunk ops): the counts of each position
// at the chunk's start (vis0 plus the deltas of the earlier chunks'
// ops), window by window of g.W positions in shared memory, their
// exclusive prefix, and the chunk's own earlier ops.
__global__ void __launch_bounds__(1024)
query_kernel(Cols c, const int32_t* __restrict__ scratch,
             const int32_t* __restrict__ flags, Layout g) {
  // counts [pad(W)] | chunk op positions [kChunk] | their deltas [kChunk]
  extern __shared__ int32_t sh[];
  __shared__ int32_t red[32];
  const int64_t nC = g.nC, L = g.L, T = g.T, W = g.W;
  const int64_t ck = blockIdx.x % nC;
  const int64_t d = blockIdx.x / nC;
  if (!flags[d]) return;  // the doc took the chunk-scan branch
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int32_t* elem_pos = scratch + d * g.per_doc + L + 1;
  const int32_t* op_pos = elem_pos + L;
  const int32_t* op_lo = op_pos + T;
  const int32_t* od = c.od + d * T;
  int32_t* cnt = sh;
  int32_t* s_pos = sh + pad(W);
  int32_t* s_del = s_pos + kChunk;
  const int64_t c0 = ck * kChunk;
  const int64_t n_before = c0;  // ops of the earlier chunks

  // this chunk's ops: position (-1: invalid), object start, delta
  const int64_t t = c0 + tid;
  const bool mine = tid < kChunk && t < T;
  int32_t p = -1, lo = 0, dl = 0;
  if (mine) {
    p = op_pos[t];
    lo = op_lo[t];
    dl = p >= 0 ? od[t] : 0;
  }
  if (tid < kChunk) {
    s_pos[tid] = p;
    s_del[tid] = dl;
  }
  int32_t at_p = 0, at_lo = 0, carry = 0;
  const int64_t stride = static_cast<int64_t>(nt) * kUnroll;
  for (int64_t w0 = 0; w0 < 2 * L; w0 += W) {
    const int64_t n = 2 * L - w0 < W ? 2 * L - w0 : W;
    for (int64_t x = tid; x < pad(n); x += nt) cnt[x] = 0;
    __syncthreads();
    for (int64_t l0 = tid; l0 < L; l0 += stride) {
      int32_t x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = l0 + u * nt < L ? __ldg(elem_pos + l0 + u * nt) : -1;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (x[u] >= w0 && x[u] < w0 + n) atomicAdd(cnt + pad(x[u] - w0), 1);
    }
    for (int64_t j0 = tid; j0 < n_before; j0 += stride) {
      int32_t x[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = j0 + u * nt < n_before;
        x[u] = in ? __ldg(op_pos + j0 + u * nt) : -1;
        v[u] = in ? __ldg(od + j0 + u * nt) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (v[u] != 0 && x[u] >= w0 && x[u] < w0 + n)
          atomicAdd(cnt + pad(x[u] - w0), v[u]);
    }
    __syncthreads();
    const int32_t total = padded_exclusive_scan(cnt, n, red);
    if (p >= 0) {
      if (p >= w0 && p < w0 + n) at_p = carry + cnt[pad(p - w0)];
      if (lo >= w0 && lo < w0 + n) at_lo = carry + cnt[pad(lo - w0)];
    }
    carry += total;
    __syncthreads();  // reads done before the next window's counts
  }
  if (!mine) return;
  int32_t idx = 0;
  if (p >= 0) {
    idx = at_p - at_lo;
    for (int j = 0; j < tid; ++j) {
      const int32_t q = s_pos[j];
      if (q >= lo && q < p) idx += s_del[j];
    }
  }
  c.index[d * T + t] = idx;
}

// -- short docs -----------------------------------------------------------

__global__ void short_kernel(Cols c, float* __restrict__ scratch,
                             unsigned long long* __restrict__ branch,
                             int64_t D, int64_t L, int64_t T, int K) {
  extern __shared__ int32_t s_scan[];  // 3 * K words (chunk-scan branch)
  __shared__ int s_scan_doc[kWarps];
  __shared__ unsigned s_taken[2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (threadIdx.x < 2) s_taken[threadIdx.x] = 0;
  __syncthreads();
  bool needs_scan = false;
  if (d < D) {
    const bool el = lane < L;
    const bool op = lane < T;
    const int32_t o = el ? c.eo[d * L + lane] : -1;
    const int32_t r = el ? c.er[d * L + lane] : -1;
    const float v = el ? c.vis0[d * L + lane] : 0.0f;
    int32_t cnt = 0;  // elements of my object
    for (int j = 0; j < 32; ++j) {
      const int32_t oj = __shfl_sync(kFull, o, j);
      cnt += (j < L && oj == o) ? 1 : 0;
    }
    bool ok = !el || (o >= 0 && o < L && (v == 0.0f || v == 1.0f) &&
                      r >= -1 && r < cnt);
    const int32_t e = op ? c.oe[d * T + lane] : -1;
    const int32_t oo = op ? c.oo[d * T + lane] : -2;
    const int32_t orr = op ? c.orr[d * T + lane] : -1;
    const int32_t dl = op ? c.od[d * T + lane] : 0;
    const bool ov = op && c.ov[d * T + lane];
    const int src = e >= 0 && e < 32 ? e : 0;
    const int32_t o_at = __shfl_sync(kFull, o, src);
    const int32_t r_at = __shfl_sync(kFull, r, src);
    if (op) {
      if (ov)
        ok = ok && e >= 0 && e < L && oo == o_at && orr == r_at;
      else
        ok = ok && oo == -2 && dl == 0;
    }
    const bool regroup = __all_sync(kFull, ok) != 0;
    if (regroup) {
      const int32_t vi = v != 0.0f ? 1 : 0;
      const int32_t dv = ov ? dl : 0;
      int32_t idx = 0;
      for (int j = 0; j < 32; ++j) {
        const int32_t oj = __shfl_sync(kFull, o, j);
        const int32_t rj = __shfl_sync(kFull, r, j);
        const int32_t vj = __shfl_sync(kFull, vi, j);
        if (j < L && oj == oo && rj < orr) idx += vj;
        const int32_t ooj = __shfl_sync(kFull, oo, j);
        const int32_t orj = __shfl_sync(kFull, orr, j);
        const int32_t dj = __shfl_sync(kFull, dv, j);
        if (j < lane && ooj == oo && orj < orr) idx += dj;
      }
      if (op) c.index[d * T + lane] = ov ? idx : 0;
    }
    needs_scan = !regroup;
    if (lane == 0) atomicAdd(s_taken + (regroup ? 0 : 1), 1u);
  }
  if (lane == 0) s_scan_doc[warp] = needs_scan ? 1 : 0;
  __syncthreads();
  if (threadIdx.x < 2 && s_taken[threadIdx.x])
    atomicAdd(branch + threadIdx.x,
              static_cast<unsigned long long>(s_taken[threadIdx.x]));
  for (int w = 0; w < kWarps; ++w) {
    if (!s_scan_doc[w]) continue;  // uniform across the block
    const int64_t dw = static_cast<int64_t>(blockIdx.x) * kWarps + w;
    scan_doc(c, dw, L, T, K, scratch + dw * L, s_scan);
  }
}

}  // namespace

// int32 words of scratch the route needs at this shape.
extern "C" int64_t amtpu_torch_route_scratch(int64_t D, int64_t L,
                                             int64_t T) {
  if (D <= 0 || T <= 0) return 0;
  if (short_docs(L, T)) return D * (L > 0 ? L : 1);
  return D * layout(L, T).per_doc + D;  // + one flag per doc
}

// elem_obj/elem_rank [D, L] int32; vis0 [D, L] float32; op_elem/op_obj/
// op_rank/op_delta [D, T] int32; op_valid [D, T] bool; writes index
// [D, T] int32.  scratch: amtpu_torch_route_scratch(D, L, T) int32 words;
// branch: two uint64 counters (docs that took the fast branch, docs that
// took the chunk scan), added to.  chunk in [1, 1024] (the scan
// branch's).  Returns a cudaError_t.
extern "C" int amtpu_torch_route(const void* elem_obj, const void* elem_rank,
                                 const void* vis0, const void* op_elem,
                                 const void* op_obj, const void* op_rank,
                                 const void* op_delta, const void* op_valid,
                                 void* index, void* scratch, void* branch,
                                 int64_t D, int64_t L, int64_t T, int chunk,
                                 void* stream) {
  if (D <= 0 || T <= 0) return 0;
  if (chunk < 1 || chunk > 1024 || L < 0 || L >= (1LL << 29) ||
      D > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Cols c{static_cast<const int32_t*>(elem_obj),
         static_cast<const int32_t*>(elem_rank),
         static_cast<const float*>(vis0),
         static_cast<const int32_t*>(op_elem),
         static_cast<const int32_t*>(op_obj),
         static_cast<const int32_t*>(op_rank),
         static_cast<const int32_t*>(op_delta),
         static_cast<const bool*>(op_valid), static_cast<int32_t*>(index)};
  auto* counters = static_cast<unsigned long long*>(branch);
  const size_t scan_smem = 3 * static_cast<size_t>(chunk) * sizeof(int32_t);
  if (short_docs(L, T)) {
    const int64_t blocks = (D + kWarps - 1) / kWarps;
    short_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, scan_smem,
                   s>>>(c, static_cast<float*>(scratch), counters, D, L, T,
                        chunk);
    return static_cast<int>(cudaGetLastError());
  }
  const Layout g = layout(L, T);
  if (D * g.nC > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int32_t* scr = static_cast<int32_t*>(scratch);
  int32_t* flags = scr + D * g.per_doc;
  const int64_t widest = L > T ? L : T;
  int threads = static_cast<int>((widest + 31) / 32 * 32);
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  const int64_t tile = scan_tile_words(threads);
  const int front = static_cast<int>(tile > 3 * chunk ? tile : 3 * chunk);
  // the object starts in shared memory when they fit beside the front
  const bool start_in_smem =
      (front + L + 1) * static_cast<int64_t>(sizeof(int32_t)) <= kSmemMax;
  const size_t prep_smem =
      (front + (start_in_smem ? L + 1 : 0)) * sizeof(int32_t);
  // both kernels' attributes at the ceiling, not this call's sizes: the
  // attribute is the function's, so a call's own size could lower it
  // under another thread's launch
  cudaError_t e = cudaFuncSetAttribute(
      prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemMax));
  if (e != cudaSuccess) return static_cast<int>(e);
  prep_kernel<<<static_cast<unsigned>(D), threads, prep_smem, s>>>(
      c, scr, flags, counters, g, chunk, front, start_in_smem);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t q_smem = (pad(g.W) + 2 * kChunk) * sizeof(int32_t);
  e = cudaFuncSetAttribute(query_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemMax));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int q_threads = 2 * L >= 8192 ? 1024 : kChunk;
  query_kernel<<<static_cast<unsigned>(D * g.nC), q_threads, q_smem, s>>>(
      c, scr, flags, g);
  return static_cast<int>(cudaGetLastError());
}
