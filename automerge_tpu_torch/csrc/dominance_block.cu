// Dominance indexes over one sp block of the element arena, on Hopper.
//
// Replaces automerge_tpu/ops/list_rank.py::dominance_indexes in its
// sequence-parallel mode (`axis_name='sp'`, `l_offset`), which the JAX
// package leaves to XLA inside shard_map; same contract as the plain
// version automerge_tpu_torch/ops/list_rank.py::dominance_indexes(...,
// block=True) at `chunk`.  The elements are this block's [D, Ll] columns,
// the first of them at global index l_offset; op_elem holds global
// indexes.  Per op t of caller chunk c (ops [c*K, c*K + K)):
//   base[t] = sum over block elements l of vis[l] * (obj[l] == o_t) *
//             (rank[l] < r_t)        -- vis at the start of chunk c
//   corr[t] = sum over earlier ops j of the chunk of d[j] * (o[j] == o_t)
//             * (r[j] < r_t)         -- valid or not; only when add_corr
//   index[t] = int(base[t] + corr[t])
// where vis is vis0 plus the deltas of the earlier chunks' valid ops j
// with 0 <= op_elem[j] - l_offset < Ll.  Every term is an integer and
// every partial sum stays below 2^24 (the wrapper checks the shapes'
// bound), so the sums are exact in any order, and the sum of the blocks'
// outputs is the JAX scan's psum(base) + corr.
//
// Each doc decides on the card which of two branches it takes; nothing
// is read back.  The extra input `starts` holds each doc's object starts
// over the whole doc's L elements ([D, L + 1]: object o spans count(o) +
// 1 dense positions from start(o); the callers make it on the card).  A
// block "regroups" when every element of the block has 0 <= obj < L, vis0
// in {0, 1}, -1 <= rank < count(obj) and its position start(obj) + rank
// + 1 in [0, 2L); every valid op whose element op_elem - l_offset lies in
// the block has that element's object and rank; every invalid op has obj
// -2 and delta 0.  Such a doc takes the fast branch; any other doc walks
// the caller's chunks (the scan branch, PR 13's walk: each (doc, chunk,
// element slice) item rebuilds its slice's visibility and compares every
// op of the chunk with every element of the slice).  Each doc adds one
// to its branch's device counter.
//
// Fast branch, long blocks (Ll > 32 or T > 32), four launches after one
// memset, each spread over many thread blocks even for one doc:
//  - mark_kernel, blocks of (doc, element and op slice): the regroup
//    test, and a bit per element's global position in a bitmap of 2L
//    bits per doc (one atomicOr per distinct word of a warp); with
//    position slices it zeroes the index, which the slices add to.
//  - tile_kernel, a block per (doc, tile of bitmap words): each word's
//    popcount prefix within its tile, and the tile's count.
//  - locate_kernel, blocks of (doc, slice): the prefix of the doc's tile
//    counts in shared memory; then the local position of a global one is
//    the marked positions below it (tile offset + word prefix + masked
//    popcount), in [0, Ll).  It counts the visible elements per local
//    position (cnt0) and gives every op its local query range [lo, p)
//    (object o_t's positions below rank r_t, clamped to its span; empty
//    when o_t is outside [0, L)) and, when the op is valid with its
//    element in the block and a nonzero delta, that element's local
//    position (= p; else -1).
//  - query_kernel, a block per (doc, time chunk, position slice): a time
//    chunk is a multiple of the caller's chunk (up to 1024 ops, about 264
//    items in all); positions split into slices only when the items are
//    few (a keystroke: one doc, one chunk).  The block rebuilds the count
//    of each local position of its slice at its chunk's start (cnt0 plus
//    the deltas of the earlier time chunks' valid in-block ops), window
//    by window of at most kWindow positions in shared memory, scans it
//    (exclusive prefix H) and adds H(p) - H(lo) for each of its ops; the
//    slices share the walk of the earlier ops j of the time chunk: from an
//    earlier caller chunk, d_j when j is valid, in the block and at a
//    position in [lo, p); from the op's own caller chunk, with add_corr,
//    d_j when j has the op's object and a lower rank, valid or not.  So
//    each block's partial equals the plain block mode's, not only the
//    sum.  With several slices, the slices add their counts to the index
//    (which mark_kernel zeroes).
//    The scan branch runs in this launch too: the blocks of a doc that
//    does not regroup walk its (chunk, element slice) items.
// Fast branch, short blocks (Ll <= 32 and T <= 32; the step's many-doc
// batches): one warp per doc, eight docs to a block, everything in
// registers; lane l holds element l and op l and the counts are warp
// shuffles over every pair.  One launch, the scan branch in it.
//
// Bound: bytes on the fast branch (each column read once; the positions
// and earlier ops are re-read from L2 by every time chunk's block, so
// the work is time chunks x (Ll + T/2) plus T x (time chunk) / 2 for the
// walks); the scan branch is operations (Ll x T compares per doc) and is
// off the step's path.  Counts are exact int32 on the fast branch; the
// plain version's float32 sums are exact below 2^24, so the integers
// agree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
//: scan branch: elements a block stages in shared memory at once
constexpr int kTile = 2048;
//: scan branch: its visibility rows are capped at this many words
constexpr int64_t kScratchWords = int64_t(1) << 24;
//: the (doc, chunk) or (doc, time chunk) items to aim for: two thread
//: blocks for each of the card's 132 SMs
constexpr int64_t kFewItems = 264;
//: fast branch: (doc, time chunk) items below which positions split
constexpr int64_t kSliceItems = 132;
//: the smallest element slice (scan branch) or position slice (fast)
constexpr int64_t kMinSlice = 2048;
//: fast branch: ops a query block takes at most (its time chunk)
constexpr int kTimeMax = 1024;
//: positions a query block counts in shared memory at once
constexpr int64_t kWindow = 49152;
//: short blocks (a warp a doc): elements and ops at most; docs a block
constexpr int kShort = 32;
constexpr int kShortWarps = 8;
//: elements and ops a prep block (mark, locate) takes (one a thread);
//: the most prep blocks a launch has before a block takes more
constexpr int64_t kPrepItems = 256;
constexpr int64_t kPrepBlocks = 2048;
//: bitmap words a tile block scans a round; tiles a doc has at most
constexpr int64_t kRoundWords = 4 * kThreads;
constexpr int64_t kMaxTiles = 4096;
//: items a thread loads before it uses any (the loops' loads come from
//: L2, whose latency would otherwise bound each query block)
constexpr int kUnroll = 8;
//: dynamic shared memory a block may ask for (bytes)
constexpr int64_t kSmemMax = 226 * 1024;

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ inline int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__host__ __device__ inline int64_t pad(int64_t i) { return i + (i >> 5); }

// The launch's split of the work and the scratch layout (int32 words).
struct Plan {
  int64_t D, Ll, Lg, T;
  int K;
  int64_t off;
  bool corr, short_docs;
  // scan branch: items (chunk, element slice) per doc, rows per doc
  int64_t nC, n_slices, slice, items, rows;
  // fast branch: time chunk, position slices, window, query blocks a doc
  int64_t tc, nTC, nQS, qsl, W, nQ;
  int qthreads;
  // bitmap words a doc, tile words, tiles a doc; prep blocks a doc
  int64_t BW, TW, nTiles, nM, mes, mos;
  // scratch: [bad | bitmap | cnt0 | acc | done] zeroed, then the rest
  int64_t o_bad, o_bm, o_cnt0, o_acc, o_done, zero_words, o_wpre, o_tsum,
      o_np, o_rng, o_pos, o_rows, words;
};

inline int64_t al4(int64_t n) { return cdiv(n, 4) * 4; }

inline Plan plan_of(int64_t D, int64_t Ll, int64_t Lg, int64_t T, int K) {
  Plan p{};
  p.D = D;
  p.Ll = Ll;
  p.Lg = Lg;
  p.T = T;
  p.K = K;
  p.short_docs = Ll <= kShort && T <= kShort;
  p.nC = cdiv(T, K);
  const int64_t pairs = D * p.nC;
  p.n_slices = 1;
  if (pairs < kFewItems && Ll > kMinSlice)
    p.n_slices = lmin(cdiv(Ll, kMinSlice), cdiv(kFewItems, pairs));
  p.slice = lmax(cdiv(Ll, p.n_slices), 1);
  p.items = p.nC * p.n_slices;
  const int64_t m = lmax(1, lmin(kTimeMax / K, D * T / (kFewItems * K)));
  p.tc = K * m;
  p.nTC = cdiv(T, p.tc);
  const int64_t tpairs = D * p.nTC;
  p.nQS = 1;
  if (tpairs < kSliceItems && Ll > kMinSlice)
    p.nQS = lmin(cdiv(Ll, kMinSlice), cdiv(kFewItems, tpairs));
  p.qsl = lmax(cdiv(Ll, p.nQS), 1);
  p.W = lmin(p.qsl, kWindow);
  p.nQ = p.nTC * p.nQS;
  p.rows = lmin(p.nQ, lmax(kScratchWords / (D * p.slice), 1));
  const int64_t busy = p.W + T / 2 >= 8192 ? 1024 : kThreads;
  p.qthreads = static_cast<int>(lmin(1024, lmax(busy, cdiv(p.tc, 32) * 32)));
  p.BW = lmax(al4(cdiv(2 * Lg, 32)), 4);
  p.TW = lmax(cdiv(cdiv(p.BW, kRoundWords), kMaxTiles), 1) * kRoundWords;
  p.nTiles = cdiv(p.BW, p.TW);
  p.nM = lmin(lmax(cdiv(lmax(Ll, T), kPrepItems), 1),
              lmax(cdiv(kPrepBlocks, D), 1));
  p.mes = cdiv(Ll, p.nM);
  p.mos = cdiv(T, p.nM);
  if (p.short_docs) {
    p.o_rows = 0;
    p.words = D * lmax(Ll, 1);  // a visibility row a doc (scan branch)
    return p;
  }
  int64_t w = 0;
  p.o_bad = w;
  w += al4(D);
  p.o_bm = w;
  w += D * p.BW;
  p.o_cnt0 = w;
  w += al4(D * Ll);
  p.o_acc = w;
  w += al4(D * T);
  p.o_done = w;
  w += al4(D * p.nC);
  p.zero_words = w;
  p.o_wpre = w;
  w += D * p.BW;
  p.o_tsum = w;
  w += al4(D * p.nTiles);
  p.o_np = w;
  w += al4(D);
  p.o_rng = w;
  w += al4(2 * D * T);
  p.o_pos = w;
  w += al4(D * T);
  p.o_rows = w;
  w += D * p.rows * p.slice;
  p.words = w;
  return p;
}

struct Cols {
  const int32_t* eo;
  const int32_t* er;
  const float* vis0;
  const int32_t* starts;
  const int32_t* oe;
  const int32_t* oo;
  const int32_t* orr;
  const int32_t* od;
  const bool* ov;
  int32_t* index;
};

struct Scr {
  int32_t* bad;
  uint32_t* bm;
  int32_t* cnt0;
  float* acc;  // the scan branch's partial bases (several slices)
  int32_t* done;
  int32_t* wpre;
  int32_t* tsum;
  int32_t* np;
  int2* rng;
  int32_t* pos;
  float* rows;
};

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

// In-place exclusive prefix of x[0, n) held padded (x[pad(i)]) in shared
// memory, by the whole block, each thread a contiguous run; returns the
// total.  Ends with a barrier.
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

// -- the scan branch --------------------------------------------------------

// The plain block mode's walk for the items (chunk, element slice) q, q +
// rows, ... of doc d, by the whole block: per item, the slice's
// visibility at the chunk's start in row `v` of global scratch (vis0,
// then an atomic add per earlier valid op landing in the slice), the
// chunk's ops staged in shared memory, element tiles staged in shared
// memory and counted a warp an op at a time.  With one slice the block
// writes the index; with several, each slice adds its partial base to a
// float row and the last slice of the chunk adds the within-chunk term
// and writes the index.  `sh`: 4 * K + 3 * kTile words.
__device__ void scan_items(const Cols& c, const Scr& s, const Plan& p,
                           int64_t d, int64_t q, int32_t* sh,
                           int* s_last) {
  const int K = p.K;
  const int64_t Ll = p.Ll, T = p.T;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int32_t* s_obj = sh;
  int32_t* s_rank = sh + K;
  int32_t* s_delta = sh + 2 * K;
  float* s_acc = reinterpret_cast<float*>(sh + 3 * K);
  int32_t* t_obj = sh + 4 * K;
  int32_t* t_rank = t_obj + kTile;
  float* t_vis = reinterpret_cast<float*>(t_rank + kTile);
  float* v = s.rows + (d * p.rows + q) * p.slice;
  float* acc = s.acc + d * T;

  for (int64_t item = q; item < p.items; item += p.rows) {
    const int64_t e0 = item % p.n_slices * p.slice;
    const int64_t ck = item / p.n_slices;
    const int64_t c0 = ck * K;
    const int64_t rest = Ll - e0 > 0 ? Ll - e0 : 0;
    const int64_t n_e = rest < p.slice ? rest : p.slice;
    const int32_t* deo = c.eo + d * Ll + e0;
    const int32_t* der = c.er + d * Ll + e0;
    // -- the slice's visibility at the chunk's start --
    for (int64_t l = tid; l < n_e; l += nt) v[l] = c.vis0[d * Ll + e0 + l];
    __syncthreads();
    for (int64_t j = tid; j < c0; j += nt) {
      if (!c.ov[d * T + j]) continue;
      const int64_t le = static_cast<int64_t>(c.oe[d * T + j]) - p.off - e0;
      if (le >= 0 && le < n_e)
        atomicAdd(v + le, static_cast<float>(c.od[d * T + j]));
    }
    // -- the chunk's ops (padding past T: obj -2, rank -1, delta 0) --
    for (int k = tid; k < K; k += nt) {
      const int64_t t = c0 + k;
      const bool real = t < T;
      s_obj[k] = real ? c.oo[d * T + t] : -2;
      s_rank[k] = real ? c.orr[d * T + t] : -1;
      s_delta[k] = real ? c.od[d * T + t] : 0;
      s_acc[k] = 0.0f;
    }
    __syncthreads();  // v complete, the chunk staged
    // -- base counts over the slice, tile by tile --
    for (int64_t l0 = 0; l0 < n_e; l0 += kTile) {
      const int n = n_e - l0 < kTile ? static_cast<int>(n_e - l0) : kTile;
      for (int i = tid; i < n; i += nt) {
        t_obj[i] = deo[l0 + i];
        t_rank[i] = der[l0 + i];
        t_vis[i] = v[l0 + i];
      }
      __syncthreads();
      for (int k = warp; k < K; k += nw) {
        const int32_t o = s_obj[k];
        const int32_t r = s_rank[k];
        float sum = 0.0f;
        for (int i = lane; i < n; i += 32)
          if (t_obj[i] == o && t_rank[i] < r) sum += t_vis[i];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          sum += __shfl_xor_sync(kFull, sum, w);
        if (lane == 0) s_acc[k] += sum;
      }
      __syncthreads();  // the tile read before the next one lands
    }
    // -- the partial count, or this slice's share of its base --
    bool finish = true;
    if (p.n_slices > 1) {
      for (int k = tid; k < K; k += nt) {
        if (c0 + k < T && s_acc[k] != 0.0f) {
          atomicAdd(acc + c0 + k, s_acc[k]);
          __threadfence();
        }
      }
      __syncthreads();
      if (tid == 0)
        *s_last = atomicAdd(s.done + d * p.nC + ck, 1) == p.n_slices - 1;
      __syncthreads();
      finish = *s_last != 0;
      if (finish) __threadfence();
    }
    if (finish) {
      for (int k = tid; k < K; k += nt) {
        const int64_t t = c0 + k;
        if (t >= T) continue;
        float idx = p.n_slices > 1 ? __ldcg(acc + t) : s_acc[k];
        if (p.corr) {
          for (int j = 0; j < k; ++j)
            if (s_obj[j] == s_obj[k] && s_rank[j] < s_rank[k])
              idx += static_cast<float>(s_delta[j]);
        }
        c.index[d * T + t] = static_cast<int32_t>(idx);
      }
    }
    __syncthreads();  // shared memory and v free for the next item
  }
}

// The plain block mode's walk for doc d by the whole block, chunk after
// chunk (short docs): `v` is an [Ll] float row of scratch, `sh` 3 * K
// words of shared memory.
__device__ void scan_doc(const Cols& c, const Plan& p, int64_t d, float* v,
                         int32_t* sh) {
  const int K = p.K;
  const int64_t Ll = p.Ll, T = p.T;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int32_t* eo = c.eo + d * Ll;
  const int32_t* er = c.er + d * Ll;
  int32_t* s_obj = sh;
  int32_t* s_rank = sh + K;
  int32_t* s_delta = sh + 2 * K;
  for (int64_t l = tid; l < Ll; l += nt) v[l] = c.vis0[d * Ll + l];
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
      float idx = 0.0f;
      for (int64_t l = 0; l < Ll; ++l)
        if (eo[l] == o && er[l] < r) idx += v[l];
      if (p.corr) {
        for (int j = 0; j < k; ++j)
          if (s_obj[j] == o && s_rank[j] < r)
            idx += static_cast<float>(s_delta[j]);
      }
      c.index[d * T + t] = static_cast<int32_t>(idx);
    }
    __syncthreads();  // every base read before any update
    for (int k = tid; k < K; k += nt) {
      const int64_t t = c0 + k;
      if (t < T && c.ov[d * T + t]) {
        const int64_t le = static_cast<int64_t>(c.oe[d * T + t]) - p.off;
        if (le >= 0 && le < Ll)
          atomicAdd(v + le, static_cast<float>(s_delta[k]));
      }
    }
    __syncthreads();  // updates visible to the next chunk
  }
}

// -- long blocks: the test, the bitmap, the positions, the counts ----------

// A block per (doc, slice of elements and ops): the regroup test, the
// elements' global positions marked in the doc's bitmap, and (with
// position slices) the ops' index zeroed.
__global__ void __launch_bounds__(kThreads)
mark_kernel(Cols c, Scr s, Plan p) {
  const int64_t d = blockIdx.x / p.nM;
  const int64_t m = blockIdx.x % p.nM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t Ll = p.Ll, T = p.T, Lg = p.Lg;
  const int32_t* st = c.starts + d * (Lg + 1);
  uint32_t* bm = s.bm + d * p.BW;
  bool ok = true;
  const int64_t e0 = m * p.mes;
  const int64_t e1 = lmin(Ll, e0 + p.mes);
  // whole warps walk the loop: one atomicOr per distinct word of a warp
  for (int64_t l0 = e0; l0 < e1; l0 += kThreads) {
    const int64_t l = l0 + tid;
    long long word = -1;
    unsigned bit = 0;
    if (l < e1) {
      const int32_t o = c.eo[d * Ll + l];
      const int32_t r = c.er[d * Ll + l];
      const float v = c.vis0[d * Ll + l];
      bool e_ok = o >= 0 && o < Lg && (v == 0.0f || v == 1.0f) && r >= -1;
      if (e_ok) {
        const int64_t s0 = st[o];
        const int64_t g = s0 + r + 1;
        e_ok = r < static_cast<int64_t>(st[o + 1]) - s0 - 1 && g >= 0 &&
               g < 2 * Lg;
        if (e_ok) {
          word = g >> 5;
          bit = 1u << (g & 31);
        }
      }
      ok = ok && e_ok;
    }
    const unsigned grp = __match_any_sync(kFull, word);
    const unsigned bits = __reduce_or_sync(grp, bit);
    if (word >= 0 && lane == __ffs(grp) - 1) atomicOr(bm + word, bits);
  }
  const int64_t t0 = m * p.mos;
  const int64_t t1 = lmin(T, t0 + p.mos);
  for (int64_t t = t0 + tid; t < t1; t += kThreads) {
    const int64_t i = d * T + t;
    const int32_t oo = c.oo[i];
    if (p.nQS > 1) c.index[i] = 0;  // the query's slices add to it
    if (c.ov[i]) {
      const int64_t le = static_cast<int64_t>(c.oe[i]) - p.off;
      if (le >= 0 && le < Ll)
        ok = ok && oo == c.eo[d * Ll + le] && c.orr[i] == c.er[d * Ll + le];
    } else {
      ok = ok && oo == -2 && c.od[i] == 0;
    }
  }
  if (!__syncthreads_and(ok) && tid == 0) s.bad[d] = 1;
}

// A block per (doc, tile of TW bitmap words): each word's popcount prefix
// within the tile, a round of kRoundWords words at a time, and the
// tile's count.
__global__ void __launch_bounds__(kThreads) tile_kernel(Scr s, Plan p) {
  __shared__ int32_t red[32];
  const int64_t d = blockIdx.x / p.nTiles;
  const int64_t tile = blockIdx.x % p.nTiles;
  if (s.bad[d]) return;
  const uint32_t* bm = s.bm + d * p.BW;
  int32_t* wpre = s.wpre + d * p.BW;
  const int64_t w_begin = tile * p.TW;
  const int64_t w_end = lmin(p.BW, w_begin + p.TW);
  int32_t carry = 0;
  for (int64_t base = w_begin; base < w_end; base += kRoundWords) {
    const int64_t w = base + 4 * threadIdx.x;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (w < w_end) x = *reinterpret_cast<const uint4*>(bm + w);
    const int32_t c0 = __popc(x.x), c1 = __popc(x.y), c2 = __popc(x.z);
    int32_t total;
    const int32_t run =
        carry + block_scan(c0 + c1 + c2 + __popc(x.w), red, &total);
    if (w < w_end)
      *reinterpret_cast<int4*>(wpre + w) =
          make_int4(run, run + c0, run + c0 + c1, run + c0 + c1 + c2);
    carry += total;
    __syncthreads();  // `red` read before the next round writes it
  }
  if (threadIdx.x == 0) s.tsum[d * p.nTiles + tile] = carry;
}

// A block per (doc, slice of elements and ops): the doc's branch counted
// (by its first block); for a doc that regroups, the prefix of its tile
// counts in shared memory, the visible elements counted per local
// position, and every op's local query range and in-block position.
__global__ void __launch_bounds__(kThreads)
locate_kernel(Cols c, Scr s, Plan p,
              unsigned long long* __restrict__ branch) {
  extern __shared__ int32_t toff[];  // [nTiles]
  __shared__ int32_t red[32];
  const int64_t d = blockIdx.x / p.nM;
  const int64_t m = blockIdx.x % p.nM;
  const int tid = threadIdx.x;
  const bool bad = s.bad[d] != 0;
  if (m == 0 && tid == 0) atomicAdd(branch + (bad ? 1 : 0), 1ULL);
  if (bad) return;
  int32_t n_pos = 0;
  if (p.nTiles <= 32) {  // one warp scans the tile counts
    if (tid < 32) {
      const int32_t x = tid < p.nTiles ? s.tsum[d * p.nTiles + tid] : 0;
      const int32_t incl = warp_inclusive(x);
      if (tid < p.nTiles) toff[tid] = incl - x;
      if (tid == 31) red[0] = incl;
    }
    __syncthreads();
    n_pos = red[0];
  }
  for (int64_t b = 0; p.nTiles > 32 && b < p.nTiles; b += kThreads) {
    const int64_t i = b + tid;
    const int32_t x = i < p.nTiles ? s.tsum[d * p.nTiles + i] : 0;
    int32_t total;
    const int32_t ex = n_pos + block_scan(x, red, &total);
    if (i < p.nTiles) toff[i] = ex;
    n_pos += total;
    __syncthreads();
  }
  if (m == 0 && tid == 0) s.np[d] = n_pos;
  const int64_t Ll = p.Ll, T = p.T, Lg = p.Lg;
  const uint32_t* bm = s.bm + d * p.BW;
  const int32_t* wpre = s.wpre + d * p.BW;
  const int32_t* st = c.starts + d * (Lg + 1);
  // the marked positions below global position g, g in [0, 2L]
  auto rank_of = [&](int64_t g) -> int32_t {
    const int64_t w = g >> 5;
    if (w >= p.BW) return n_pos;
    return toff[w / p.TW] + wpre[w] +
           __popc(bm[w] & ((1u << (g & 31)) - 1u));
  };
  const int64_t e0 = m * p.mes;
  const int64_t e1 = lmin(Ll, e0 + p.mes);
  for (int64_t l = e0 + tid; l < e1; l += kThreads) {
    const float v = c.vis0[d * Ll + l];
    const int32_t o = c.eo[d * Ll + l];
    const int32_t r = c.er[d * Ll + l];
    if (v == 0.0f) continue;
    const int64_t g = static_cast<int64_t>(st[o]) + r + 1;
    atomicAdd(s.cnt0 + d * Ll + rank_of(g), 1);
  }
  const int64_t t0 = m * p.mos;
  const int64_t t1 = lmin(T, t0 + p.mos);
  for (int64_t t = t0 + tid; t < t1; t += kThreads) {
    const int64_t i = d * T + t;
    const int32_t oo = c.oo[i];
    const int32_t orr = c.orr[i];
    const int64_t le = static_cast<int64_t>(c.oe[i]) - p.off;
    const int32_t dl = c.od[i];
    const bool in_block = c.ov[i] && le >= 0 && le < Ll;
    int32_t lo = 0, hi = 0;
    if (oo >= 0 && oo < Lg) {
      const int64_t s0 = st[oo];
      const int64_t span = static_cast<int64_t>(st[oo + 1]) - s0 - 1;
      const int64_t r = lmax(lmin(orr, span), -1);
      lo = rank_of(lmin(lmax(s0, 0), 2 * Lg));
      hi = rank_of(lmin(lmax(s0 + r + 1, 0), 2 * Lg));
    }
    s.rng[i] = make_int2(lo, hi);
    s.pos[i] = in_block && dl != 0 ? hi : -1;
  }
}

// A block per (doc, time chunk, position slice): for a doc that regroups,
// the counts of the slice's local positions at the time chunk's start,
// window by window, their exclusive prefix, each op's share of its range
// and the slice's share of the walk of the chunk's earlier ops, stored
// (one slice) or added to the index; for any other doc, its scan-branch
// items.
__global__ void __launch_bounds__(1024)
query_kernel(Cols c, Scr s, Plan p) {
  // fast: counts [pad(W)] | lo, hi, pos, delta, obj, rank [tc] each
  // scan: `scan_items`' 4 * K + 3 * kTile words
  extern __shared__ int32_t sh[];
  __shared__ int32_t red[32];
  __shared__ int s_last;  // the scan branch's last slice
  const int64_t d = blockIdx.x / p.nQ;
  const int64_t q = blockIdx.x % p.nQ;
  if (s.bad[d]) {
    if (q < p.rows) scan_items(c, s, p, d, q, sh, &s_last);
    return;
  }
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t T = p.T, Ll = p.Ll, K = p.K;
  const int64_t tc = q / p.nQS;
  const int64_t qs = q % p.nQS;
  const int64_t c0 = tc * p.tc;
  const int64_t nk = lmin(p.tc, T - c0);
  int32_t* cnt = sh;
  int32_t* s_lo = sh + pad(p.W);
  int32_t* s_hi = s_lo + p.tc;
  int32_t* s_pos = s_hi + p.tc;
  int32_t* s_od = s_pos + p.tc;
  int32_t* s_obj = s_od + p.tc;
  int32_t* s_rank = s_obj + p.tc;
  const int64_t t = c0 + tid;
  const bool mine = tid < nk;
  int32_t lo = 0, hi = 0;
  if (mine) {
    const int2 rg = s.rng[d * T + t];
    lo = rg.x;
    hi = rg.y;
    s_lo[tid] = lo;
    s_hi[tid] = hi;
    s_pos[tid] = s.pos[d * T + t];
    s_od[tid] = c.od[d * T + t];
    s_obj[tid] = c.oo[d * T + t];
    s_rank[tid] = c.orr[d * T + t];
  }
  const int64_t n_pos = s.np[d];
  __syncthreads();
  const int64_t s0 = qs * p.qsl;
  const int64_t s1 = lmin(n_pos, s0 + p.qsl);
  const int32_t* pos = s.pos + d * T;
  const int32_t* od = c.od + d * T;
  const int32_t* cnt0 = s.cnt0 + d * Ll;
  int32_t part = 0;
  for (int64_t w0 = s0; w0 < s1; w0 += p.W) {
    const int64_t n = lmin(p.W, s1 - w0);
    for (int64_t x0 = tid; x0 < n; x0 += static_cast<int64_t>(nt) * kUnroll) {
      int32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t x = x0 + static_cast<int64_t>(u) * nt;
        v[u] = x < n ? cnt0[w0 + x] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t x = x0 + static_cast<int64_t>(u) * nt;
        if (x < n) cnt[pad(x)] = v[u];
      }
    }
    __syncthreads();
    for (int64_t j0 = tid; j0 < c0; j0 += static_cast<int64_t>(nt) * kUnroll) {
      int32_t x[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + static_cast<int64_t>(u) * nt;
        x[u] = j < c0 ? pos[j] : -1;
      }
      // the deltas of the ops in the window, all loads in flight at once
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        dv[u] = x[u] >= w0 && x[u] < w0 + n
                    ? od[j0 + static_cast<int64_t>(u) * nt] : 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (dv[u] != 0) atomicAdd(cnt + pad(x[u] - w0), dv[u]);
    }
    __syncthreads();
    const int32_t total = padded_exclusive_scan(cnt, n, red);
    if (mine) {
      const int32_t at_hi =
          hi <= w0 ? 0 : (hi >= w0 + n ? total : cnt[pad(hi - w0)]);
      const int32_t at_lo =
          lo <= w0 ? 0 : (lo >= w0 + n ? total : cnt[pad(lo - w0)]);
      part += at_hi - at_lo;
    }
    __syncthreads();  // reads done before the next window's counts
  }
  if (mine) {
    // the earlier ops j of the time chunk, each slice a share of them:
    // j < js lie in earlier caller chunks
    const int share = static_cast<int>(cdiv(p.tc, p.nQS));
    const int j0 = static_cast<int>(qs) * share;
    const int j1 = j0 + share < tid ? j0 + share : tid;
    const int js = static_cast<int>(t / K * K - c0);
    for (int j = j0; j < (js < j1 ? js : j1); ++j) {
      const int32_t x = s_pos[j];
      if (x >= lo && x < hi) part += s_od[j];
    }
    if (p.corr) {
      const int32_t o = s_obj[tid];
      const int32_t r = s_rank[tid];
      for (int j = js > j0 ? js : j0; j < j1; ++j)
        if (s_obj[j] == o && s_rank[j] < r) part += s_od[j];
    }
  }
  if (mine && p.nQS == 1)
    c.index[d * T + t] = part;
  else if (mine && part != 0)
    atomicAdd(c.index + d * T + t, part);
}

// -- short blocks -----------------------------------------------------------

__global__ void __launch_bounds__(kShortWarps * 32)
short_kernel(Cols c, float* __restrict__ rows,
             unsigned long long* __restrict__ branch, Plan p) {
  extern __shared__ int32_t s_scan[];  // 3 * K words (scan branch)
  __shared__ int s_scan_doc[kShortWarps];
  __shared__ unsigned s_taken[2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kShortWarps + warp;
  const int64_t Ll = p.Ll, T = p.T, Lg = p.Lg;
  if (threadIdx.x < 2) s_taken[threadIdx.x] = 0;
  __syncthreads();
  bool needs_scan = false;
  if (d < p.D) {
    const bool el = lane < Ll;
    const bool op = lane < T;
    const int32_t o = el ? c.eo[d * Ll + lane] : -1;
    const int32_t r = el ? c.er[d * Ll + lane] : -1;
    const float v = el ? c.vis0[d * Ll + lane] : 0.0f;
    const int32_t* st = c.starts + d * (Lg + 1);
    bool ok = true;
    if (el) {
      ok = o >= 0 && o < Lg && (v == 0.0f || v == 1.0f) && r >= -1;
      if (ok) {
        const int64_t s0 = st[o];
        const int64_t g = s0 + r + 1;
        ok = r < static_cast<int64_t>(st[o + 1]) - s0 - 1 && g >= 0 &&
             g < 2 * Lg;
      }
    }
    const int64_t e = op ? c.oe[d * T + lane] : -1;
    const int32_t oo = op ? c.oo[d * T + lane] : -2;
    const int32_t orr = op ? c.orr[d * T + lane] : -1;
    const int32_t dl = op ? c.od[d * T + lane] : 0;
    const bool ov = op && c.ov[d * T + lane];
    const int64_t le = e - p.off;
    const bool in_block = ov && le >= 0 && le < Ll;
    const int src = in_block ? static_cast<int>(le) : 0;
    const int32_t o_at = __shfl_sync(kFull, o, src);
    const int32_t r_at = __shfl_sync(kFull, r, src);
    if (op) {
      if (ov)
        ok = ok && (!in_block || (oo == o_at && orr == r_at));
      else
        ok = ok && oo == -2 && dl == 0;
    }
    const bool regroup = __all_sync(kFull, ok) != 0;
    if (regroup) {
      const int32_t vi = v != 0.0f ? 1 : 0;
      const int32_t d_in = in_block ? dl : 0;
      const int cc = lane / p.K;
      int32_t idx = 0;
      for (int j = 0; j < 32; ++j) {
        const int32_t oj = __shfl_sync(kFull, o, j);
        const int32_t rj = __shfl_sync(kFull, r, j);
        const int32_t vj = __shfl_sync(kFull, vi, j);
        if (j < Ll && oj == oo && rj < orr) idx += vj;
        const int32_t ooj = __shfl_sync(kFull, oo, j);
        const int32_t orj = __shfl_sync(kFull, orr, j);
        const int32_t dj = __shfl_sync(kFull, dl, j);
        const int32_t dinj = __shfl_sync(kFull, d_in, j);
        if (j < lane && ooj == oo && orj < orr)
          idx += j / p.K < cc ? dinj : (p.corr ? dj : 0);
      }
      if (op) c.index[d * T + lane] = idx;
    }
    needs_scan = !regroup;
    if (lane == 0) atomicAdd(s_taken + (regroup ? 0 : 1), 1u);
  }
  if (lane == 0) s_scan_doc[warp] = needs_scan ? 1 : 0;
  __syncthreads();
  if (threadIdx.x < 2 && s_taken[threadIdx.x])
    atomicAdd(branch + threadIdx.x,
              static_cast<unsigned long long>(s_taken[threadIdx.x]));
  for (int w = 0; w < kShortWarps; ++w) {
    if (!s_scan_doc[w]) continue;  // uniform across the block
    const int64_t dw = static_cast<int64_t>(blockIdx.x) * kShortWarps + w;
    scan_doc(c, p, dw, rows + dw * lmax(Ll, 1), s_scan);
  }
}

inline bool grid_ok(int64_t blocks) {
  return blocks >= 1 && blocks <= 2147483647LL;
}

}  // namespace

// int32 words of scratch the block route needs at this shape (Ll the
// block's elements, Lg the doc's).
extern "C" int64_t amtpu_torch_route_block_scratch(int64_t D, int64_t Ll,
                                                   int64_t Lg, int64_t T,
                                                   int chunk) {
  if (D <= 0 || T <= 0 || chunk < 1) return 0;
  return plan_of(D, Ll, Lg, T, chunk).words;
}

// elem_obj/elem_rank [D, Ll] int32 and vis0 [D, Ll] float32: this sp
// block's elements, the first at global index l_offset; starts [D, Lg +
// 1] int32: each doc's object starts over its Lg elements; op_elem
// (global indexes)/op_obj/op_rank/op_delta [D, T] int32; op_valid [D, T]
// bool; writes index [D, T] int32, each op's partial count over the
// block (with the within-chunk term when add_corr).  scratch:
// amtpu_torch_route_block_scratch(D, Ll, Lg, T, chunk) int32 words;
// branch: two uint64 counters (docs that took the fast branch, docs
// that took the scan branch), added to.  chunk in [1, 1024].  Returns a
// cudaError_t.
extern "C" int amtpu_torch_route_block(
    const void* elem_obj, const void* elem_rank, const void* vis0,
    const void* starts, const void* op_elem, const void* op_obj,
    const void* op_rank, const void* op_delta, const void* op_valid,
    void* index, void* scratch, void* branch, int64_t D, int64_t Ll,
    int64_t Lg, int64_t T, int chunk, int64_t l_offset, int add_corr,
    void* stream) {
  if (D <= 0 || T <= 0) return 0;
  if (chunk < 1 || chunk > 1024 || Ll < 0 || Lg < Ll || Lg >= (1LL << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p = plan_of(D, Ll, Lg, T, chunk);
  p.off = l_offset;
  p.corr = add_corr != 0;
  Cols c{static_cast<const int32_t*>(elem_obj),
         static_cast<const int32_t*>(elem_rank),
         static_cast<const float*>(vis0),
         static_cast<const int32_t*>(starts),
         static_cast<const int32_t*>(op_elem),
         static_cast<const int32_t*>(op_obj),
         static_cast<const int32_t*>(op_rank),
         static_cast<const int32_t*>(op_delta),
         static_cast<const bool*>(op_valid), static_cast<int32_t*>(index)};
  auto* counters = static_cast<unsigned long long*>(branch);
  int32_t* w = static_cast<int32_t*>(scratch);
  if (p.short_docs) {
    const int64_t blocks = cdiv(D, kShortWarps);
    if (!grid_ok(blocks)) return static_cast<int>(cudaErrorInvalidValue);
    short_kernel<<<static_cast<unsigned>(blocks), kShortWarps * 32,
                   3 * static_cast<size_t>(chunk) * sizeof(int32_t), st>>>(
        c, reinterpret_cast<float*>(w), counters, p);
    return static_cast<int>(cudaGetLastError());
  }
  if (!grid_ok(D * p.nM) || !grid_ok(D * p.nTiles) || !grid_ok(D * p.nQ))
    return static_cast<int>(cudaErrorInvalidValue);
  Scr s{w + p.o_bad,
        reinterpret_cast<uint32_t*>(w + p.o_bm),
        w + p.o_cnt0,
        reinterpret_cast<float*>(w + p.o_acc),
        w + p.o_done,
        w + p.o_wpre,
        w + p.o_tsum,
        w + p.o_np,
        reinterpret_cast<int2*>(w + p.o_rng),
        w + p.o_pos,
        reinterpret_cast<float*>(w + p.o_rows)};
  cudaError_t e = cudaMemsetAsync(scratch, 0, p.zero_words * sizeof(int32_t),
                                  st);
  if (e != cudaSuccess) return static_cast<int>(e);
  mark_kernel<<<static_cast<unsigned>(D * p.nM), kThreads, 0, st>>>(c, s, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_kernel<<<static_cast<unsigned>(D * p.nTiles), kThreads, 0, st>>>(s,
                                                                         p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  locate_kernel<<<static_cast<unsigned>(D * p.nM), kThreads,
                  p.nTiles * sizeof(int32_t), st>>>(c, s, p, counters);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t fast_words = pad(p.W) + 6 * p.tc;
  const int64_t scan_words = 4 * static_cast<int64_t>(chunk) + 3 * kTile;
  const int64_t smem =
      (fast_words > scan_words ? fast_words : scan_words) * sizeof(int32_t);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // the ceiling, not this call's size: the attribute is the function's,
  // so a call's own size could lower it under another thread's launch
  e = cudaFuncSetAttribute(query_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemMax));
  if (e != cudaSuccess) return static_cast<int>(e);
  query_kernel<<<static_cast<unsigned>(D * p.nQ), p.qthreads,
                 static_cast<size_t>(smem), st>>>(c, s, p);
  return static_cast<int>(cudaGetLastError());
}
