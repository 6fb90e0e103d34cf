// Per-list-object dominance indexes on Hopper.
//
// Replaces the TPU kernel automerge_tpu/ops/pallas_dominance.py::_kernel
// (launched by dominance_grouped_pallas); same contract as the plain
// version automerge_tpu_torch/ops/list_rank.py::dominance_grouped:
//
//   index[o, t] = #{visible elements of object o ranked below op t's
//                   element, just before op t}
//
// counted the way the reference's chunk walk counts it (chunk width K):
// each chunk sees the visibility at its start plus a correction from the
// earlier ops of its own chunk.  The walk is sequential only in form;
// for op t in chunk c(t), with d_s = op_delta[s] if op_valid[s] else 0,
//
//   index[t] = #{l : vis0[l] = 1, rank[l] < r_t}                   (start)
//            + sum_{s : c(s) < c(t), 0 <= e_s < L} d_s [rank[e_s] < r_t]
//            + sum_{s < t : c(s) = c(t)}            d_s [r_s < r_t]
//
// where r = op_rank and e = op_elem.  Every op is independent of every
// other.  The chunk quirk follows from the second and third terms: a
// valid op with e_s == -1 and a nonzero delta counts inside its chunk
// (third term, keyed on r_s) and never after (the second term needs an
// element).  Counting is int32 and exact at any size (the references
// count in f32, exact below 2^24).
//
// Ranks come from `linearize` (rank = object size - 1 - hops to the end,
// list_rank.py) and an object's size is at most its padded length L
// (native/core.cpp sizes the row as a bucket of the arena's element
// count), so element ranks lie in [-1, L).  A rank r becomes bucket r + 1
// of an L + 2 bucket histogram; an inclusive prefix I over the buckets
// gives #{rank < q} = I[min(q, L + 1)] (0 for q < 0).
//
// Two shapes, chosen from (L, T, K) alone (amtpu_torch_dominance_scratch):
//
//  * Short objects (the pool's many small Text docs): one warp per
//    object, two objects per 64-thread block, no block barrier.  The
//    warp builds n_c = T / K histogram rows in shared memory: row 0 the
//    start state, row c >= 1 the deltas of chunk c - 1 keyed on
//    rank[e_s].  One pass makes them cumulative over rows and inclusive
//    over buckets, so row c answers the first two terms for every op of
//    chunk c with one lookup.  Ops walk chunk by chunk in steps of 32
//    (no division by K).  The third term is a broadcast loop over the
//    chunk's ops before the step, then a loop over the step's own ops
//    through a window padded with 32 sentinels, so no lane tests s < t;
//    both are skipped for steps without a valid op (an invalid op's
//    index is unspecified, as in the references).  Work per object:
//    n_c (L + 2) cells plus about T K / 2 compare-adds.
//  * Long objects (the histogram does not fit a warp's share of shared
//    memory): the start histogram lives in a global scratch row that the
//    wrapper allocates, and three launches spread one object over many
//    blocks (the object in blockIdx.y, launched in slices of 65,535
//    objects): a scatter over element slices (atomic adds on the
//    histogram, never on a visibility vector), an in-place scan per
//    4096-bucket tile, and an op kernel that reads the start term as tile
//    prefix + in-tile prefix and counts the other two terms directly
//    against ops staged through shared memory (about T^2 / 2
//    compare-adds per object, O(L + T^2) in all instead of O(L T)).
//
// Bound: the least time is the byte bound (vis0 and elem_rank once, 8 L
// bytes per object, the four op columns once, the index written once).
// At the pool's config-3 shape the short path takes about 3x that: the
// in-chunk compare-adds are issue-bound on one warp per object, and each
// warp's loads, histogram and scan form a dependent chain (PERF.md).
// Launch latency sets the floor at small sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kObjsPerBlock = 2;                // short path: warps/block
constexpr int64_t kShortMaxBytes = 32 * 1024;   // short path: smem/object
constexpr int kTile = 4096;                     // long path: scan tile
constexpr int kScanThreads = kTile / 4;
constexpr int kOpThreads = 256;
constexpr int kStage = 1024;                    // long path: ops staged
constexpr int kHistThreads = 256;
constexpr int kHistPerThread = 8;
//: long path: objects a launch takes (blockIdx.y); more go in slices
constexpr int64_t kMaxObjsPerLaunch = 65535;
//: long path: the op kernel's dynamic shared memory at most (the card's
//: 227 KB a block less its static staging arrays)
constexpr int64_t kLongOpsSmemMax = 227 * 1024 - 3 * kStage * 4;

__device__ __forceinline__ int bucket(int32_t rank, int L) {
  return min(max(rank + 1, 0), L + 1);
}

__host__ __device__ inline int64_t even(int64_t n) {
  return (n + 1) & ~int64_t{1};
}

__host__ __device__ inline int64_t short_words(int64_t L, int64_t T,
                                               int64_t K) {
  // histogram rows, int2 ops, a window of 32 sentinels + 32 ops, one
  // valid-op bit mask per 32-op step of each chunk; each part an even
  // number of words, so every warp's int2 arrays are 8-byte aligned
  return even((T / K) * (L + 2)) + 2 * T + 2 * 64 +
         even((T / K) * ((K + 31) / 32));
}

__global__ void dominance_short(
    const float* __restrict__ vis0, const int32_t* __restrict__ elem_rank,
    const int32_t* __restrict__ op_elem, const int32_t* __restrict__ op_rank,
    const int32_t* __restrict__ op_delta,
    const uint8_t* __restrict__ op_valid, int32_t* __restrict__ index,
    int64_t O, int L, int T, int K, int words) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kObjsPerBlock + warp;
  if (o >= O) return;   // whole warps leave; no block barrier below
  const int nb = L + 2;
  const int n_c = T / K;
  int32_t* H = smem + static_cast<int64_t>(warp) * words;
  int2* ops = reinterpret_cast<int2*>(H + even(n_c * nb));
  int2* win = ops + T;              // [32 sentinels | the warp's 32 ops]
  unsigned* valid_s = reinterpret_cast<unsigned*>(win + 64);
  const float* v_o = vis0 + o * L;
  const int32_t* rank_o = elem_rank + o * L;

  for (int i = lane; i < n_c * nb; i += 32) H[i] = 0;
  win[lane] = make_int2(INT_MAX, 0);   // ranks below no op
  __syncwarp();
  for (int l = lane; l < L; l += 32) {
    const int32_t v = static_cast<int32_t>(v_o[l]);
    if (v != 0) atomicAdd(&H[bucket(rank_o[l], L)], v);
  }
  // ops walk chunk by chunk, 32 per step, so every step lies in one
  // chunk (a step is partial when 32 does not divide K)
  const int steps = (K + 31) / 32;
  for (int c = 0; c < n_c; ++c) {
    for (int w = 0; w < steps; ++w) {
      const int k = w * 32 + lane;
      const int t = c * K + k;
      const int64_t j = o * T + t;
      const bool live = k < K;
      const bool valid = live && op_valid[j];
      const unsigned vm = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) valid_s[c * steps + w] = vm;
      if (!live) continue;
      const int32_t e = op_elem[j];
      const int32_t d = valid ? op_delta[j] : 0;
      ops[t] = make_int2(op_rank[j], d);
      if (d != 0 && e >= 0 && e < L && c + 1 < n_c)
        atomicAdd(&H[(c + 1) * nb + bucket(rank_o[e], L)], d);
    }
  }
  __syncwarp();

  // rows cumulative over chunks, inclusive over buckets.  Each lane owns
  // one contiguous run of `per` buckets in every row: it sums its run,
  // one warp scan turns the sums into run offsets, and a second pass
  // writes the prefix.  Row c - 1 is read back by the lane that wrote it.
  const int per = (nb + 31) / 32;
  const int b_lo = min(lane * per, nb);
  const int b_hi = min(b_lo + per, nb);
  for (int c = 0; c < n_c; ++c) {
    int32_t* row = H + c * nb;
    int32_t sum = 0;
    for (int b = b_lo; b < b_hi; ++b) sum += row[b];
    int32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    int32_t run = incl - sum;
    for (int b = b_lo; b < b_hi; ++b) {
      run += row[b];
      row[b] = run + (c > 0 ? row[b - nb] : 0);
    }
  }
  __syncwarp();

  for (int c = 0; c < n_c; ++c) {
    for (int w = 0; w < steps; ++w) {
      const int k = w * 32 + lane;
      const int t = c * K + k;
      const bool live = k < K;
      const int2 me = live ? ops[t] : make_int2(0, 0);
      const int q = min(me.x, L + 1);
      int32_t acc = live && q >= 0 ? H[c * nb + q] : 0;
      // the index of an invalid op is unspecified (as in the references):
      // steps without a valid op skip the in-chunk term, and the loop
      // over the step's own ops stops at its last valid one
      const unsigned vm = valid_s[c * steps + w];
      const int top = 31 - __clz(vm);     // last valid lane, -1 if none
      if (vm != 0) {
        // the chunk's ops before this step precede every lane
        const int c0 = c * K;
#pragma unroll 8
        for (int s = c0; s < c0 + w * 32; ++s) {
          const int2 src = ops[s];
          if (src.x < me.x) acc += src.y;
        }
        // lane l reads the step's op l - j, or a sentinel once j > l: no
        // per-lane test of s < t
        win[32 + lane] = me;
        __syncwarp();
#pragma unroll 8
        for (int j = 1; j <= top; ++j) {
          const int2 src = win[32 + lane - j];
          if (src.x < me.x) acc += src.y;
        }
        __syncwarp();
      }
      if (live) index[o * T + t] = acc;
    }
  }
}

__global__ void dominance_long_hist(
    const float* __restrict__ vis0, const int32_t* __restrict__ elem_rank,
    int32_t* __restrict__ hist, int64_t L, int64_t nbp) {
  const int64_t o = blockIdx.y;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kHistThreads * kHistPerThread;
#pragma unroll
  for (int k = 0; k < kHistPerThread; ++k) {
    const int64_t l = base + k * kHistThreads + threadIdx.x;
    if (l < L) {
      const int32_t v = static_cast<int32_t>(vis0[o * L + l]);
      if (v != 0)
        atomicAdd(&hist[o * nbp + bucket(elem_rank[o * L + l],
                                         static_cast<int>(L))], v);
    }
  }
}

// in-place inclusive scan of one 4096-bucket tile; its total to tilesum
__global__ void dominance_long_scan(int32_t* __restrict__ hist,
                                    int32_t* __restrict__ tilesum,
                                    int64_t nbp, int64_t n_tiles) {
  __shared__ int32_t warp_tot[kScanThreads / 32];
  const int64_t o = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int4* row = reinterpret_cast<int4*>(hist + o * nbp +
                                      static_cast<int64_t>(blockIdx.x) * kTile);
  int4 v = row[threadIdx.x];
  v.y += v.x;
  v.z += v.y;
  v.w += v.z;
  int32_t incl = v.w;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_tot[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t n = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += n;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const int32_t before = incl - v.w + (warp > 0 ? warp_tot[warp - 1] : 0);
  row[threadIdx.x] = make_int4(v.x + before, v.y + before, v.z + before,
                               v.w + before);
  if (threadIdx.x == kScanThreads - 1)
    tilesum[o * n_tiles + blockIdx.x] = v.w + before;
}

__global__ void dominance_long_ops(
    const int32_t* __restrict__ elem_rank,
    const int32_t* __restrict__ op_elem, const int32_t* __restrict__ op_rank,
    const int32_t* __restrict__ op_delta,
    const uint8_t* __restrict__ op_valid,
    const int32_t* __restrict__ hist, const int32_t* __restrict__ tilesum,
    int32_t* __restrict__ index, int64_t L, int64_t T, int K, int64_t nbp,
    int64_t n_tiles) {
  extern __shared__ int32_t tile_pre[];            // [n_tiles] exclusive
  __shared__ int32_t rk_s[kStage], r_s[kStage], d_s[kStage];
  const int64_t o = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < 32) {
    int32_t carry = 0;
    for (int64_t k0 = 0; k0 < n_tiles; k0 += 32) {
      const int64_t k = k0 + lane;
      const int32_t x = k < n_tiles ? tilesum[o * n_tiles + k] : 0;
      int32_t v = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      if (k < n_tiles) tile_pre[k] = carry + v - x;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }

  const int64_t t = static_cast<int64_t>(blockIdx.x) * kOpThreads + tid;
  const bool live = t < T;
  const int64_t c0 = live ? (t / K) * K : T;
  const int32_t r = live ? op_rank[o * T + t] : 0;
  const int64_t t_end = min(static_cast<int64_t>(blockIdx.x + 1) * kOpThreads,
                            T);
  const int32_t* rank_o = elem_rank + o * L;
  __syncthreads();
  int32_t acc = 0;
  const int64_t q = min(static_cast<int64_t>(r), L + 1);
  if (live && q >= 0) acc = tile_pre[q / kTile] + hist[o * nbp + q];

  for (int64_t s0 = 0; s0 < t_end; s0 += kStage) {
    const int n = static_cast<int>(min(static_cast<int64_t>(kStage),
                                       t_end - s0));
    __syncthreads();
    for (int k = tid; k < n; k += kOpThreads) {
      const int64_t j = o * T + s0 + k;
      const bool v = op_valid[j] != 0;
      const int32_t e = op_elem[j];
      r_s[k] = op_rank[j];
      d_s[k] = v ? op_delta[j] : 0;
      rk_s[k] = (v && e >= 0 && e < L) ? rank_o[e] : INT_MAX;
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const int64_t s = s0 + k;
      const int32_t key = s < c0 ? rk_s[k] : r_s[k];
      if (s < t && key < r) acc += d_s[k];
    }
  }
  if (live) index[o * T + t] = acc;
}

struct LongShape {
  int64_t nbp, n_tiles;
};

LongShape long_shape(int64_t L) {
  const int64_t n_tiles = (L + 2 + kTile - 1) / kTile;
  return {n_tiles * kTile, n_tiles};
}

bool is_short(int64_t L, int64_t T, int K) {
  return short_words(L, T, K) * 4 <= kShortMaxBytes;
}

}  // namespace

// Bytes of int32 global scratch the call needs: 0 when each object's
// histogram fits shared memory, else one [O, L + 2 (tile-padded)]
// histogram row and one tile-sum row per object.
extern "C" int64_t amtpu_torch_dominance_scratch(int64_t O, int64_t L,
                                                 int64_t T, int K) {
  if (O <= 0 || T <= 0 || L <= 0 || K <= 0 || is_short(L, T, K)) return 0;
  const LongShape s = long_shape(L);
  return O * (s.nbp + s.n_tiles) * 4;
}

extern "C" int amtpu_torch_dominance(
    const void* vis0, const void* elem_rank, const void* op_elem,
    const void* op_rank, const void* op_delta, const void* op_valid,
    void* index, void* scratch, int64_t O, int64_t L, int64_t T, int K,
    void* stream) {
  if (O <= 0 || T <= 0) return 0;
  if (K <= 0 || T % K != 0 || L <= 0 || L >= INT_MAX - 2 || T >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v0 = static_cast<const float*>(vis0);
  const int32_t* er = static_cast<const int32_t*>(elem_rank);
  const int32_t* oe = static_cast<const int32_t*>(op_elem);
  const int32_t* orank = static_cast<const int32_t*>(op_rank);
  const int32_t* od = static_cast<const int32_t*>(op_delta);
  const uint8_t* ov = static_cast<const uint8_t*>(op_valid);
  int32_t* idx = static_cast<int32_t*>(index);

  if (is_short(L, T, K)) {
    const int words = static_cast<int>(short_words(L, T, K));
    const size_t smem = static_cast<size_t>(words) * 4 * kObjsPerBlock;
    if (smem > 48 * 1024) {
      // the ceiling, not this call's size: the attribute is the
      // function's, so a call's own size could lower it under another
      // thread's launch
      cudaError_t err = cudaFuncSetAttribute(
          dominance_short, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kShortMaxBytes * kObjsPerBlock));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t blocks = (O + kObjsPerBlock - 1) / kObjsPerBlock;
    dominance_short<<<static_cast<unsigned>(blocks), 32 * kObjsPerBlock,
                      smem, st>>>(v0, er, oe, orank, od, ov, idx, O,
                                  static_cast<int>(L), static_cast<int>(T),
                                  K, words);
    return static_cast<int>(cudaGetLastError());
  }

  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const LongShape s = long_shape(L);
  int32_t* hist = static_cast<int32_t*>(scratch);
  int32_t* tilesum = hist + O * s.nbp;
  const size_t pre_bytes = static_cast<size_t>(s.n_tiles) * 4;
  if (pre_bytes > static_cast<size_t>(kLongOpsSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pre_bytes > 48 * 1024) {
    // the ceiling, as on the short route
    cudaError_t err = cudaFuncSetAttribute(
        dominance_long_ops, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kLongOpsSmemMax));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaMemsetAsync(hist, 0, O * s.nbp * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_block = int64_t{kHistThreads} * kHistPerThread;
  // the objects in slices of at most kMaxObjsPerLaunch, each slice's
  // pointers offset to its first object: the kernels index by blockIdx.y
  for (int64_t o0 = 0; o0 < O; o0 += kMaxObjsPerLaunch) {
    const unsigned n = static_cast<unsigned>(
        O - o0 < kMaxObjsPerLaunch ? O - o0 : kMaxObjsPerLaunch);
    const int64_t eo = o0 * L, to = o0 * T;
    int32_t* h = hist + o0 * s.nbp;
    int32_t* ts = tilesum + o0 * s.n_tiles;
    dominance_long_hist<<<dim3(static_cast<unsigned>((L + per_block - 1) /
                                                     per_block),
                               n),
                          kHistThreads, 0, st>>>(v0 + eo, er + eo, h, L,
                                                 s.nbp);
    dominance_long_scan<<<dim3(static_cast<unsigned>(s.n_tiles), n),
                          kScanThreads, 0, st>>>(h, ts, s.nbp, s.n_tiles);
    dominance_long_ops<<<dim3(static_cast<unsigned>((T + kOpThreads - 1) /
                                                    kOpThreads),
                              n),
                         kOpThreads, pre_bytes, st>>>(
        er + eo, oe + to, orank + to, od + to, ov + to, h, ts, idx + to, L,
        T, K, s.nbp, s.n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
