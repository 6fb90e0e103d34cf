// Dominance indexes over one sp block of the element arena, on Hopper.
//
// Replaces automerge_tpu/ops/list_rank.py::dominance_indexes in its
// sequence-parallel mode (`axis_name='sp'`, `l_offset`), which the JAX
// package leaves to XLA inside shard_map; same contract as the plain
// version automerge_tpu_torch/ops/list_rank.py::dominance_indexes(...,
// block=True) at `chunk`.  The elements are this block's [D, Ll] columns,
// the first of them at global index l_offset; op_elem holds global
// indexes.  Per op t of chunk c (ops [c*K, c*K + K)):
//   base[t] = sum over block elements l of vis[l] * (obj[l] == o_t) *
//             (rank[l] < r_t)        -- vis at the start of chunk c
//   corr[t] = sum over earlier ops j of the chunk of d[j] * (o[j] == o_t)
//             * (r[j] < r_t)         -- valid or not; only when add_corr
//   index[t] = int(base[t] + corr[t])
// where vis is vis0 plus the deltas of the earlier chunks' valid ops j
// with 0 <= op_elem[j] - l_offset < Ll.  In float32, as the JAX scan:
// every term is an integer and every partial sum stays below 2^24 (the
// wrapper checks the shapes' bound), so the sums are exact in any order,
// and the sum of the blocks' outputs is the scan's psum(base) + corr.
//
// The work items are (doc, chunk, element slice): the block's elements
// split into slices only when there are fewer (doc, chunk) items than
// the card has room for (a keystroke: one doc, one chunk), so that those
// few items still spread over the SMs.  A thread block walks items with
// a grid stride: it rebuilds its slice's visibility at the chunk's start
// in a row of global scratch (vis0, then an atomic add per earlier valid
// op landing in the slice), stages the chunk's ops in shared memory, and
// counts element tiles staged in shared memory, one warp an op at a
// time, each lane a stride of the tile, the warp's sum added to the op's
// accumulator in shared memory.  With one slice the block writes the
// index itself; with several, each slice adds its partial base to a
// float row of scratch and `finish_kernel` adds the within-chunk term
// and writes the index.  The work is Ll x K compares per (doc, chunk)
// plus the replay of the earlier ops: operations, not bytes, bound it.
// The grid is capped so the scratch rows stay within kScratchWords.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
//: elements a block stages in shared memory at once
constexpr int kTile = 2048;
//: scratch rows (one per resident block) are capped at this many words
constexpr int64_t kScratchWords = int64_t(1) << 24;
//: (doc, chunk) items below which the elements split into slices: two
//: thread blocks for each of the card's 132 SMs
constexpr int64_t kFewItems = 264;
//: the smallest element slice
constexpr int64_t kMinSlice = 2048;

__host__ __device__ inline int64_t n_chunks(int64_t T, int K) {
  return (T + K - 1) / K;
}

// The launch's split of the work.
struct Plan {
  int64_t nC, n_slices, slice, items, grid;
};

inline Plan plan_of(int64_t D, int64_t Ll, int64_t T, int K) {
  Plan p;
  p.nC = n_chunks(T, K);
  const int64_t pairs = D * p.nC;
  p.n_slices = 1;
  if (pairs < kFewItems && Ll > kMinSlice) {
    const int64_t by_size = (Ll + kMinSlice - 1) / kMinSlice;
    const int64_t by_room = (kFewItems + pairs - 1) / pairs;
    p.n_slices = by_size < by_room ? by_size : by_room;
  }
  p.slice = (Ll + p.n_slices - 1) / p.n_slices;
  if (p.slice < 1) p.slice = 1;
  p.items = pairs * p.n_slices;
  int64_t g = kScratchWords / p.slice;
  if (g < 1) g = 1;
  if (g > p.items) g = p.items;
  if (g > 2147483647LL) g = 2147483647LL;
  p.grid = g;
  return p;
}

// float words of scratch: a visibility row per thread block, then (with
// several slices) the [D, T] partial-base accumulator.
inline int64_t scratch_words(int64_t D, int64_t T, const Plan& p) {
  return p.grid * p.slice + (p.n_slices > 1 ? D * T : 0);
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

__global__ void __launch_bounds__(kThreads)
block_kernel(Cols c, float* __restrict__ scratch, float* __restrict__ acc,
             int64_t Ll, int64_t T, int K, int64_t l_offset, bool add_corr,
             Plan p) {
  // chunk ops [K] x (obj, rank, delta) | accumulators [K] | element tile
  extern __shared__ int32_t sh[];
  int32_t* s_obj = sh;
  int32_t* s_rank = sh + K;
  int32_t* s_delta = sh + 2 * K;
  float* s_acc = reinterpret_cast<float*>(sh + 3 * K);
  int32_t* t_obj = sh + 4 * K;
  int32_t* t_rank = t_obj + kTile;
  float* t_vis = reinterpret_cast<float*>(t_rank + kTile);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* v = scratch + static_cast<int64_t>(blockIdx.x) * p.slice;

  for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int64_t e0 = item % p.n_slices * p.slice;
    const int64_t d = item / p.n_slices / p.nC;
    const int64_t c0 = item / p.n_slices % p.nC * K;
    const int64_t rest = Ll - e0 > 0 ? Ll - e0 : 0;
    const int64_t n_e = rest < p.slice ? rest : p.slice;
    const int32_t* deo = c.eo + d * Ll + e0;
    const int32_t* der = c.er + d * Ll + e0;
    // -- the slice's visibility at the chunk's start --
    for (int64_t l = tid; l < n_e; l += kThreads)
      v[l] = c.vis0[d * Ll + e0 + l];
    __syncthreads();
    for (int64_t j = tid; j < c0; j += kThreads) {
      if (!c.ov[d * T + j]) continue;
      const int64_t le =
          static_cast<int64_t>(c.oe[d * T + j]) - l_offset - e0;
      if (le >= 0 && le < n_e)
        atomicAdd(v + le, static_cast<float>(c.od[d * T + j]));
    }
    // -- the chunk's ops (padding past T: obj -2, rank -1, delta 0) --
    for (int k = tid; k < K; k += kThreads) {
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
      for (int i = tid; i < n; i += kThreads) {
        t_obj[i] = deo[l0 + i];
        t_rank[i] = der[l0 + i];
        t_vis[i] = v[l0 + i];
      }
      __syncthreads();
      for (int k = warp; k < K; k += kWarps) {
        const int32_t o = s_obj[k];
        const int32_t r = s_rank[k];
        float s = 0.0f;
        for (int i = lane; i < n; i += 32)
          if (t_obj[i] == o && t_rank[i] < r) s += t_vis[i];
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(kFull, s, w);
        if (lane == 0) s_acc[k] += s;
      }
      __syncthreads();  // the tile read before the next one lands
    }
    // -- the partial count, or this slice's share of its base --
    for (int k = tid; k < K; k += kThreads) {
      const int64_t t = c0 + k;
      if (t >= T) continue;
      if (acc != nullptr) {
        if (s_acc[k] != 0.0f) atomicAdd(acc + d * T + t, s_acc[k]);
        continue;
      }
      float idx = s_acc[k];
      if (add_corr) {
        for (int j = 0; j < k; ++j)
          if (s_obj[j] == s_obj[k] && s_rank[j] < s_rank[k])
            idx += static_cast<float>(s_delta[j]);
      }
      c.index[d * T + t] = static_cast<int32_t>(idx);
    }
    __syncthreads();  // shared memory and v free for the next item
  }
}

// The slices' bases summed in `acc`, plus the within-chunk term (the
// earlier ops of the op's chunk, valid or not, of the same object and a
// lower rank): one thread an op.
__global__ void finish_kernel(Cols c, const float* __restrict__ acc,
                              int64_t D, int64_t T, int K, bool add_corr) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= D * T) return;
  float idx = acc[i];
  if (add_corr) {
    const int64_t t = i % T;
    const int32_t o = c.oo[i];
    const int32_t r = c.orr[i];
    for (int64_t j = i - t % K; j < i; ++j)
      if (c.oo[j] == o && c.orr[j] < r) idx += static_cast<float>(c.od[j]);
  }
  c.index[i] = static_cast<int32_t>(idx);
}

}  // namespace

// float words of scratch the block route needs at this shape.
extern "C" int64_t amtpu_torch_route_block_scratch(int64_t D, int64_t Ll,
                                                   int64_t T, int chunk) {
  if (D <= 0 || T <= 0 || chunk < 1) return 0;
  return scratch_words(D, T, plan_of(D, Ll, T, chunk));
}

// elem_obj/elem_rank [D, Ll] int32 and vis0 [D, Ll] float32: this sp
// block's elements, the first at global index l_offset; op_elem (global
// indexes)/op_obj/op_rank/op_delta [D, T] int32; op_valid [D, T] bool;
// writes index [D, T] int32, each op's partial count over the block
// (with the within-chunk term when add_corr).  scratch:
// amtpu_torch_route_block_scratch(D, Ll, T, chunk) float words.  chunk
// in [1, 1024].  Returns a cudaError_t.
extern "C" int amtpu_torch_route_block(
    const void* elem_obj, const void* elem_rank, const void* vis0,
    const void* op_elem, const void* op_obj, const void* op_rank,
    const void* op_delta, const void* op_valid, void* index, void* scratch,
    int64_t D, int64_t Ll, int64_t T, int chunk, int64_t l_offset,
    int add_corr, void* stream) {
  if (D <= 0 || T <= 0) return 0;
  if (chunk < 1 || chunk > 1024 || Ll < 0 || Ll >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(D, Ll, T, chunk);
  Cols c{static_cast<const int32_t*>(elem_obj),
         static_cast<const int32_t*>(elem_rank),
         static_cast<const float*>(vis0),
         static_cast<const int32_t*>(op_elem),
         static_cast<const int32_t*>(op_obj),
         static_cast<const int32_t*>(op_rank),
         static_cast<const int32_t*>(op_delta),
         static_cast<const bool*>(op_valid), static_cast<int32_t*>(index)};
  float* rows = static_cast<float*>(scratch);
  float* acc = p.n_slices > 1 ? rows + p.grid * p.slice : nullptr;
  cudaError_t e;
  if (acc != nullptr) {
    e = cudaMemsetAsync(acc, 0, D * T * sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem =
      (4 * static_cast<size_t>(chunk) + 3 * kTile) * sizeof(int32_t);
  e = cudaFuncSetAttribute(block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  block_kernel<<<static_cast<unsigned>(p.grid), kThreads, smem, s>>>(
      c, rows, acc, Ll, T, chunk, l_offset, add_corr != 0, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || acc == nullptr) return static_cast<int>(e);
  const int64_t n = D * T;
  finish_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      c, acc, D, T, chunk, add_corr != 0);
  return static_cast<int>(cudaGetLastError());
}
