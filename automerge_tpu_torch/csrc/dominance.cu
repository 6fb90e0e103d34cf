// Per-list-object dominance indexes on Hopper.
//
// Replaces the TPU kernel automerge_tpu/ops/pallas_dominance.py::_kernel
// (launched by dominance_grouped_pallas); same contract as the plain
// version automerge_tpu_torch/ops/list_rank.py::dominance_grouped:
//
//   index[o, t] = #{visible elements of object o ranked below op t's
//                   element, just before op t}
//
// One thread block walks one object's op timeline.  The visibility
// vector stays resident for the whole walk: in shared memory (as int32,
// with the element ranks beside it) when 8 * L bytes fit the budget,
// else in a global scratch row owned by the block.  The chunk structure
// of the reference is reproduced exactly, because its result depends on
// it: per chunk of K ops,
//   base[k] = sum_l vis[l] * (rank[l] < r[k])      at chunk start,
//             one warp per op, lanes strided over l, warp-shuffle sum;
//   corr[k] = sum_{j<k in chunk, op_valid[j]} delta[j] * (r[j] < r[k]);
//   index   = base + corr;
//   vis[e]  += delta for ops with op_valid and 0 <= e < L (atomic adds,
//              exact in int32).
// A valid op with e == -1 and a nonzero delta thus counts inside its
// chunk and never after, as in the reference.  Counting is int32 and
// exact at any size (the reference counts in float32, exact below 2^24).
//
// Bound: operations.  The walk does L compare-adds per op (O * T * L in
// all) against O * (2L + 5T) words of input and output; the design keeps
// vis and rank on-chip so the repeated reads hit shared memory, not
// device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;

__global__ void dominance_kernel(
    const float* __restrict__ vis0, const int32_t* __restrict__ elem_rank,
    const int32_t* __restrict__ op_elem, const int32_t* __restrict__ op_rank,
    const int32_t* __restrict__ op_delta,
    const uint8_t* __restrict__ op_valid, int32_t* __restrict__ index,
    int32_t* __restrict__ scratch, int64_t L, int64_t T, int K,
    int use_smem) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t r_s[kMaxChunk], d_s[kMaxChunk], e_s[kMaxChunk],
      base_s[kMaxChunk];
  const int64_t o = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  int32_t* vis;
  const int32_t* rank;
  if (use_smem) {
    vis = smem;
    int32_t* rank_s = smem + L;
    for (int64_t l = tid; l < L; l += blockDim.x) {
      vis[l] = static_cast<int32_t>(vis0[o * L + l]);
      rank_s[l] = elem_rank[o * L + l];
    }
    rank = rank_s;
  } else {
    vis = scratch + o * L;
    for (int64_t l = tid; l < L; l += blockDim.x)
      vis[l] = static_cast<int32_t>(vis0[o * L + l]);
    rank = elem_rank + o * L;
  }
  __syncthreads();

  for (int64_t c0 = 0; c0 < T; c0 += K) {
    if (tid < K) {
      const int64_t j = o * T + c0 + tid;
      const bool v = op_valid[j] != 0;
      const int32_t e = op_elem[j];
      r_s[tid] = op_rank[j];
      d_s[tid] = v ? op_delta[j] : 0;
      e_s[tid] = (v && e >= 0 && e < L) ? e : -1;
    }
    __syncthreads();

    for (int k = warp; k < K; k += n_warps) {
      const int32_t rk = r_s[k];
      int32_t acc = 0;
      for (int64_t l = lane; l < L; l += 32)
        if (rank[l] < rk) acc += vis[l];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) base_s[k] = acc;
    }
    __syncthreads();

    if (tid < K) {
      const int32_t rk = r_s[tid];
      int32_t corr = 0;
      for (int j = 0; j < tid; ++j)
        if (r_s[j] < rk) corr += d_s[j];
      index[o * T + c0 + tid] = base_s[tid] + corr;
      if (e_s[tid] >= 0 && d_s[tid] != 0) atomicAdd(&vis[e_s[tid]], d_s[tid]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int amtpu_torch_dominance(
    const void* vis0, const void* elem_rank, const void* op_elem,
    const void* op_rank, const void* op_delta, const void* op_valid,
    void* index, void* scratch, int64_t O, int64_t L, int64_t T, int K,
    int use_smem, void* stream) {
  if (O <= 0 || T <= 0) return 0;
  if (K <= 0 || K > kMaxChunk || T % K != 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!use_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = use_smem ? static_cast<size_t>(L) * 8 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dominance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dominance_kernel<<<static_cast<unsigned>(O), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vis0), static_cast<const int32_t*>(elem_rank),
      static_cast<const int32_t*>(op_elem),
      static_cast<const int32_t*>(op_rank),
      static_cast<const int32_t*>(op_delta),
      static_cast<const uint8_t*>(op_valid), static_cast<int32_t*>(index),
      static_cast<int32_t*>(scratch), L, T, K, use_smem);
  return static_cast<int>(cudaGetLastError());
}
