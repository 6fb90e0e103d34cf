// Whole-doc dominance indexes, chunk by chunk, on Hopper: the route for
// inputs that do not regroup by object.
//
// Replaces automerge_tpu/ops/list_rank.py::dominance_indexes (single-
// device form, vmapped over docs), which the JAX package leaves to XLA;
// same contract as the plain version automerge_tpu_torch/ops/
// list_rank.py::dominance_indexes.  The card's usual route regroups the
// docs by object and launches the dominance kernel (csrc/dominance.cu);
// that is exact only when every valid op touches an element of its own
// object and rank and every invalid op is inert
// (ops/dominance_kernel.py::regroupable).  Otherwise an op's count
// depends on the chunking (an op without an element, or an invalid op
// with a delta, shifts only the later ops of its own chunk), and this
// kernel walks the chunks exactly as the JAX scan does:
//   base[k] = sum over elements l of vis[l] * (obj[l] == o[k]) *
//             (rank[l] < r[k])            -- at the chunk's start
//   corr[k] = sum over earlier ops j of the chunk of d[j] * (o[j] == o[k])
//             * (r[j] < r[k])             -- valid or not
//   index[k] = int(base[k] + corr[k]); then vis[e[j]] += d[j] for the
//   chunk's valid ops j with 0 <= e[j] < L.
// The ops past T (up to a whole chunk) are the scan's padding: object
// -2, rank -1, delta 0, invalid.
//
// Design: one block per doc, one thread per op of the chunk (chunk <=
// 1024); the doc's visibility lives in a float scratch row in device
// memory (the wrapper copies vis0 there), read by every thread for the
// base sum and updated with atomic adds, with barriers between the
// phases.  Sums are float32, as the scan's: exact for integer-valued
// visibility below 2^24, in any order.
//
// Bound: operations.  Each chunk compares every element against every
// op of the chunk (L x chunk per chunk, L x T per doc) -- the mask
// product the JAX scan does on the matrix unit.  No effort is made to
// be fast: the step's own inputs always take the regrouped route.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scan_kernel(const int32_t* __restrict__ elem_obj,
                            const int32_t* __restrict__ elem_rank,
                            float* __restrict__ vis,
                            const int32_t* __restrict__ op_elem,
                            const int32_t* __restrict__ op_obj,
                            const int32_t* __restrict__ op_rank,
                            const int32_t* __restrict__ op_delta,
                            const bool* __restrict__ op_valid,
                            int32_t* __restrict__ index, int64_t L,
                            int64_t T, int K) {
  extern __shared__ int32_t sh[];
  int32_t* s_obj = sh;
  int32_t* s_rank = sh + K;
  int32_t* s_delta = sh + 2 * K;
  const int64_t d = blockIdx.x;
  const int k = threadIdx.x;
  const int32_t* eo = elem_obj + d * L;
  const int32_t* er = elem_rank + d * L;
  float* v = vis + d * L;
  for (int64_t c0 = 0; c0 < T; c0 += K) {
    const int64_t t = c0 + k;
    const bool real = t < T;
    const int32_t o = real ? op_obj[d * T + t] : -2;
    const int32_t r = real ? op_rank[d * T + t] : -1;
    const int32_t dl = real ? op_delta[d * T + t] : 0;
    s_obj[k] = o;
    s_rank[k] = r;
    s_delta[k] = dl;
    __syncthreads();
    float base = 0.0f;
    for (int64_t l = 0; l < L; ++l)
      if (eo[l] == o && er[l] < r) base += v[l];
    float corr = 0.0f;
    for (int j = 0; j < k; ++j)
      if (s_obj[j] == o && s_rank[j] < r) corr += static_cast<float>(s_delta[j]);
    if (real) index[d * T + t] = static_cast<int32_t>(base + corr);
    __syncthreads();  // every base read before any update
    if (real && op_valid[d * T + t]) {
      const int32_t e = op_elem[d * T + t];
      if (e >= 0 && e < L) atomicAdd(v + e, static_cast<float>(dl));
    }
    __syncthreads();  // updates visible to the next chunk
  }
}

}  // namespace

// elem_obj/elem_rank [D, L] int32; vis [D, L] float32 scratch holding
// vis0 (updated in place); op_elem/op_obj/op_rank/op_delta [D, T] int32;
// op_valid [D, T] bool; writes index [D, T] int32.  chunk in [1, 1024].
// Returns a cudaError_t.
extern "C" int amtpu_torch_dominance_scan(
    const void* elem_obj, const void* elem_rank, void* vis,
    const void* op_elem, const void* op_obj, const void* op_rank,
    const void* op_delta, const void* op_valid, void* index, int64_t D,
    int64_t L, int64_t T, int chunk, void* stream) {
  if (D <= 0 || T <= 0) return 0;
  if (chunk < 1 || chunk > 1024 || D > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(chunk) * sizeof(int32_t);
  scan_kernel<<<static_cast<unsigned>(D), chunk, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(elem_obj),
      static_cast<const int32_t*>(elem_rank), static_cast<float*>(vis),
      static_cast<const int32_t*>(op_elem),
      static_cast<const int32_t*>(op_obj),
      static_cast<const int32_t*>(op_rank),
      static_cast<const int32_t*>(op_delta),
      static_cast<const bool*>(op_valid), static_cast<int32_t*>(index), L,
      T, chunk);
  return static_cast<int>(cudaGetLastError());
}
