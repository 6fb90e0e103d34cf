// Causal-ready scheduling of queued changes on Hopper.
//
// Replaces automerge_tpu/ops/clock.py::schedule_queue (vmapped as
// schedule_queue_batch), which the JAX package leaves to XLA as a
// fixpoint of lax.scan passes inside a lax.while_loop; same contract as
// the plain version automerge_tpu_torch/ops/clock.py::
// schedule_queue_batch.
//
// Per doc, passes walk the queue in order until a pass applies nothing.
// Change i is ready when it is valid, has an actor, is still NOT_APPLIED
// and every entry of its dependency row is covered by the doc's clock,
// with the row's own-actor entry overwritten by seq - 1.  A ready change
// whose seq the clock already covers is a duplicate (order -2, no count);
// any other ready change takes the next application position and moves
// the clock at once, so change i + 1 sees change i in the same pass.
//
// Design: one block per doc.  The doc's clock sits in shared memory and
// the changes are walked one by one within each pass, which reproduces
// the scan's carry exactly.  The block's threads split the readiness
// test across the A actors (each ANDs its strided share of
// dep_row <= clock, then a block-wide vote); thread 0 then updates the
// clock and the order.  For A <= 32 the block is one warp and the vote
// is a warp vote with no block barrier; for larger A it is a block of up
// to 1024 threads, each covering A / blockDim actors, so the kernel takes
// any A whose clock fits shared memory (A <= 58,112).  A change that is
// not a candidate (padding, invalid, already ordered) is skipped by every
// thread alike without a vote.
//
// Bound: the walk is sequential within a doc (two barriers per candidate
// change and pass), so the time is latency: C x passes barrier rounds
// per doc, with docs running in parallel across the SMs.  The bytes are
// the dependency rows (C x A words per pass, read from L2 after the
// first) and the order; the arithmetic is one compare per actor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNotApplied = 2147483647;
constexpr int32_t kDuplicate = -2;

template <bool kWarp>
__device__ __forceinline__ void block_sync() {
  if (kWarp) __syncwarp(); else __syncthreads();
}

template <bool kWarp>
__device__ __forceinline__ bool block_all(bool v) {
  if (kWarp) return __all_sync(0xffffffffu, v);
  return __syncthreads_and(v) != 0;
}

template <bool kWarp>
__global__ void schedule_kernel(const int32_t* __restrict__ clock0,
                                const int32_t* __restrict__ actor,
                                const int32_t* __restrict__ seq,
                                const int32_t* __restrict__ deps,
                                const bool* __restrict__ valid,
                                int32_t* __restrict__ order,
                                int32_t* __restrict__ clock_out,
                                int64_t C, int64_t A) {
  extern __shared__ int32_t clk[];
  __shared__ int progress;
  const int64_t d = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int32_t* act = actor + d * C;
  const int32_t* sq = seq + d * C;
  const bool* val = valid + d * C;
  const int32_t* dep = deps + d * C * A;
  int32_t* ord = order + d * C;

  for (int64_t a = tid; a < A; a += nt) clk[a] = clock0[d * A + a];
  for (int64_t i = tid; i < C; i += nt) ord[i] = kNotApplied;
  int32_t counter = 0;  // thread 0's
  __syncthreads();

  while (true) {
    if (tid == 0) progress = 0;
    block_sync<kWarp>();
    for (int64_t i = 0; i < C; ++i) {
      const int32_t a = act[i];
      // uniform across the block: every thread reads the same words, and
      // ord[i] was last written by thread 0 before a barrier
      if (!val[i] || a < 0 || a >= A || ord[i] != kNotApplied) continue;
      const int32_t s = sq[i];
      const int32_t* row = dep + i * A;
      bool mine = true;
      for (int64_t b = tid; b < A; b += nt) {
        const int32_t want = (b == a) ? s - 1 : row[b];
        mine &= want <= clk[b];
      }
      if (block_all<kWarp>(mine)) {
        if (tid == 0) {
          if (s <= clk[a]) {
            ord[i] = kDuplicate;
          } else {
            clk[a] = s;
            ord[i] = counter++;
          }
          progress = 1;
        }
        block_sync<kWarp>();
      }
    }
    block_sync<kWarp>();
    const int p = progress;
    block_sync<kWarp>();
    if (!p) break;
  }
  for (int64_t a = tid; a < A; a += nt) clock_out[d * A + a] = clk[a];
}

template <bool kWarp>
int launch(const int32_t* clock0, const int32_t* actor, const int32_t* seq,
           const int32_t* deps, const bool* valid, int32_t* order,
           int32_t* clock_out, int64_t D, int64_t C, int64_t A,
           cudaStream_t s) {
  const size_t smem = static_cast<size_t>(A) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        schedule_kernel<kWarp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = 32;
  if (!kWarp) {
    const int64_t want = (A + 31) / 32 * 32;
    threads = static_cast<int>(want < 1024 ? want : 1024);
  }
  schedule_kernel<kWarp><<<static_cast<unsigned>(D), threads, smem, s>>>(
      clock0, actor, seq, deps, valid, order, clock_out, C, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// clock [D, A], actor/seq [D, C], deps [D, C, A] int32; valid [D, C] bool;
// writes order [D, C] and new_clock [D, A] (int32).  Returns a cudaError_t.
extern "C" int amtpu_torch_schedule(const void* clock, const void* actor,
                                    const void* seq, const void* deps,
                                    const void* valid, void* order,
                                    void* new_clock, int64_t D, int64_t C,
                                    int64_t A, void* stream) {
  if (D <= 0) return 0;
  if (A <= 0 || A > 58112 || D > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c0 = static_cast<const int32_t*>(clock);
  const auto* ac = static_cast<const int32_t*>(actor);
  const auto* sq = static_cast<const int32_t*>(seq);
  const auto* dp = static_cast<const int32_t*>(deps);
  const auto* vl = static_cast<const bool*>(valid);
  auto* od = static_cast<int32_t*>(order);
  auto* nc = static_cast<int32_t*>(new_clock);
  if (A <= 32) return launch<true>(c0, ac, sq, dp, vl, od, nc, D, C, A, s);
  return launch<false>(c0, ac, sq, dp, vl, od, nc, D, C, A, s);
}
