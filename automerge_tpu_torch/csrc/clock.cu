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
// Design: one warp per doc, several docs to a block.  Each pass walks
// the queue a window of 32 changes at a time, one change per lane.  Each
// candidate lane counts its unmet actors (entries above the clock) once,
// against the clock at the window's start, and knows whether its seq is
// already covered (a duplicate).  Then
//   ready = ballot(candidate && unmet == 0)
// and the lowest ready lane is the next change the sequential walk
// applies: every candidate below it was tested against this same clock
// and was not ready.  Its actor, seq and duplicate bit go to every lane
// in three independent shuffles.  Applying it moves at most one clock
// entry (actor a to seq s, from s - 1), so a lane above it only drops
// its unmet count by one when its wanted entry for a is exactly s; lanes
// at or below it are not revisited in this pass.  One applied change
// thus costs a ballot, the shuffles and one shared-memory read, not a
// chain of global loads and block barriers.  The counts are recomputed
// at each window's visit (cheap at the step's A of 2-4; keeping them
// across windows would cost a scan of the queue's column per applied
// change).
//
// Two forms.  Resident (A <= 32 and the doc's queue fits shared memory,
// as on the step's inputs): the queue (actor, seq, order and the
// dependency rows, odd row stride) comes into shared memory once, with
// coalesced copies, and the passes never touch device memory; lane b
// holds the clock entry b in a register and each lane counts its own
// row.  Streamed (any other A up to 58,112): the clock sits in shared
// memory, each window's columns are read from device memory (L2 after
// the first pass), and the warp counts each candidate's row together
// (lanes stride the row, one warp reduction).
//
// Bound: the walk is sequential within a doc (one ballot round per
// applied change), so the time is latency: a few dozen cycles per
// applied change and per window visit, docs running in parallel as
// warps.  The bytes are the queue read once (resident) and the order and
// clock written once; the arithmetic is one compare per actor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNotApplied = 2147483647;
constexpr int32_t kDuplicate = -2;
constexpr unsigned kFull = 0xffffffffu;
//: docs (warps) per block at most
constexpr int kWarps = 8;
//: dynamic shared memory a block may ask for (bytes): the card's 227 KB
constexpr size_t kSmemMax = 227 * 1024;

// Row stride of the resident dependency rows (odd: conflict-free).
__host__ __device__ inline int64_t row_stride(int64_t A) { return A | 1; }

// Shared words of one warp: the resident queue (actor, seq, order and
// the dependency rows) or the streamed form's clock.
__host__ __device__ inline int64_t warp_words(bool resident, int64_t C,
                                              int64_t A) {
  return resident ? C * (3 + row_stride(A)) : A;
}

//: the most distinct actors a window's candidates may have for the
//: one-round resolution to be tried (a warp scan each)
constexpr int kSpecActors = 8;

// One round for a whole window (resident form): supposes every candidate
// applies in lane order and checks it.  For each actor a candidate
// authors, a warp max-scan gives every lane the clock entry it would
// see at its turn (the window-start entry, or the highest seq of that
// actor among the candidates below it); a lane's unmet count then drops
// by the entries those prefix clocks cover.  A lane's readiness depends
// only on the lanes below it, so if every candidate is ready under the
// prefix clocks of "all apply", that is the sequential walk's outcome:
// the candidates take positions in lane order (duplicates, whose seq
// the prefix clock covers, take -2) and the clock takes the prefix
// maxima.  Returns false, changing nothing, when some candidate would
// not be ready (or too many actors); the walk then goes change by
// change.  A queue delivered in causal order resolves a window a round.
__device__ __forceinline__ bool resolve_whole_window(
    bool cand, int32_t a, int32_t s, int32_t unmet, const int32_t* my_row,
    int32_t& clk, int32_t& counter, int32_t& my_ord) {
  const int lane = threadIdx.x & 31;
  const unsigned authors = __reduce_or_sync(kFull, cand ? 1u << a : 0u);
  if (__popc(authors) > kSpecActors) return false;
  int32_t left = unmet;   // unmet entries under the prefix clocks
  int32_t own_pre = 0;    // the own actor's entry at the lane's turn
  int32_t new_clk = clk;  // lane b: clock entry b after the window
  for (unsigned m = authors; m; m &= m - 1) {
    const int b = __ffs(m) - 1;
    const int32_t cb = __shfl_sync(kFull, clk, b);
    int32_t v = cand && a == b ? s : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = max(v, u);
    }
    const int32_t top = __shfl_sync(kFull, v, 31);
    int32_t below = __shfl_up_sync(kFull, v, 1);
    const int32_t pre = max(cb, lane ? below : 0);
    const int32_t want = a == b ? s - 1 : my_row[b];
    left -= (cand && want > cb && want <= pre) ? 1 : 0;
    own_pre = a == b ? pre : own_pre;
    new_clk = lane == b ? max(clk, top) : new_clk;
  }
  if (!__all_sync(kFull, !cand || left == 0)) return false;
  const bool dup = s <= own_pre;
  const unsigned fresh = __ballot_sync(kFull, cand && !dup);
  if (cand)
    my_ord = dup ? kDuplicate
                 : counter + __popc(fresh & ((1u << lane) - 1u));
  counter += __popc(fresh);
  clk = new_clk;
  return true;
}

template <bool kResident>
__global__ void schedule_kernel(const int32_t* __restrict__ clock0,
                                const int32_t* __restrict__ actor,
                                const int32_t* __restrict__ seq,
                                const int32_t* __restrict__ deps,
                                const bool* __restrict__ valid,
                                int32_t* __restrict__ order,
                                int32_t* __restrict__ clock_out, int64_t D,
                                int64_t C, int64_t A) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    warp;
  if (d >= D) return;  // the kernel has no block barrier
  const int64_t rs = row_stride(A);
  int32_t* sm = smem + warp * warp_words(kResident, C, A);
  // resident: the doc's queue, candidates' actors (-1: never a candidate)
  int32_t* s_act = sm;
  int32_t* s_seq = sm + C;
  int32_t* s_ord = sm + 2 * C;
  int32_t* s_dep = sm + 3 * C;
  const int32_t* dep = deps + d * C * A;
  int32_t* ord = kResident ? s_ord : order + d * C;

  // the clock: lane b's register (resident, A <= 32) or shared memory
  int32_t clk = 0;
  if (kResident) {
    if (lane < A) clk = clock0[d * A + lane];
    for (int64_t i = lane; i < C; i += 32) {
      const int32_t a = actor[d * C + i];
      s_act[i] = valid[d * C + i] && a >= 0 && a < A ? a : -1;
      s_seq[i] = seq[d * C + i];
    }
    for (int64_t k = lane; k < C * A; k += 32)
      s_dep[(k / A) * rs + k % A] = dep[k];
  } else {
    for (int64_t a = lane; a < A; a += 32) sm[a] = clock0[d * A + a];
  }
  for (int64_t i = lane; i < C; i += 32) ord[i] = kNotApplied;
  __syncwarp();

  int32_t counter = 0;  // uniform across the warp
  bool progress = true;
  while (progress) {
    progress = false;
    for (int64_t w0 = 0; w0 < C; w0 += 32) {
      const int64_t i = w0 + lane;
      const bool in = i < C;
      int32_t a = -1, s = 0;
      if (in) {
        if (kResident) {
          a = s_act[i];
          s = s_seq[i];
        } else {
          a = actor[d * C + i];
          s = seq[d * C + i];
          if (!valid[d * C + i] || a >= A) a = -1;
        }
      }
      // each lane reads back only the order entries it wrote itself
      bool cand = a >= 0 && ord[i] == kNotApplied;
      const unsigned cands = __ballot_sync(kFull, cand);
      if (cands == 0) continue;
      // the lane's dependency row in shared memory (resident form)
      const int32_t* my_row = s_dep + (in ? i : 0) * rs;
      int32_t unmet = 0;
      if (kResident) {
        for (int b = 0; b < A; ++b) {
          const int32_t cb = __shfl_sync(kFull, clk, b);
          const int32_t want = b == a ? s - 1 : my_row[b];
          unmet += (cand && want > cb) ? 1 : 0;
        }
      } else {
        for (unsigned m = cands; m; m &= m - 1) {
          const int j = __ffs(m) - 1;
          const int32_t aj = __shfl_sync(kFull, a, j);
          const int32_t sj = __shfl_sync(kFull, s, j);
          const int32_t* row = dep + (w0 + j) * A;
          unsigned n = 0;
          for (int64_t b = lane; b < A; b += 32) {
            const int32_t want = b == aj ? sj - 1 : row[b];
            n += want > sm[b] ? 1u : 0u;
          }
          n = __reduce_add_sync(kFull, n);
          if (lane == j) unmet = static_cast<int32_t>(n);
        }
      }
      // the clock entry of the lane's own actor: whether it is a duplicate
      int32_t own;
      if (kResident)
        own = __shfl_sync(kFull, clk, a >= 0 ? a : 0);
      else
        own = a >= 0 ? sm[a] : 0;
      bool dup_now = s <= own;
      int32_t my_ord = kNotApplied;
      if (kResident && resolve_whole_window(cand, a, s, unmet, my_row, clk,
                                            counter, my_ord)) {
        // every candidate applies, in lane order (a causal run)
        progress = true;
        if (my_ord != kNotApplied) ord[i] = my_ord;
        continue;
      }
      // the sequential walk over the window, one applied change a round,
      // branch-free but for the loop's exit (the rounds are a dependent
      // chain: ballot, shuffles, one shared read)
      unsigned above = kFull;  // lanes not yet passed in this pass
      while (true) {
        const unsigned ready =
            __ballot_sync(kFull, cand && unmet == 0) & above;
        if (ready == 0) break;
        const int r = __ffs(ready) - 1;
        const int32_t ar = __shfl_sync(kFull, a, r);
        const int32_t sr = __shfl_sync(kFull, s, r);
        const bool dup = __shfl_sync(kFull, dup_now, r);
        const bool me = lane == r;
        my_ord = me ? (dup ? kDuplicate : counter) : my_ord;
        cand = cand && !me;
        progress = true;
        if (!dup) {
          // clock[ar] moves from sr - 1 to sr
          ++counter;
          if (kResident) {
            clk = lane == ar ? sr : clk;
          } else {
            __syncwarp();
            if (lane == 0) sm[ar] = sr;
            __syncwarp();
          }
          const int32_t row_ar = kResident ? my_row[ar]
                                           : (cand ? dep[i * A + ar] : 0);
          const int32_t want = a == ar ? s - 1 : row_ar;
          unmet -= (cand && lane > r && unmet > 0 && want == sr) ? 1 : 0;
          dup_now = a == ar ? s <= sr : dup_now;
        }
        above = r == 31 ? 0u : (kFull << (r + 1));
      }
      if (my_ord != kNotApplied) ord[i] = my_ord;
    }
  }
  __syncwarp();
  if (kResident) {
    for (int64_t i = lane; i < C; i += 32) order[d * C + i] = s_ord[i];
    if (lane < A) clock_out[d * A + lane] = clk;
  } else {
    for (int64_t a = lane; a < A; a += 32) clock_out[d * A + a] = sm[a];
  }
}

template <bool kResident>
int launch(const int32_t* clock0, const int32_t* actor, const int32_t* seq,
           const int32_t* deps, const bool* valid, int32_t* order,
           int32_t* clock_out, int64_t D, int64_t C, int64_t A, int warps,
           cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(warp_words(kResident, C, A)) * warps *
      sizeof(int32_t);
  if (smem > 48 * 1024) {
    // the ceiling, not this call's size: the attribute is the function's,
    // so a call's own size could lower it under another thread's launch
    cudaError_t e = cudaFuncSetAttribute(
        schedule_kernel<kResident>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMax));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (D + warps - 1) / warps;
  schedule_kernel<kResident><<<static_cast<unsigned>(blocks),
                               static_cast<unsigned>(32 * warps), smem, s>>>(
      clock0, actor, seq, deps, valid, order, clock_out, D, C, A);
  return static_cast<int>(cudaGetLastError());
}

// Warps a block for the form: as many docs as fit kSmemMax (0: none).
int warps_for(bool resident, int64_t D, int64_t C, int64_t A) {
  const size_t per = static_cast<size_t>(warp_words(resident, C, A)) *
                     sizeof(int32_t);
  int64_t w = D < kWarps ? D : kWarps;
  while (w > 0 && per * w > kSmemMax) --w;
  return static_cast<int>(w);
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
  if (A <= 0 || A > 58112 || C < 0 || D > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c0 = static_cast<const int32_t*>(clock);
  const auto* ac = static_cast<const int32_t*>(actor);
  const auto* sq = static_cast<const int32_t*>(seq);
  const auto* dp = static_cast<const int32_t*>(deps);
  const auto* vl = static_cast<const bool*>(valid);
  auto* od = static_cast<int32_t*>(order);
  auto* nc = static_cast<int32_t*>(new_clock);
  const int resident = A <= 32 ? warps_for(true, D, C, A) : 0;
  if (resident > 0)
    return launch<true>(c0, ac, sq, dp, vl, od, nc, D, C, A, resident, s);
  return launch<false>(c0, ac, sq, dp, vl, od, nc, D, C, A,
                       warps_for(false, D, C, A), s);
}
