// Sliding-window LWW register resolution on Hopper.
//
// Replaces the TPU kernel automerge_tpu/ops/pallas_registers.py::_kernel
// (launched by resolve_registers_pallas); same contract as the plain
// version automerge_tpu_torch/ops/registers.py::resolve_registers.
//
// Rows are sorted by (group, time) on the host (`sort_idx`).  Sorted row
// i sees itself and its W predecessors i-1..i-W as the register's member
// window; predecessors before row 0 are invalid (group -2), as the
// Pallas kernel's front pad makes them.  A member is valid when it lies
// in row i's group (group >= 0); sorted rows of one group are
// contiguous, so the valid members are the run of same-group rows back
// from i, capped at W.  Member v is superseded in row i's window when a
// later valid member u (v < u <= i) is not concurrent with it.
//
// Design for W = 4, 8 and 16 (the staged form).  A block owns kRows
// consecutive sorted rows [i0, i0 + kRows), one per thread:
//   * it gathers rows [i0 - W, i0 + kRows) through sort_idx ONCE each
//     into shared memory (group, time, actor, seq, clock row, is_del,
//     source row), instead of every thread re-gathering its W + 1
//     members (6 (W + 1) loads per row at W = 16);
//   * per staged row v it finds its first superseder
//       first_sup(v) = least u in (v, min(v + W, last staged row)]
//                      of v's group with not-concurrent(u, v),
//     stopping at the group's end: at most W clock pairs (two int64-
//     indexed clock-table reads each; cidx * A passes 2^31 on large pool
//     tables) per row instead of up to W (W + 1) / 2 per row;
//   * row i's masks then follow from shared memory with no pair loop:
//     superseded(v) = first_sup(v) <= i, superseded without self
//     (visible_before) = first_sup(v) <= i - 1, overflow = the valid run
//     reaches W predecessors.  The cap at the tile's last row is exact:
//     every superseder that matters for a row of the tile is <= that row;
//   * alive members are ordered by a pairwise (actor desc, time desc)
//     count over the alive set only; coinciding positions sum src + 1 as
//     the plain version's masked sums do;
//   * the row's W conflict words go out as 16-byte vector stores at its
//     original row sort_idx[i].
// W = 2 keeps the thread-per-row form of the first port (below): with
// three members per row it holds 78% of its byte bound, and the staged
// form ran slower there (PERF.md).
//
// Bound: bytes, plus the random-gather rate.  Each row's eight input
// words are read once (the sort_idx permutation makes the column reads
// random; the columns of a main-path batch fit L2), about two clock
// entries per row are read, and W + 5 words are written, scattered to
// the original rows; the arithmetic is a few dozen integer operations
// per row.
//
// Any T is accepted.  W is 2, 4, 8 or 16: the pool picks the smallest
// power of two that holds the batch's widest register group, up to
// ops/registers.py SLIDING_MAX; member masks are 32-bit, so W + 1 <= 32.
// alive_in is all true by contract (checked by the Python wrapper).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kWinnerNone = 0xffffff;
constexpr int kAliveShift = 24;
constexpr int32_t kAliveMax = 63;
constexpr int kOvfShift = 30;
constexpr int kRows = 128;          // sorted rows (and threads) per block
constexpr int kNoSup = 1 << 30;     // first_sup: no superseder in the tile

template <int W>
__global__ void __launch_bounds__(kRows) registers_kernel(
    const int32_t* __restrict__ group, const int32_t* __restrict__ time,
    const int32_t* __restrict__ actor, const int32_t* __restrict__ seq,
    const uint8_t* __restrict__ is_del, const int32_t* __restrict__ sort_idx,
    const int32_t* __restrict__ clock_table,
    const int32_t* __restrict__ clock_idx, int32_t* __restrict__ winner,
    int32_t* __restrict__ conflicts, int32_t* __restrict__ alive_after,
    uint8_t* __restrict__ visible_before, uint8_t* __restrict__ overflow,
    int32_t* __restrict__ packed, int64_t T, int64_t A) {
  static_assert(W % 4 == 0, "conflict rows go out as 16-byte stores");
  constexpr int S = kRows + W;      // staged rows: W halo + the tile
  __shared__ int32_t g_s[S], q_s[S], c_s[S], src_s[S];
  __shared__ uint8_t del_s[S];
  // per staged row, one 8-byte read each: (actor, time), and (group,
  // first superseder or -1 for a del op, which never joins the register)
  __shared__ int2 at_s[S], gs_s[S];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int tid = threadIdx.x;

  for (int k = tid; k < S; k += kRows) {
    const int64_t p = i0 - W + k;
    if (p >= 0 && p < T) {
      const int32_t s = sort_idx[p];
      src_s[k] = s;
      g_s[k] = group[s];
      at_s[k] = make_int2(actor[s], time[s]);
      q_s[k] = seq[s];
      c_s[k] = clock_idx[s];
      del_s[k] = is_del[s];
    } else {
      src_s[k] = -1;
      g_s[k] = -2;
      at_s[k] = make_int2(0, 0);
      q_s[k] = c_s[k] = 0;
      del_s[k] = 0;
    }
  }
  __syncthreads();

  for (int v = tid; v < S; v += kRows) {
    int fs = kNoSup;
    const int32_t gv = g_s[v];
    if (gv >= 0) {
      const int64_t row_v = static_cast<int64_t>(c_s[v]) * A;
      const int32_t av = at_s[v].x, qv = q_s[v];
      const int hi = min(v + W, S - 1);
      for (int u = v + 1; u <= hi && g_s[u] == gv; ++u) {
        const int32_t p_uv = clock_table[static_cast<int64_t>(c_s[u]) * A +
                                         av];
        const int32_t p_vu = clock_table[row_v + at_s[u].x];
        if (!(p_uv < qv && p_vu < q_s[u])) {
          fs = u;
          break;
        }
      }
    }
    gs_s[v] = make_int2(gv, del_s[v] ? -1 : fs);
  }
  __syncthreads();

  if (i0 + tid >= T) return;
  const int x = W + tid;          // sorted row i0 + tid, staged
  const int32_t gc = g_s[x];
  const int64_t o = src_s[x];     // its original row
  // slot w holds staged row x - w.  The loop is unrolled on purpose: the
  // rolled form, with a data-dependent trip count, was miscompiled by
  // ptxas -O3 (CUDA 12.9), which reused its decremented index after the
  // loop as if it were the row's own.
  int run = 0;                    // valid predecessors
  unsigned alive = 0, alive_before = 0;
  if (gc >= 0) {
    if (!del_s[x]) alive = alive_before = 1u;
    bool in_run = true;
#pragma unroll
    for (int w = 1; w <= W; ++w) {
      const int2 m = gs_s[x - w];
      in_run = in_run && m.x == gc;
      if (in_run) {
        run = w;
        if (m.y > x) alive |= 1u << w;
        if (m.y > x - 1) alive_before |= 1u << w;
      }
    }
  }
  const int32_t n_alive = __popc(alive);

  int32_t win_acc = 0;
  int32_t conf_acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) conf_acc[k] = 0;
  for (unsigned mu = alive; mu; mu &= mu - 1) {
    const int u = x - (__ffs(mu) - 1);
    const int2 me = at_s[u];
    int pos = 0;
    for (unsigned mv = alive; mv; mv &= mv - 1) {
      const int2 m = at_s[x - (__ffs(mv) - 1)];
      if (m.x > me.x || (m.x == me.x && m.y > me.y)) ++pos;
    }
    const int32_t src1 = src_s[u] + 1;
    if (pos == 0) win_acc += src1;
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (pos == k + 1) conf_acc[k] += src1;
  }
  const int32_t win = win_acc - 1;
  const bool ovf = gc >= 0 && run == W;

  winner[o] = win;
  int4* dst = reinterpret_cast<int4*>(conflicts + o * W);
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    dst[k] = make_int4(conf_acc[4 * k] - 1, conf_acc[4 * k + 1] - 1,
                       conf_acc[4 * k + 2] - 1, conf_acc[4 * k + 3] - 1);
  alive_after[o] = n_alive;
  visible_before[o] = (alive_before >> 1) != 0;
  overflow[o] = ovf;
  packed[o] = (win >= 0 ? win : kWinnerNone) |
              (min(n_alive, kAliveMax) << kAliveShift) |
              (static_cast<int32_t>(ovf) << kOvfShift);
}

// W = 2: one thread resolves one sorted row from its three members,
// gathered through sort_idx, with the three clock pairs read directly.
// At this width the form holds 78% of its byte bound and the staged form
// above ran slower on the pool's config-3 input, so W = 2 keeps this body
// (PERF.md).
template <int W>
__global__ void registers_row_kernel(
    const int32_t* __restrict__ group, const int32_t* __restrict__ time,
    const int32_t* __restrict__ actor, const int32_t* __restrict__ seq,
    const uint8_t* __restrict__ is_del, const int32_t* __restrict__ sort_idx,
    const int32_t* __restrict__ clock_table,
    const int32_t* __restrict__ clock_idx, int32_t* __restrict__ winner,
    int32_t* __restrict__ conflicts, int32_t* __restrict__ alive_after,
    uint8_t* __restrict__ visible_before, uint8_t* __restrict__ overflow,
    int32_t* __restrict__ packed, int64_t T, int64_t A) {
  constexpr int M = W + 1;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= T) return;

  int32_t g[M], t[M], a[M], q[M], c[M], src[M];
  unsigned del = 0;
#pragma unroll
  for (int w = 0; w < M; ++w) {
    const int64_t p = i - w;
    if (p >= 0) {
      const int32_t s = sort_idx[p];
      src[w] = s;
      g[w] = group[s];
      t[w] = time[s];
      a[w] = actor[s];
      q[w] = seq[s];
      c[w] = clock_idx[s];
      if (is_del[s]) del |= 1u << w;
    } else {
      src[w] = -1;
      g[w] = -2;
      t[w] = a[w] = q[w] = c[w] = 0;
    }
  }
  const int32_t gc = g[0];
  unsigned valid = 0;
#pragma unroll
  for (int w = 0; w < M; ++w)
    if (gc >= 0 && g[w] == gc) valid |= 1u << w;

  // supersedes[u][v]: u later than v (slot u < slot v), both valid, and
  // not concurrent -- so only slots v >= 1 can be superseded
  unsigned superseded = 0, superseded_wo_self = 0;
#pragma unroll
  for (int v = 1; v < M; ++v) {
#pragma unroll
    for (int u = 0; u < v; ++u) {
      if (!((valid >> u) & (valid >> v) & 1u)) continue;
      const int32_t p_uv = clock_table[static_cast<int64_t>(c[u]) * A + a[v]];
      const int32_t p_vu = clock_table[static_cast<int64_t>(c[v]) * A + a[u]];
      const bool concurrent = (p_uv < q[v]) && (p_vu < q[u]);
      if (!concurrent) {
        superseded |= 1u << v;
        if (u >= 1) superseded_wo_self |= 1u << v;
      }
    }
  }
  const unsigned alive = valid & ~superseded & ~del;
  const unsigned alive_before = valid & ~superseded_wo_self & ~del;
  const int32_t n_alive = __popc(alive);

  // output position of each alive member: #{v alive : actor_v > actor_u
  // or (actor_v == actor_u and time_v > time_u)}; slot 0 -> winner,
  // slot k -> conflicts[k - 1].  Sums (not stores) so coinciding
  // positions resolve exactly as the plain version's masked sums do.
  int32_t win_acc = 0;
  int32_t conf_acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) conf_acc[k] = 0;
#pragma unroll
  for (int u = 0; u < M; ++u) {
    if (!((alive >> u) & 1u)) continue;
    int pos = 0;
#pragma unroll
    for (int v = 0; v < M; ++v)
      if (((alive >> v) & 1u) &&
          (a[v] > a[u] || (a[v] == a[u] && t[v] > t[u])))
        ++pos;
    if (pos == 0) {
      win_acc += src[u] + 1;
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if (pos == k + 1) conf_acc[k] += src[u] + 1;
    }
  }
  const int32_t win = win_acc - 1;
  const unsigned full = ((1u << M) - 1u) & ~1u;
  const bool ovf = gc >= 0 && (valid & full) == full;

  const int64_t o = src[0];
  winner[o] = win;
#pragma unroll
  for (int k = 0; k < W; ++k) conflicts[o * W + k] = conf_acc[k] - 1;
  alive_after[o] = n_alive;
  visible_before[o] = (alive_before >> 1) != 0;
  overflow[o] = ovf;
  packed[o] = (win >= 0 ? win : kWinnerNone) |
              (min(n_alive, kAliveMax) << kAliveShift) |
              (static_cast<int32_t>(ovf) << kOvfShift);
}

template <int W>
cudaError_t launch(const void* const* in, void* const* out, int64_t T,
                   int64_t A, cudaStream_t stream) {
  const int64_t blocks = (T + kRows - 1) / kRows;
  auto kernel = [] {
    if constexpr (W == 2) return registers_row_kernel<W>;
    else return registers_kernel<W>;
  }();
  kernel<<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(
      static_cast<const int32_t*>(in[0]), static_cast<const int32_t*>(in[1]),
      static_cast<const int32_t*>(in[2]), static_cast<const int32_t*>(in[3]),
      static_cast<const uint8_t*>(in[4]), static_cast<const int32_t*>(in[5]),
      static_cast<const int32_t*>(in[6]), static_cast<const int32_t*>(in[7]),
      static_cast<int32_t*>(out[0]), static_cast<int32_t*>(out[1]),
      static_cast<int32_t*>(out[2]), static_cast<uint8_t*>(out[3]),
      static_cast<uint8_t*>(out[4]), static_cast<int32_t*>(out[5]), T, A);
  return cudaGetLastError();
}

}  // namespace

extern "C" int amtpu_torch_registers(
    const void* group, const void* time, const void* actor, const void* seq,
    const void* is_del, const void* sort_idx, const void* clock_table,
    const void* clock_idx, void* winner, void* conflicts, void* alive_after,
    void* visible_before, void* overflow, void* packed, int64_t T, int W,
    int64_t A, void* stream) {
  if (T <= 0) return 0;
  // the conflict rows go out as 16-byte vector stores (W >= 4)
  if (reinterpret_cast<uintptr_t>(conflicts) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const void* in[8] = {group, time, actor, seq, is_del, sort_idx,
                       clock_table, clock_idx};
  void* out[6] = {winner, conflicts, alive_after, visible_before, overflow,
                  packed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 2: return launch<2>(in, out, T, A, s);
    case 4: return launch<4>(in, out, T, A, s);
    case 8: return launch<8>(in, out, T, A, s);
    case 16: return launch<16>(in, out, T, A, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
