// Sliding-window LWW register resolution on Hopper.
//
// Replaces the TPU kernel automerge_tpu/ops/pallas_registers.py::_kernel
// (launched by resolve_registers_pallas); same contract as the plain
// version automerge_tpu_torch/ops/registers.py::resolve_registers.
//
// Rows are sorted by (group, time) on the host (`sort_idx`).  Sorted row
// i sees itself (slot 0) and its W predecessors i-1..i-W (slots 1..W) as
// the register's member window; predecessors before row 0 are invalid,
// as the Pallas kernel's front pad of group -2 makes them.  One thread
// resolves one sorted row:
//   * it gathers its W+1 members through sort_idx (no host-side
//     (group, time) gather, no halo copies),
//   * reads each pairwise clock P[u][v] = clock_table[cidx_u * A +
//     actor_v] straight from the deduplicated clock table with int64
//     index arithmetic (cidx * A passes 2^31 on large pool tables),
//   * keeps supersession / aliveness as bit masks in registers and
//     orders survivors by a pairwise count over (actor desc, time desc),
//   * writes winner, conflicts, alive_after, visible_before, overflow and
//     the packed transfer word at the row's original index sort_idx[i].
//
// Bound: bytes.  Each row reads 8 int32 columns and W+1 gathered member
// rows plus at most W(W+1) clock entries, and writes W+5 words; the
// arithmetic is a few hundred integer operations per row.  The member
// gathers hit rows just before i in sorted order, so they are served
// from L1/L2 rather than device memory; the design keeps every
// intermediate in registers so no [T, W+1, W+1] tensor is ever stored.
//
// Any T is accepted (no multiple-of-128 restriction).  W is 2, 4, 8 or
// 16: the pool picks the smallest power of two that holds the batch's
// widest register group, up to ops/registers.py SLIDING_MAX; member masks
// are 32-bit, so W + 1 <= 32.  alive_in is all true by contract (checked
// by the Python wrapper).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kWinnerNone = 0xffffff;
constexpr int kAliveShift = 24;
constexpr int32_t kAliveMax = 63;
constexpr int kOvfShift = 30;

template <int W>
__global__ void registers_kernel(
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
  const int threads = 128;
  const int64_t blocks = (T + threads - 1) / threads;
  registers_kernel<W><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
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
