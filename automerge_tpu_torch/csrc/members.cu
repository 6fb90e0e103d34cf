// Member-window LWW register resolution on Hopper (K3).
//
// Replaces automerge_tpu/ops/registers.py::resolve_registers_members,
// which the JAX package leaves to XLA (no Pallas kernel): XLA builds the
// pairwise clock P[T, W+1, W+1] through a one-hot einsum and reduces it.
// Same contract as the plain version
// automerge_tpu_torch/ops/registers.py::resolve_registers_members.  It
// serves the pool's member-mode base dispatch (W = 8) and every tier of
// the escalation ladder (W = 16 ... 1024).
//
// Row t's members are slot 0 (row t itself) and slots 1..W (mem_idx[t],
// -1 = empty; indexes are clipped to [0, T) as the plain version's
// gather clips them).  Member u supersedes member v when both are valid,
// time_u > time_v and they are not concurrent:
//   concurrent(u, v) = clock(u)[actor_v] < seq_v && clock(v)[actor_u] < seq_u
// alive = valid & !superseded & !is_del; visible_before is the same over
// slots 1..W with superseders from slots 1..W only.  Each alive member's
// output position is the count of alive members before it in (actor
// desc, time desc) order; position 0 is the winner, 1..W the conflict
// row.  Positions that coincide sum src + 1, as the plain version's
// masked sums do.  alive_after stays unsaturated (the ladder's collect
// selects conflict rows on it); only the packed word saturates at 63.
//
// Design.  A block owns R rows and G threads per row; thread `lane` owns
// members lane and lane + G (G = W + 1 up to W = 512; at W = 1024 each
// thread owns two of the 1025 members).  The row's members (actor, seq,
// time, clock row, source row, valid, is_del) are staged in shared
// memory once.  For W <= 64 the row's whole pairwise clock
// P[u][v] = clock(u)[actor_v] is staged too, read row by row so that the
// lanes of a warp read neighbouring columns of one clock row; the pair
// loop then reads P[u][v] and P[v][u] from shared memory (M = W + 1 is
// odd, so the strided column read has no bank conflict).  Above 64 the
// (W + 1)^2 words would not fit, and the pair loop reads the clock table
// directly (int64 index: cidx * A passes 2^31 on a large pool table).
// Each thread scans the members later than its own for a non-concurrent
// one and stops at the first; the ordering count is a second pass over
// the alive members.  Both are O(W^2) per row, spread over the row's
// threads.
//
// Bound: bytes at the main path's shapes (the [T, W] member matrix in
// and the [T, W] conflict rows out, about 8 W + 40 bytes per row);
// operations (O(W^2) pair tests per row) only where nearly every slot
// holds a member.  The kernel is far from either: its two O(W^2) loops
// make about a dozen shared-memory reads per member pair (PERF.md), a
// simple first design.  W is a template constant: a rolled window loop
// at -O3 has been miscompiled before (csrc/registers.cu), and every W is
// checked on the card by chip_smoke.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kWinnerNone = 0xffffff;
constexpr int kAliveShift = 24;
constexpr int32_t kAliveMax = 63;

template <int W>
struct Layout {
  static constexpr int M = W + 1;                    // members per row
  static constexpr int PER = (M + 1023) / 1024;      // members per thread
  static constexpr int G = (M + PER - 1) / PER;      // threads per row
  static constexpr bool kStageP = W <= 64;           // P in shared memory
  static constexpr int PS = kStageP ? M * M : 1;
  static constexpr int ROW_BYTES = PS * 4 + M * (6 * 4 + 2);
  static constexpr int R0 = G >= 256 ? 1 : 256 / G;
  static constexpr int R1 = 45000 / ROW_BYTES;       // static smem < 48 KB
  static constexpr int R = R0 < R1 ? R0 : (R1 > 0 ? R1 : 1);
  static constexpr int THREADS = R * G;
};

template <int W>
__global__ void __launch_bounds__(Layout<W>::THREADS) members_kernel(
    const int32_t* __restrict__ time, const int32_t* __restrict__ actor,
    const int32_t* __restrict__ seq, const int32_t* __restrict__ clock_idx,
    const uint8_t* __restrict__ is_del, const int32_t* __restrict__ mem_idx,
    const int32_t* __restrict__ clock_table, int32_t* __restrict__ winner,
    int32_t* __restrict__ conflicts, int32_t* __restrict__ alive_after,
    uint8_t* __restrict__ visible_before, uint8_t* __restrict__ overflow,
    int32_t* __restrict__ packed, int64_t T, int64_t A) {
  using L = Layout<W>;
  constexpr int M = L::M, G = L::G, R = L::R, PER = L::PER;
  __shared__ int32_t a_s[R][M], q_s[R][M], t_s[R][M], c_s[R][M];
  __shared__ int32_t src_s[R][M], slot_s[R][M];
  __shared__ uint8_t vd_s[R][M];      // bit 0 valid, bit 1 is_del
  __shared__ uint8_t alive_s[R][M];
  __shared__ int32_t p_s[R][L::PS];   // P[u * M + v] = clock(u)[actor_v]
  __shared__ int32_t count_s[R], vb_s[R];

  const int r = threadIdx.x / G;
  const int lane = threadIdx.x - r * G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * R + r;
  const bool live = row < T;

  // 1. stage the row's members
  if (live) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int m = lane + k * G;
      if (m < M) {
        const int64_t idx = m == 0 ? row : static_cast<int64_t>(
            __ldg(mem_idx + row * W + (m - 1)));
        const bool valid = m == 0 || idx >= 0;
        const int64_t c = idx < 0 ? 0 : (idx >= T ? T - 1 : idx);
        a_s[r][m] = __ldg(actor + c);
        q_s[r][m] = __ldg(seq + c);
        t_s[r][m] = __ldg(time + c);
        c_s[r][m] = __ldg(clock_idx + c);
        src_s[r][m] = static_cast<int32_t>(c);
        vd_s[r][m] = (valid ? 1 : 0) | (__ldg(is_del + c) ? 2 : 0);
        slot_s[r][m] = 0;
      }
    }
    if (lane == 0) {
      count_s[r] = 0;
      vb_s[r] = 0;
    }
  }
  __syncthreads();

  // 2. (W <= 64) the row's pairwise clock, one clock row per step
  if constexpr (L::kStageP) {
    if (live) {
      for (int e = lane; e < M * M; e += G) {
        const int u = e / M, v = e - u * M;
        p_s[r][e] = __ldg(clock_table + static_cast<int64_t>(c_s[r][u]) * A +
                          a_s[r][v]);
      }
    }
    __syncthreads();
  }

  // 3. supersession: is member x superseded (by any member / by slots
  //    1..W only)?
  if (live) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int x = lane + k * G;
      if (x >= M) continue;
      const uint8_t vd = vd_s[r][x];
      bool sup = false, sup_wo_self = false;
      if (vd & 1) {
        const int32_t ax = a_s[r][x], qx = q_s[r][x], tx = t_s[r][x];
        const int64_t cx = static_cast<int64_t>(c_s[r][x]) * A;
        auto supersedes = [&](int y) {
          // y is later than x and valid: y supersedes x unless concurrent
          int32_t y_at_x, x_at_y;
          if constexpr (L::kStageP) {
            y_at_x = p_s[r][y * M + x];
            x_at_y = p_s[r][x * M + y];
          } else {
            y_at_x = __ldg(clock_table +
                           static_cast<int64_t>(c_s[r][y]) * A + ax);
            x_at_y = __ldg(clock_table + cx + a_s[r][y]);
          }
          return !(y_at_x < qx && x_at_y < q_s[r][y]);
        };
        for (int y = 1; y < M; ++y) {
          if ((vd_s[r][y] & 1) && t_s[r][y] > tx && supersedes(y)) {
            sup_wo_self = true;
            break;
          }
        }
        sup = sup_wo_self || (t_s[r][0] > tx && supersedes(0));
      }
      const bool valid_live = (vd & 1) && !(vd & 2);
      alive_s[r][x] = valid_live && !sup;
      if (x >= 1 && valid_live && !sup_wo_self) vb_s[r] = 1;
    }
  }
  __syncthreads();

  // 4. output positions of the alive members
  if (live) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int x = lane + k * G;
      if (x >= M || !alive_s[r][x]) continue;
      const int32_t ax = a_s[r][x], tx = t_s[r][x];
      int pos = 0;
      for (int y = 0; y < M; ++y) {
        const int32_t ay = a_s[r][y];
        pos += alive_s[r][y] && (ay > ax || (ay == ax && t_s[r][y] > tx));
      }
      atomicAdd(&slot_s[r][pos], src_s[r][x] + 1);
      atomicAdd(&count_s[r], 1);
    }
  }
  __syncthreads();

  // 5. the row's outputs
  if (live) {
    for (int k = lane; k < W; k += G)
      conflicts[row * W + k] = slot_s[r][k + 1] - 1;
    if (lane == 0) {
      const int32_t win = slot_s[r][0] - 1;
      const int32_t n_alive = count_s[r];
      winner[row] = win;
      alive_after[row] = n_alive;
      overflow[row] = 0;
      if (visible_before != nullptr) visible_before[row] = vb_s[r] != 0;
      packed[row] = (win >= 0 ? win : kWinnerNone) |
                    (min(n_alive, kAliveMax) << kAliveShift);
    }
  }
}

template <int W>
cudaError_t launch(const void* const* in, void* const* out, int64_t T,
                   int64_t A, cudaStream_t stream) {
  using L = Layout<W>;
  const int64_t blocks = (T + L::R - 1) / L::R;
  members_kernel<W><<<static_cast<unsigned>(blocks), L::THREADS, 0,
                      stream>>>(
      static_cast<const int32_t*>(in[0]), static_cast<const int32_t*>(in[1]),
      static_cast<const int32_t*>(in[2]), static_cast<const int32_t*>(in[3]),
      static_cast<const uint8_t*>(in[4]), static_cast<const int32_t*>(in[5]),
      static_cast<const int32_t*>(in[6]), static_cast<int32_t*>(out[0]),
      static_cast<int32_t*>(out[1]), static_cast<int32_t*>(out[2]),
      static_cast<uint8_t*>(out[3]), static_cast<uint8_t*>(out[4]),
      static_cast<int32_t*>(out[5]), T, A);
  return cudaGetLastError();
}

}  // namespace

// visible_before may be null (the caller did not ask for it).
extern "C" int amtpu_torch_members(
    const void* time, const void* actor, const void* seq,
    const void* clock_idx, const void* is_del, const void* mem_idx,
    const void* clock_table, void* winner, void* conflicts,
    void* alive_after, void* visible_before, void* overflow, void* packed,
    int64_t T, int W, int64_t A, void* stream) {
  if (T <= 0) return 0;
  const void* in[7] = {time, actor, seq, clock_idx, is_del, mem_idx,
                       clock_table};
  void* out[6] = {winner, conflicts, alive_after, visible_before, overflow,
                  packed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8: return launch<8>(in, out, T, A, s);
    case 16: return launch<16>(in, out, T, A, s);
    case 32: return launch<32>(in, out, T, A, s);
    case 64: return launch<64>(in, out, T, A, s);
    case 128: return launch<128>(in, out, T, A, s);
    case 256: return launch<256>(in, out, T, A, s);
    case 512: return launch<512>(in, out, T, A, s);
    case 1024: return launch<1024>(in, out, T, A, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
