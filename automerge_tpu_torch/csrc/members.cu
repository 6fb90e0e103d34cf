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
// Design for W >= 16 (the tiers): bit words and span staging.
//   knows[u] bit v = clock(u)[actor_v] >= seq_v, so that
//   concurrent(u, v) = !knows[u].v && !knows[v].u.
// A block of 512 threads owns R consecutive rows (R = 64 up to W = 64,
// 4096 / W above).  A tier chunk is whole register groups in (group,
// time) order and every member of a row lies in its own group, so the
// rows of a block reference a short run of consecutive rows, its span
// [lo, hi] (derived here from mem_idx).  When the span holds at most
// kSpanMax rows, the block stages the span's columns once and builds:
//   knows[u] over the span, a warp per span row u with __ballot_sync (one
//     predicate per lane, one word per ballot, every word's loads issued
//     before the first ballot), reading one L1-cached clock row per span
//     row instead of the (W + 1)^2 clock words every row gathered before
//     (PERF.md, PR 3: about 195 rows per config-5 group, 4,225 words per
//     row at W = 64);
//   C[u] bit v = v later than u and not concurrent with it, and u's rank
//     in (actor desc, time desc) order, a word per thread.
// A row is then its member mask over the span: member x is superseded iff
// (members & C[x]) != 0; alive members set their rank's bit, and an alive
// member's position is the popcount of the alive bits below its rank.
// Rows whose window holds one row twice (never on the pool's path: C++
// windows are distinct), and every row of a block whose span is too long
// (a group of thousands of rows) or holds two rows of equal (actor, time)
// (equal ranks), take the per-row branch of the same kernel: the same bit
// words over the row's own W + 1 slots, built by the whole block, one row
// at a time.
//
// W = 8, the base pass, keeps the first design (`rowwise`, below): its
// rows are in batch order, so the members of a block's rows span the
// batch and no span fits; a row per W + 1 threads with the pairwise
// clock staged in shared memory.
//
// Bound: bytes at the main path's shapes (the [T, W] member matrix in
// and the [T, W] conflict rows out, about 8 W + 40 bytes per row);
// operations (O(W^2) pair tests per row) only where nearly every slot
// holds a member.  W is a template constant: a rolled window loop at -O3
// has been miscompiled before (csrc/registers.cu), and every W is
// checked on the card by chip_smoke.py.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int32_t kWinnerNone = 0xffffff;
constexpr int kAliveShift = 24;
constexpr int32_t kAliveMax = 63;

struct Outputs {
  int32_t* winner;
  int32_t* conflicts;
  int32_t* alive_after;
  uint8_t* visible_before;   // null: not asked for
  uint8_t* overflow;
  int32_t* packed;
};

__device__ __forceinline__ void write_row(const Outputs& o, int64_t row,
                                          int32_t win, int32_t n_alive,
                                          bool vb) {
  o.winner[row] = win;
  o.alive_after[row] = n_alive;
  o.overflow[row] = 0;
  if (o.visible_before != nullptr) o.visible_before[row] = vb;
  o.packed[row] = (win >= 0 ? win : kWinnerNone) |
                  (min(n_alive, kAliveMax) << kAliveShift);
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// W = 8: a row per W + 1 threads (the first design)
// ---------------------------------------------------------------------------

template <int W>
struct Layout {
  static_assert(W <= 64, "a row's pairwise clock is staged in shared memory");
  static constexpr int M = W + 1;                    // members = threads per row
  static constexpr int ROW_BYTES = M * M * 4 + M * (6 * 4 + 2);
  static constexpr int R0 = 256 / M;
  static constexpr int R1 = 45000 / ROW_BYTES;       // static smem < 48 KB
  static constexpr int R = R0 < R1 ? R0 : R1;
  static constexpr int THREADS = R * M;
};

template <int W>
__global__ void __launch_bounds__(Layout<W>::THREADS) rowwise(
    const int32_t* __restrict__ time, const int32_t* __restrict__ actor,
    const int32_t* __restrict__ seq, const int32_t* __restrict__ clock_idx,
    const uint8_t* __restrict__ is_del, const int32_t* __restrict__ mem_idx,
    const int32_t* __restrict__ clock_table, Outputs o, int64_t T,
    int64_t A) {
  using L = Layout<W>;
  constexpr int M = L::M, R = L::R;
  __shared__ int32_t a_s[R][M], q_s[R][M], t_s[R][M], c_s[R][M];
  __shared__ int32_t src_s[R][M], slot_s[R][M];
  __shared__ uint8_t vd_s[R][M];      // bit 0 valid, bit 1 is_del
  __shared__ uint8_t alive_s[R][M];
  __shared__ int32_t p_s[R][M * M];   // P[u * M + v] = clock(u)[actor_v]
  __shared__ int32_t count_s[R], vb_s[R];

  const int r = threadIdx.x / M;
  const int x = threadIdx.x - r * M;  // the thread's member
  const int64_t row = static_cast<int64_t>(blockIdx.x) * R + r;
  const bool live = row < T;

  // 1. stage the row's members
  if (live) {
    const int64_t idx = x == 0 ? row : static_cast<int64_t>(
        __ldg(mem_idx + row * W + (x - 1)));
    const bool valid = x == 0 || idx >= 0;
    const int64_t c = idx < 0 ? 0 : (idx >= T ? T - 1 : idx);
    a_s[r][x] = __ldg(actor + c);
    q_s[r][x] = __ldg(seq + c);
    t_s[r][x] = __ldg(time + c);
    c_s[r][x] = __ldg(clock_idx + c);
    src_s[r][x] = static_cast<int32_t>(c);
    vd_s[r][x] = (valid ? 1 : 0) | (__ldg(is_del + c) ? 2 : 0);
    slot_s[r][x] = 0;
    if (x == 0) {
      count_s[r] = 0;
      vb_s[r] = 0;
    }
  }
  __syncthreads();

  // 2. the row's pairwise clock, one clock row per step
  if (live) {
    for (int e = x; e < M * M; e += M) {
      const int u = e / M, v = e - u * M;
      p_s[r][e] = __ldg(clock_table + static_cast<int64_t>(c_s[r][u]) * A +
                        a_s[r][v]);
    }
  }
  __syncthreads();

  // 3. supersession: is member x superseded (by any member / by slots
  //    1..W only)?
  if (live) {
    const uint8_t vd = vd_s[r][x];
    bool sup = false, sup_wo_self = false;
    if (vd & 1) {
      const int32_t qx = q_s[r][x], tx = t_s[r][x];
      auto supersedes = [&](int y) {
        // y is later than x and valid: y supersedes x unless concurrent
        return !(p_s[r][y * M + x] < qx && p_s[r][x * M + y] < q_s[r][y]);
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
  __syncthreads();

  // 4. output positions of the alive members
  if (live && alive_s[r][x]) {
    const int32_t ax = a_s[r][x], tx = t_s[r][x];
    int pos = 0;
    for (int y = 0; y < M; ++y) {
      const int32_t ay = a_s[r][y];
      pos += alive_s[r][y] && (ay > ax || (ay == ax && t_s[r][y] > tx));
    }
    atomicAdd(&slot_s[r][pos], src_s[r][x] + 1);
    atomicAdd(&count_s[r], 1);
  }
  __syncthreads();

  // 5. the row's outputs
  if (live) {
    for (int k = x; k < W; k += M)
      o.conflicts[row * W + k] = slot_s[r][k + 1] - 1;
    if (x == 0) write_row(o, row, slot_s[r][0] - 1, count_s[r], vb_s[r]);
  }
}

template <int W>
cudaError_t launch_rowwise(const void* const* in, const Outputs& o,
                           int64_t T, int64_t A, cudaStream_t stream) {
  using L = Layout<W>;
  const int64_t blocks = (T + L::R - 1) / L::R;
  rowwise<W><<<static_cast<unsigned>(blocks), L::THREADS, 0, stream>>>(
      static_cast<const int32_t*>(in[0]), static_cast<const int32_t*>(in[1]),
      static_cast<const int32_t*>(in[2]), static_cast<const int32_t*>(in[3]),
      static_cast<const uint8_t*>(in[4]), static_cast<const int32_t*>(in[5]),
      static_cast<const int32_t*>(in[6]), o, T, A);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// W >= 16: bit words over the block's span, per-row branch beside it
// ---------------------------------------------------------------------------

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanMax = 384;                    // span rows staged at most
constexpr int kSpanWords = kSpanMax / 32;
constexpr int kSpanStride = kSpanWords + 1;      // odd: conflict-free columns

constexpr size_t align16(size_t n) { return (n + 15) & ~size_t{15}; }

template <int W>
struct Plan {
  static constexpr int M = W + 1;
  static constexpr int R = W <= 64 ? 64 : 4096 / W;   // rows per block
  static constexpr int NW = (M + 31) / 32;            // words per slot mask
  static constexpr int NWP = NW | 1;                  // odd row stride
  // row-level arrays (both branches)
  static constexpr size_t kSlot = 0;                          // i32 [R][M]
  static constexpr size_t kMM = align16(kSlot + 4 * R * M);   // u32 [R][kSpanWords]
  static constexpr size_t kAM = align16(kMM + 4 * R * kSpanWords);
  static constexpr size_t kCnt = align16(kAM + 4 * R * kSpanWords);  // i32 [R]
  static constexpr size_t kVb = align16(kCnt + 4 * R);
  static constexpr size_t kDup = align16(kVb + 4 * R);
  static constexpr size_t kEnt = align16(kDup + 4 * R);       // i16 [R][M]
  static constexpr size_t kUnion = align16(kEnt + 2 * R * M);
  // span branch
  static constexpr size_t kSA = kUnion;                       // i32 [kSpanMax] x5
  static constexpr size_t kSQ = kSA + 4 * kSpanMax;
  static constexpr size_t kST = kSQ + 4 * kSpanMax;
  static constexpr size_t kSC = kST + 4 * kSpanMax;
  static constexpr size_t kSRank = kSC + 4 * kSpanMax;
  static constexpr size_t kKK = kSRank + 4 * kSpanMax;        // u32 [S][stride]
  static constexpr size_t kCM = kKK + 4 * kSpanMax * kSpanStride;
  static constexpr size_t kSD = kCM + 4 * kSpanMax * kSpanStride;
  static constexpr size_t kSpanEnd = align16(kSD + kSpanMax);
  // per-row branch
  static constexpr size_t kOA = kUnion;                       // i32 [M] x6
  static constexpr size_t kOQ = align16(kOA + 4 * M);
  static constexpr size_t kOT = align16(kOQ + 4 * M);
  static constexpr size_t kOC = align16(kOT + 4 * M);
  static constexpr size_t kOSrc = align16(kOC + 4 * M);
  static constexpr size_t kOSlot = align16(kOSrc + 4 * M);
  static constexpr size_t kOK = align16(kOSlot + 4 * M);      // u32 [M][NWP]
  static constexpr size_t kOAlive = align16(kOK + 4 * M * NWP);
  static constexpr size_t kOVd = align16(kOAlive + 4 * NW);   // u8 [M]
  static constexpr size_t kOScal = align16(kOVd + M);         // cnt, vb
  static constexpr size_t kOneEnd = align16(kOScal + 8);
  static constexpr size_t kBytes = kSpanEnd > kOneEnd ? kSpanEnd : kOneEnd;
};

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

struct Cols {
  const int32_t* time;
  const int32_t* actor;
  const int32_t* seq;
  const int32_t* clock_idx;
  const uint8_t* is_del;
  const int32_t* mem_idx;
  const int32_t* clock_table;
};

// Row `row` by itself, with the whole block: bit words over its W + 1
// slots (a slot may repeat a row; every slot counts).
template <int W>
__device__ void resolve_one(unsigned char* smem, const Cols& in,
                            const Outputs& o, int64_t row, int64_t T,
                            int64_t A) {
  using P = Plan<W>;
  constexpr int M = P::M, NW = P::NW, NWP = P::NWP;
  int32_t* oa = reinterpret_cast<int32_t*>(smem + P::kOA);
  int32_t* oq = reinterpret_cast<int32_t*>(smem + P::kOQ);
  int32_t* ot = reinterpret_cast<int32_t*>(smem + P::kOT);
  int32_t* oc = reinterpret_cast<int32_t*>(smem + P::kOC);
  int32_t* osrc = reinterpret_cast<int32_t*>(smem + P::kOSrc);
  int32_t* oslot = reinterpret_cast<int32_t*>(smem + P::kOSlot);
  uint32_t* ok = reinterpret_cast<uint32_t*>(smem + P::kOK);
  uint32_t* oalive = reinterpret_cast<uint32_t*>(smem + P::kOAlive);
  uint8_t* ovd = smem + P::kOVd;                // bit 0 valid, bit 1 is_del
  int32_t* oscal = reinterpret_cast<int32_t*>(smem + P::kOScal);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __syncthreads();      // the previous user of the union region is done
  for (int m = tid; m < M; m += kThreads) {
    const int64_t idx = m == 0 ? row : static_cast<int64_t>(
        __ldg(in.mem_idx + row * W + (m - 1)));
    const bool valid = m == 0 || idx >= 0;
    const int64_t c = idx < 0 ? 0 : (idx >= T ? T - 1 : idx);
    oa[m] = __ldg(in.actor + c);
    oq[m] = __ldg(in.seq + c);
    ot[m] = __ldg(in.time + c);
    oc[m] = __ldg(in.clock_idx + c);
    osrc[m] = static_cast<int32_t>(c);
    ovd[m] = (valid ? 1 : 0) | (__ldg(in.is_del + c) ? 2 : 0);
    oslot[m] = 0;
  }
  for (int w = tid; w < NW; w += kThreads) oalive[w] = 0;
  if (tid == 0) oscal[0] = oscal[1] = 0;
  __syncthreads();

  // knows[u] bit v over the slots
  for (int u = warp; u < M; u += kWarps) {
    const int32_t* crow = in.clock_table + static_cast<int64_t>(oc[u]) * A;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int v = (w << 5) + lane;
      const bool p = v < M && __ldg(crow + oa[v]) >= oq[v];
      const uint32_t word = __ballot_sync(0xffffffffu, p);
      if (lane == 0) ok[u * NWP + w] = word;
    }
  }
  __syncthreads();

  // supersession of slot x: by slots 1..W (a warp-wide any per word),
  // then by slot 0
  for (int x = warp; x < M; x += kWarps) {
    const uint8_t vdx = ovd[x];
    if (!(vdx & 1)) continue;
    const int32_t tx = ot[x];
    const uint32_t* kx = ok + x * NWP;
    bool sup_wo = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int y = (w << 5) + lane;
      bool p = false;
      if (y >= 1 && y < M && (ovd[y] & 1) && ot[y] > tx)
        p = ((kx[w] >> lane) & 1u) || bit_of(ok + y * NWP, x);
      sup_wo = sup_wo || __any_sync(0xffffffffu, p);
    }
    const bool sup = sup_wo ||
                     (ot[0] > tx && ((kx[0] & 1u) || bit_of(ok, x)));
    if (lane == 0) {
      const bool live = !(vdx & 2);
      if (live && !sup) {
        atomicOr(&oalive[x >> 5], 1u << (x & 31));
        atomicAdd(&oscal[0], 1);
      }
      if (x >= 1 && live && !sup_wo) oscal[1] = 1;
    }
  }
  __syncthreads();

  // positions of the alive slots
  for (int x = warp; x < M; x += kWarps) {
    if (!bit_of(oalive, x)) continue;
    const int32_t ax = oa[x], tx = ot[x];
    int pos = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int y = (w << 5) + lane;
      const bool p = y < M && ((oalive[w] >> lane) & 1u) &&
                     (oa[y] > ax || (oa[y] == ax && ot[y] > tx));
      pos += __popc(__ballot_sync(0xffffffffu, p));
    }
    if (lane == 0) atomicAdd(&oslot[pos], osrc[x] + 1);
  }
  __syncthreads();

  for (int k = tid; k < W; k += kThreads)
    o.conflicts[row * W + k] = oslot[k + 1] - 1;
  if (tid == 0) write_row(o, row, oslot[0] - 1, oscal[0], oscal[1] != 0);
}

template <int W>
__global__ void __launch_bounds__(kThreads) span_kernel(Cols in, Outputs o,
                                                        int64_t T,
                                                        int64_t A) {
  using P = Plan<W>;
  constexpr int M = P::M, R = P::R;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* slot = reinterpret_cast<int32_t*>(smem + P::kSlot);     // [R][M]
  uint32_t* mm = reinterpret_cast<uint32_t*>(smem + P::kMM);       // members
  uint32_t* am = reinterpret_cast<uint32_t*>(smem + P::kAM);       // alive
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + P::kCnt);
  int32_t* vb = reinterpret_cast<int32_t*>(smem + P::kVb);
  int32_t* dup = reinterpret_cast<int32_t*>(smem + P::kDup);
  int16_t* ent = reinterpret_cast<int16_t*>(smem + P::kEnt);       // [R][M]
  int32_t* sa = reinterpret_cast<int32_t*>(smem + P::kSA);
  int32_t* sq = reinterpret_cast<int32_t*>(smem + P::kSQ);
  int32_t* st = reinterpret_cast<int32_t*>(smem + P::kST);
  int32_t* sc = reinterpret_cast<int32_t*>(smem + P::kSC);
  int32_t* srank = reinterpret_cast<int32_t*>(smem + P::kSRank);
  uint32_t* kk = reinterpret_cast<uint32_t*>(smem + P::kKK);       // knows
  uint32_t* cm = reinterpret_cast<uint32_t*>(smem + P::kCM);       // C
  uint8_t* sd = smem + P::kSD;
  __shared__ int lo_s, hi_s, tie_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int nrows = static_cast<int>(T - row0 < R ? T - row0 : R);
  const int pairs = nrows * M;

  for (int i = tid; i < R * kSpanWords; i += kThreads) mm[i] = am[i] = 0;
  if (tid < R) cnt[tid] = vb[tid] = dup[tid] = 0;
  if (tid == 0) {
    lo_s = INT_MAX;
    hi_s = -1;
    tie_s = 0;
  }
  __syncthreads();

  // 1. the span: the block's rows and their valid members (clipped),
  //    kept in `slot` until the span's start is known
  int lo = INT_MAX, hi = -1;
#pragma unroll 4
  for (int i = tid; i < pairs; i += kThreads) {
    const int r = i / M, k = i - r * M;
    const int64_t row = row0 + r;
    const int64_t idx = k == 0 ? row : static_cast<int64_t>(
        __ldg(in.mem_idx + row * W + (k - 1)));
    int e = -1;
    if (idx >= 0) {
      e = static_cast<int>(idx >= T ? T - 1 : idx);
      lo = min(lo, e);
      hi = max(hi, e);
    }
    slot[i] = e;
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    atomicMin(&lo_s, lo);
    atomicMax(&hi_s, hi);
  }
  __syncthreads();
  lo = lo_s;
  hi = hi_s;
  const int S = hi - lo + 1;
  bool span = S <= kSpanMax;

  if (span) {
    const int nws = (S + 31) >> 5;
    // 2. the span's columns; each row's member mask (slots 1..W) and its
    //    repeated members
    for (int u = tid; u < S; u += kThreads) {
      const int64_t e = lo + u;
      sa[u] = __ldg(in.actor + e);
      sq[u] = __ldg(in.seq + e);
      st[u] = __ldg(in.time + e);
      sc[u] = __ldg(in.clock_idx + e);
      sd[u] = __ldg(in.is_del + e);
      srank[u] = 0;
    }
    for (int i = tid; i < pairs; i += kThreads) {
      const int r = i / M, k = i - r * M;
      const int s = slot[i] < 0 ? -1 : slot[i] - lo;
      slot[i] = 0;
      ent[i] = static_cast<int16_t>(s);
      if (k > 0 && s >= 0) {
        const uint32_t b = 1u << (s & 31);
        if (atomicOr(&mm[r * kSpanWords + (s >> 5)], b) & b) dup[r] = 1;
      }
    }
    for (int i = pairs + tid; i < R * M; i += kThreads) slot[i] = 0;
    __syncthreads();

    // 3. knows[u] bit v = clock(u)[actor_v] >= seq_v: a warp per span
    //    row u reads u's clock row through L1, lane l holding the actor
    //    and seq of rows l, 32 + l, ... in registers; every word's loads
    //    go out before the first ballot.
    {
      int32_t av[kSpanWords], qv[kSpanWords];
#pragma unroll
      for (int w = 0; w < kSpanWords; ++w) {
        const int v = (w << 5) + lane;
        const bool live = w < nws && v < S;
        av[w] = live ? sa[v] : 0;
        qv[w] = live ? sq[v] : INT_MAX;
      }
      // two span rows per warp step, so that two clock rows' loads are
      // in flight at once
      for (int u = warp; u < S; u += 2 * kWarps) {
        const int u2 = u + kWarps < S ? u + kWarps : u;
        const int32_t* crow =
            in.clock_table + static_cast<int64_t>(sc[u]) * A;
        const int32_t* crow2 =
            in.clock_table + static_cast<int64_t>(sc[u2]) * A;
        int32_t cv[kSpanWords], cv2[kSpanWords];
#pragma unroll
        for (int w = 0; w < kSpanWords; ++w) {
          const bool live = w < nws && (w << 5) + lane < S;
          cv[w] = live ? __ldg(crow + av[w]) : INT_MIN;
          cv2[w] = live ? __ldg(crow2 + av[w]) : INT_MIN;
        }
#pragma unroll
        for (int w = 0; w < kSpanWords; ++w) {
          if (w >= nws) break;
          const uint32_t kw = __ballot_sync(0xffffffffu, cv[w] >= qv[w]);
          const uint32_t kw2 = __ballot_sync(0xffffffffu, cv2[w] >= qv[w]);
          if (lane == 0) {
            kk[u * kSpanStride + w] = kw;
            kk[u2 * kSpanStride + w] = kw2;
          }
        }
      }
    }
    __syncthreads();

    // 4. C[u] bit v: v later than u and not concurrent with it, and u's
    //    rank in (actor desc, time desc) order, the count of rows before
    //    it: a word per thread (the 32 lanes of a warp take 32 consecutive
    //    rows u and one word, so each row v's columns and knows word are
    //    read once for the warp), the word's count added to u's rank.
    //    Two rows of equal (actor, time) would share a rank, so the block
    //    then takes the per-row branch.  A row that holds itself in its
    //    window repeats a member.
    {
      const int s32 = (S + 31) & ~31;
      for (int i = tid; i < nws * s32; i += kThreads) {
        const int w = i / s32, u = i - w * s32;
        if (u >= S) continue;
        const int32_t au = sa[u], tu = st[u];
        const uint32_t kuw = kk[u * kSpanStride + w];
        const uint32_t* ucol = kk + (u >> 5);
        const int ub = u & 31;
        const int n = min(32, S - (w << 5));
        uint32_t word = 0;
        int before = 0;
        bool tie = false;
#pragma unroll 8
        for (int l = 0; l < n; ++l) {
          const int v = (w << 5) + l;
          const int32_t a = sa[v], t = st[v];
          before += a > au || (a == au && t > tu);
          tie = tie || (a == au && t == tu && v != u);
          const uint32_t nc =
              ((kuw >> l) | (ucol[v * kSpanStride] >> ub)) & 1u;
          word |= (static_cast<uint32_t>(t > tu) & nc) << l;
        }
        cm[u * kSpanStride + w] = word;
        atomicAdd(&srank[u], before);
        if (tie) tie_s = 1;
      }
    }
    if (tid < nrows && bit_of(mm + tid * kSpanWords, ent[tid * M]))
      dup[tid] = 1;
    __syncthreads();
    span = !tie_s;
  }

  if (span) {
    const int nws = (S + 31) >> 5;
    // 5. supersession of each row's members, word by word; the alive
    //    members' bits go to their ranks
    for (int i = tid; i < pairs; i += kThreads) {
      const int r = i / M, k = i - r * M;
      const int s = ent[i];
      if (s < 0 || dup[r]) continue;
      const int s0 = ent[r * M];
      const uint32_t* mr = mm + r * kSpanWords;
      const uint32_t* cs = cm + s * kSpanStride;
      uint32_t sup = 0, sup_wo = 0;
#pragma unroll
      for (int w = 0; w < kSpanWords; ++w) {
        if (w >= nws) break;
        const uint32_t c = cs[w];
        const uint32_t self = (s0 >> 5) == w ? 1u << (s0 & 31) : 0u;
        sup_wo |= mr[w] & c;
        sup |= (mr[w] | self) & c;
      }
      if (sd[s]) continue;
      if (!sup) {
        const int q = srank[s];
        atomicOr(&am[r * kSpanWords + (q >> 5)], 1u << (q & 31));
        atomicAdd(&cnt[r], 1);
      }
      if (k >= 1 && !sup_wo) vb[r] = 1;
    }
    __syncthreads();

    // 6. positions: the alive members ranked before each alive member
    for (int i = tid; i < pairs; i += kThreads) {
      const int r = i / M;
      const int s = ent[i];
      if (s < 0 || dup[r]) continue;
      const uint32_t* ar = am + r * kSpanWords;
      const int q = srank[s];
      if (!bit_of(ar, q)) continue;
      int pos = __popc(ar[q >> 5] & ((1u << (q & 31)) - 1u));
      for (int w = 0; w < (q >> 5); ++w) pos += __popc(ar[w]);
      atomicAdd(&slot[r * M + pos], lo + s + 1);
    }
    __syncthreads();

    // 7. the outputs of the rows resolved here
    for (int i = tid; i < nrows * W; i += kThreads) {
      const int r = i / W, k = i - r * W;
      if (!dup[r]) o.conflicts[(row0 + r) * W + k] = slot[r * M + k + 1] - 1;
    }
    if (tid < nrows && !dup[tid])
      write_row(o, row0 + tid, slot[tid * M] - 1, cnt[tid], vb[tid] != 0);
  }

  // 8. the rows left: all of them when the span did not fit or had a tie,
  //    else those with a repeated member
  if (__syncthreads_or(!span || (tid < nrows && dup[tid])))
    for (int r = 0; r < nrows; ++r)
      if (!span || dup[r]) resolve_one<W>(smem, in, o, row0 + r, T, A);
}

template <int W>
cudaError_t launch_span(const void* const* in, const Outputs& o, int64_t T,
                        int64_t A, cudaStream_t stream) {
  using P = Plan<W>;
  cudaError_t err = cudaFuncSetAttribute(
      span_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::kBytes));
  if (err != cudaSuccess) return err;
  const Cols cols{static_cast<const int32_t*>(in[0]),
                  static_cast<const int32_t*>(in[1]),
                  static_cast<const int32_t*>(in[2]),
                  static_cast<const int32_t*>(in[3]),
                  static_cast<const uint8_t*>(in[4]),
                  static_cast<const int32_t*>(in[5]),
                  static_cast<const int32_t*>(in[6])};
  const int64_t blocks = (T + P::R - 1) / P::R;
  span_kernel<W><<<static_cast<unsigned>(blocks), kThreads, P::kBytes,
                   stream>>>(cols, o, T, A);
  return cudaGetLastError();
}

Outputs outputs_of(void* const* out) {
  return Outputs{static_cast<int32_t*>(out[0]), static_cast<int32_t*>(out[1]),
                 static_cast<int32_t*>(out[2]), static_cast<uint8_t*>(out[3]),
                 static_cast<uint8_t*>(out[4]), static_cast<int32_t*>(out[5])};
}

}  // namespace

// visible_before may be null (the caller did not ask for it).  T must be
// below 2^31 (the span is held in int32).
extern "C" int amtpu_torch_members(
    const void* time, const void* actor, const void* seq,
    const void* clock_idx, const void* is_del, const void* mem_idx,
    const void* clock_table, void* winner, void* conflicts,
    void* alive_after, void* visible_before, void* overflow, void* packed,
    int64_t T, int W, int64_t A, void* stream) {
  if (T <= 0) return 0;
  if (T > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[7] = {time, actor, seq, clock_idx, is_del, mem_idx,
                       clock_table};
  void* out[6] = {winner, conflicts, alive_after, visible_before, overflow,
                  packed};
  const Outputs o = outputs_of(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8: return launch_rowwise<8>(in, o, T, A, s);
    case 16: return launch_span<16>(in, o, T, A, s);
    case 32: return launch_span<32>(in, o, T, A, s);
    case 64: return launch_span<64>(in, o, T, A, s);
    case 128: return launch_span<128>(in, o, T, A, s);
    case 256: return launch_span<256>(in, o, T, A, s);
    case 512: return launch_span<512>(in, o, T, A, s);
    case 1024: return launch_span<1024>(in, o, T, A, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
