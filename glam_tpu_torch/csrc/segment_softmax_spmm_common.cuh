// What the forward and backward kernels of the segment softmax + SpMM
// (segment_softmax_spmm.cu, segment_softmax_spmm_bwd.cu) share: the work
// layout, the warp-wide row search, the asynchronous row gathers, the
// channel groups of a lane and the dispatch over widths.
//
// Layout.  A block of 1-8 warps owns 32 consecutive CSR slots per warp, a
// warp kChunk of them: as few warps as spread the blocks over the SMs,
// except in a forward whose rows average more than kChunk slots, which
// takes kWarps so that a long row leaves few block states to merge (the
// caller picks).  A row that crosses a chunk boundary inside the block is
// merged by the block through shared memory; a row that crosses a block
// boundary leaves one partial state per block in global scratch, in the block's
// part slot 0 (the row started before the block) or 1 (it starts in the
// block), and the block that takes the row's last ticket merges them in
// CSR order.  Tickets are indexed by the block holding the row's first
// slot; they are zero on entry and the merging block puts its ticket back
// to zero, so the buffer needs no fill between calls.  Empty rows hold no
// slot: the forward writes them from a partition of the rows over the
// blocks, so that a run of thousands of them (a serving batch's padding
// nodes, all starting at one slot) is spread over the grid.
//
// Channels.  A lane owns groups of kW consecutive channels: group
// lane + 32 * v.  With C % 4 == 0 a group is a float4 that lies inside one
// head, read from shared memory in one instruction; otherwise a group is
// one channel.  Either way each group has one head, and a lane keeps one
// softmax state per group, so no per-channel select over heads is needed.
//
// Gathers.  The rows that a chunk's slots gather (values[idx[s]], and in
// the backward g and out of their rows) are copied into a two-buffer ring
// of stage_rows slots per buffer and warp, all of a stage requested at
// once: rows of a multiple of 16 bytes at 16-byte-aligned addresses by
// cp.async.bulk (one bulk copy per row, issued by the lane that owns the
// slot, completing on the buffer's mbarrier), other rows by 4-byte
// cp.async.  The next stage's copies are in flight while the current one
// is reduced.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace segment_spmm {

constexpr int kWarp = 32;
constexpr int kChunk = kWarp;                     // CSR slots per warp
constexpr int kWarps = 8;                         // most warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kMaxHeads = 8;
constexpr int kMaxHC = 512;
constexpr int kRingBytes = 16384;                 // per warp, both buffers
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-16f;

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory read by the generic proxy is about to be overwritten by
// bulk copies (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy4_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------- row search
// The largest r in [lo, rows) with rowptr[r] <= s, found by the whole warp
// (s warp-uniform, rowptr[lo] <= s < rowptr[rows]): each round reads 32
// pivots at once and keeps the interval between two of them, so the
// depth is ceil(log32(rows - lo)) dependent loads: 3 at 32k rows.
__device__ __forceinline__ int warp_find_row(const int* rowptr, int rows,
                                             int s, int lo, int lane) {
  int hi = rows;
  while (hi - lo > 1) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int p = lo + lane * step;
    const bool le = p < hi && __ldg(rowptr + p) <= s;
    const int k = 31 - __clz(__ballot_sync(kFull, le));   // lane 0: p = lo
    lo += k * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// Row, start and end of the slot c0 + lane (for lane < cnt).  The warp
// finds the row of its first unresolved slot, reads the 33 row pointers
// from there, and each lane places its slot among them by a search over
// the window's registers (shuffles, no memory); slots past the window
// (more than 32 rows from the last search, e.g. behind a run of empty
// rows) take another round.  A chunk whose rows are all non-empty costs
// one search and one window.
struct SlotRow {
  int row, beg, end;
};

__device__ __forceinline__ SlotRow slot_rows(const int* rowptr, int rows,
                                             int c0, int cnt, int lane) {
  const int s = c0 + lane;
  SlotRow me{0, 0, 0};
  bool done = lane >= cnt;
  int rb = warp_find_row(rowptr, rows, c0, 0, lane);
  while (true) {
    const int w = rb + lane <= rows ? __ldg(rowptr + rb + lane) : INT_MAX;
    const int w32 = rb + kWarp <= rows ? __ldg(rowptr + rb + kWarp) : INT_MAX;
    int k = 0;                         // largest k <= 31 with w_k <= s
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, w, k + step) <= s) k += step;
    }
    const int beg = __shfl_sync(kFull, w, k);
    const int nxt = __shfl_sync(kFull, w, min(k + 1, kWarp - 1));
    if (!done && w32 > s) {
      me = {rb + k, beg, k == kWarp - 1 ? w32 : nxt};
      done = true;
    }
    const unsigned open = __ballot_sync(kFull, !done);
    if (open == 0) break;
    rb = warp_find_row(rowptr, rows, c0 + __ffs(open) - 1, rb + kWarp, lane);
  }
  return me;
}

// The block's warps and slots (one slot per thread).
__device__ __forceinline__ int block_warps() { return blockDim.x / kWarp; }

// The chunk's rows as segments of lanes: bit t of `starts` is set where
// slot t starts a row in the chunk (lane 0 always); `rank` is the lane's
// segment, `last` the segment's last lane.
struct Segs {
  unsigned starts;
  int rank, last;
};

__device__ __forceinline__ Segs chunk_segments(const SlotRow& me, int c0,
                                               int cnt, int lane) {
  const bool ok = lane < cnt;
  const unsigned starts =
      __ballot_sync(kFull, ok && (lane == 0 || me.beg == c0 + lane));
  const unsigned upto = lane == kWarp - 1 ? kFull : (2u << lane) - 1u;
  return {starts, __popc(starts & upto) - 1,
          ok ? min(me.end - c0, cnt) - 1 : lane};
}

// Each lane's segment total of v (MAX: the largest, else the sum), by a
// segmented scan over the lanes in a fixed order, then read from the
// segment's last lane.  Lanes past cnt are segments of their own.
template <bool MAX>
__device__ __forceinline__ float segment_total(float v, const Segs& sg,
                                               int lane, int cnt) {
  const int seg = lane < cnt ? sg.rank : kWarp + lane;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const float y = __shfl_up_sync(kFull, v, d);
    const int ys = __shfl_up_sync(kFull, seg, d);
    if (lane >= d && ys == seg) v = MAX ? fmaxf(v, y) : v + y;
  }
  return __shfl_sync(kFull, v, sg.last);
}

// ------------------------------------------------------- channel groups
template <int W>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ float4 operator*(float a, float4 b) {
  return make_float4(a * b.x, a * b.y, a * b.z, a * b.w);
}
__device__ __forceinline__ float4 fma4(float a, float4 x, float b, float4 y) {
  return make_float4(a * x.x + b * y.x, a * x.y + b * y.y, a * x.z + b * y.z,
                     a * x.w + b * y.w);
}
__device__ __forceinline__ float fma4(float a, float x, float b, float y) {
  return a * x + b * y;
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot4(float a, float b) { return a * b; }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}

// A lane's groups: group lane + 32 v (valid below `groups`) and its head.
template <int VPL>
struct Groups {
  int head[VPL];
  bool ok[VPL];
  bool first[VPL];         // the head's first group (writes its stats)
  __device__ __forceinline__ Groups(int lane, int groups, int per_head) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int gi = lane + kWarp * v;
      ok[v] = gi < groups;
      head[v] = ok[v] ? gi / per_head : 0;
      first[v] = ok[v] && gi % per_head == 0;
    }
  }
};

// --------------------------------------------------------- the ring
// How a stage's rows are copied: 4-byte cp.async by the whole warp (rows
// of any width), or one cp.async.bulk per row by the lane owning the slot
// (rows of a multiple of 16 bytes at 16-byte-aligned addresses),
// completing on the buffer's mbarrier.  Bulk copies measured faster than
// 16-byte cp.async at every width tried, 64 to 2,048 bytes.
enum CopyMode { kCopy4 = 0, kBulk = 1 };

// A warp's two buffers of P slots, per_row floats a slot (one or more
// rows of row_floats).  A stage's copies go: begin(i, rows), copy(...)
// for each kind of row, end(); wait(i) before reading stage i, release()
// after it.
struct Ring {
  float* buf;              // [2][P][per_row]
  uint64_t* bar;           // [2]
  int P, row_floats, per_row, mode;

  __device__ __forceinline__ float* slot_ptr(int i, int k) const {
    return buf + ((size_t)(i & 1) * P + k) * per_row;
  }

  // Arm stage i's barrier for `rows` rows (bulk copies only).
  __device__ __forceinline__ void begin(int i, int rows, int lane) const {
    if (mode == kBulk) {
      if (lane == 0) mbar_expect(bar + (i & 1), rows * row_floats * 4u);
      __syncwarp();
    }
  }

  // Copy row my_row of src (held by the lane of each slot) into slots
  // k < n of stage i whose bit is set in `mask`, at `off` floats into the
  // slot.  The stage's first slot is the chunk's slot t0.
  __device__ __forceinline__ void copy(int i, int t0, int n, int lane,
                                       unsigned mask, const float* src,
                                       int my_row, int off) const {
    if (mode == kBulk) {
      const int k = lane - t0;
      if (k >= 0 && k < n && (mask >> k & 1)) {
        bulk_copy(slot_ptr(i, k) + off, src + (size_t)my_row * row_floats,
                  row_floats * 4u, bar + (i & 1));
      }
      return;
    }
    const int total = n * row_floats;
    for (int base = 0; base < total; base += kWarp) {
      const int j = base + lane;
      const int k = min(j / row_floats, n - 1);
      const int r = __shfl_sync(kFull, my_row, t0 + k);
      if (j < total && (mask >> k & 1)) {
        const int c = j - k * row_floats;
        copy4(slot_ptr(i, k) + off + c, src + (size_t)r * row_floats + c);
      }
    }
  }

  __device__ __forceinline__ void end() const {
    if (mode != kBulk) copy4_commit();           // one group per stage
  }

  // Wait for stage i (stage i + 1 may be in flight).
  __device__ __forceinline__ void wait(int i) const {
    if (mode == kBulk) {
      mbar_wait(bar + (i & 1), (i >> 1) & 1);
    } else {
      copy4_wait<1>();
      __syncwarp();
    }
  }

  // Stage i has been read by every lane: its buffer may be refilled.
  __device__ __forceinline__ void release() const {
    __syncwarp();
    if (mode == kBulk) fence_proxy_async();
  }
};

// Rows per ring buffer: the largest power of two up to `most` whose two
// buffers of `floats_per_slot` floats per slot fit kRingBytes.
inline int stage_rows(int floats_per_slot, int most = 16) {
  int p = most;
  while (p > 1 && 2 * p * floats_per_slot * 4 > kRingBytes) p /= 2;
  return p;
}

// Make<W, VPL, MAXH>::get() for these widths, or a null kernel.  W = 4 if
// C % 4 == 0, else 1; VPL: groups per lane; MAXH: 1 or kMaxHeads.
template <template <int, int, int> class Make, int W, int MAXH>
auto pick_vpl(int groups) -> decltype(Make<W, 1, MAXH>::get()) {
  const int vpl = (groups + kWarp - 1) / kWarp;
  if (vpl <= 1) return Make<W, 1, MAXH>::get();
  if (vpl <= 2) return Make<W, 2, MAXH>::get();
  if (vpl <= 4) return Make<W, 4, MAXH>::get();
  if (W == 1 && vpl <= 8) return Make<W, (W == 1 ? 8 : 4), MAXH>::get();
  if (W == 1 && vpl <= 16) return Make<W, (W == 1 ? 16 : 4), MAXH>::get();
  return nullptr;
}

template <template <int, int, int> class Make>
auto pick(int hc, int heads, int channels) -> decltype(Make<4, 1, 1>::get()) {
  if (heads < 1 || heads > kMaxHeads || channels < 1 ||
      hc != heads * channels || hc > kMaxHC) {
    return nullptr;
  }
  if (channels % 4 == 0) {
    return heads == 1 ? pick_vpl<Make, 4, 1>(hc / 4)
                      : pick_vpl<Make, 4, kMaxHeads>(hc / 4);
  }
  return heads == 1 ? pick_vpl<Make, 1, 1>(hc)
                    : pick_vpl<Make, 1, kMaxHeads>(hc);
}

}  // namespace segment_spmm
