// What the CSR kernels of the port share: the segment softmax + SpMM
// (segment_softmax_spmm*.cu) and the triplet attention (triplet_fused*.cu).
// A warp owns a chunk of 32 consecutive CSR slots, one slot a lane, and
// finds the rows of its slots by a warp-wide search; the slots of one row
// form a segment of lanes.  Lanes also own groups of channels (below).
//
// Channels.  A lane owns groups of kW consecutive channels: group
// lane + 32 * v.  With C % 4 == 0 a group is a float4 that lies inside one
// head, read in one instruction; otherwise a group is one channel.  Either
// way each group has one head, so no per-channel select over heads is
// needed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace csr {

constexpr int kWarp = 32;
constexpr int kChunk = kWarp;                     // CSR slots per warp
constexpr int kMaxHeads = 8;
constexpr int kMaxHC = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-16f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
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

}  // namespace csr
