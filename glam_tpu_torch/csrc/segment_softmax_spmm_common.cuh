// What the forward and backward kernels of the segment softmax + SpMM
// (segment_softmax_spmm.cu, segment_softmax_spmm_bwd.cu) share: the chunk
// layout, the scratch convention of rows that span chunks, the per-lane
// channel helpers and the dispatch over widths.
//
// Work is cut into chunks of kChunk consecutive CSR slots, one warp each.
// A row that crosses a chunk's start or end leaves a partial state in one
// of the chunk's two scratch slots: slot 0 if it is the chunk's first row
// (it starts at or before the chunk), slot 1 if it is the chunk's last.
// part_slot() gives that index for both the pass that writes the states
// and the one that merges them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace segment_spmm {

constexpr int kWarp = 32;
constexpr int kChunk = kWarp;                   // CSR slots per warp
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMaxHeads = 8;
constexpr int kMaxValuesPerLane = 16;           // H*C <= 512
constexpr int kMaxHC = kWarp * kMaxValuesPerLane;
constexpr int kGroup = 4;                       // loads kept in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-16f;

// The scratch slot of the row starting at CSR slot `beg` in chunk c.
__device__ __forceinline__ size_t part_slot(int c, int beg) {
  return (size_t)c * 2 + (beg <= c * kChunk ? 0 : 1);
}

// The row holding CSR slot s: the largest r in [0, rows) with
// rowptr[r] <= s (empty rows before it share its start and lose).
__device__ __forceinline__ int row_of(const int* rowptr, int rows, int s) {
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(rowptr + mid) <= s) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The head of each channel this lane owns (-1 past the end of the row).
template <int VPL>
__device__ __forceinline__ void heads_of(int lane, int hc, int channels,
                                         int (&head_of)[VPL]) {
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + kWarp * v;
    head_of[v] = j < hc ? j / channels : -1;
  }
}

// Per channel, the entry of a per-head register array for its head (0
// past the end of the row).
template <int MAXH>
__device__ __forceinline__ float of_head(const float (&a)[MAXH], int h) {
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < MAXH; ++k) {
    if (k == h) r = a[k];
  }
  return r;
}

// Make<VPL, MAXH>::get() for the smallest VPL (channels per lane) that
// holds H*C = 32 * vpl, or a value-initialised (null) kernel set.
template <template <int, int> class Make, int MAXH>
auto pick_vpl(int vpl) -> decltype(Make<1, MAXH>::get()) {
  if (vpl <= 1) return Make<1, MAXH>::get();
  if (vpl <= 2) return Make<2, MAXH>::get();
  if (vpl <= 4) return Make<4, MAXH>::get();
  if (vpl <= 8) return Make<8, MAXH>::get();
  if (vpl <= kMaxValuesPerLane) return Make<kMaxValuesPerLane, MAXH>::get();
  return {};
}

// The instantiation for these widths (one head, or up to kMaxHeads), or
// a null kernel set if there is none.
template <template <int, int> class Make>
auto pick(int hc, int heads, int channels) -> decltype(Make<1, 1>::get()) {
  if (heads < 1 || heads > kMaxHeads || channels < 1 ||
      hc != heads * channels) {
    return {};
  }
  const int vpl = (hc + kWarp - 1) / kWarp;
  return heads == 1 ? pick_vpl<Make, 1>(vpl) : pick_vpl<Make, kMaxHeads>(vpl);
}

}  // namespace segment_spmm
