// What the forward and backward kernels of the segment softmax + SpMM
// (segment_softmax_spmm.cu, segment_softmax_spmm_bwd.cu) share beyond
// csr_common.cuh (the warp-wide row search and the channel groups of a
// lane): the work layout, the asynchronous row gathers and the dispatch
// over widths.
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
// Gathers.  The rows that a chunk's slots gather (values[idx[s]], and in
// the backward g and out of their rows) are copied into a two-buffer ring
// of stage_rows slots per buffer and warp, all of a stage requested at
// once: rows of a multiple of 16 bytes at 16-byte-aligned addresses by
// cp.async.bulk (one bulk copy per row, issued by the lane that owns the
// slot, completing on the buffer's mbarrier), other rows by 4-byte
// cp.async.  The next stage's copies are in flight while the current one
// is reduced.

#pragma once

#include "csr_common.cuh"

namespace segment_spmm {

using namespace csr;

constexpr int kWarps = 8;                         // most warps per block
constexpr int kThreads = kWarp * kWarps;
constexpr int kRingBytes = 16384;                 // per warp, both buffers

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
