// What the triplet-attention forward and backward kernels
// (triplet_fused.cu, triplet_fused_bwd.cu) share: the work layout, the
// block's weights in shared memory, the edge loads, the long rows' tickets
// and the dispatch over widths.
//
// Layout.  One launch, two kinds of blocks of 8 warps:
//  - row blocks (the last blocks of the grid): warp w of row block b owns
//    receiver row 8 b + w whole if it has 1-32 edges, one edge a lane; a
//    molecule's rows (in-degree 1-4) are one short chain each: the row
//    pointers, then the edges' indices, then their features, a_j and the
//    senders' xp rows, all requested before the block's one barrier.  A
//    block whose 8 rows are all empty (a serving batch's 13,700 padding
//    nodes) sees it from two row pointers and writes their zeros with
//    coalesced stores, without the barrier or the weights;
//  - slot blocks (the first blocks): warp w of slot block b owns the 32
//    CSR slots from 32 (8 b + w) and takes the slots of its chunk that
//    belong to rows of more than 32 edges (at most two such rows a chunk);
//    so a hub row of in-degree 500 is spread over 16 warps.  Each warp
//    leaves the partial result of each long row in its chunk in global
//    scratch (part slot 0: the row started before the chunk, 1: it starts
//    in it), and the warp that takes the row's last ticket merges them in
//    CSR order, so the result does not depend on scheduling.  Tickets are
//    indexed by the chunk holding the row's first slot; they are zero on
//    entry and the merging warp puts its ticket back to zero, so the buffer
//    needs no fill between calls.  A slot block whose chunks hold no long
//    row leaves after the row search.
//
// Weights.  Each block stages We [Fe, H*C] and Wf = We @ wemat [Fe, H]
// (the logit's edge term is edge_attr[e] @ Wf) in shared memory: each warp
// forms its share of Wf's entries from We and wemat read in the same round
// trip, issued while the rows' first index loads are in flight, so the one
// barrier waits for no chain of its own.

#pragma once

#include "csr_common.cuh"

namespace triplet {

using namespace csr;

constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kMaxFe = 8;                // edge features (a protein's: 8)

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// a[h] of a register array indexed by a runtime head
template <int MAXH>
__device__ __forceinline__ float at_head(const float (&a)[MAXH], int h) {
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < MAXH; ++k) {
    if (k == h) r = a[k];
  }
  return r;
}

// componentwise products of channel groups
__device__ __forceinline__ float4 mul(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

// Stage We into we_s [fe, hc], Wf = We @ wemat into wf_s [fe, heads] and,
// if wm_s is not null, wemat into wm_s [hc, heads].  Every loop is
// unrolled over its most iterations (fe <= kMaxFe, hc <= kMaxHC), so that
// a thread's loads are in flight together: one round trip.  No barrier:
// the caller's __syncthreads() publishes them.

__device__ __forceinline__ void stage_weights(const float* we,
                                              const float* wemat, int hc,
                                              int heads, int fe, float* we_s,
                                              float* wf_s, float* wm_s) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < kMaxFe * kMaxHC / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < fe * hc) we_s[i] = __ldg(we + i);
  }
  if (wm_s != nullptr) {
#pragma unroll
    for (int k = 0; k < kMaxHC * kMaxHeads / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < hc * heads) wm_s[i] = __ldg(wemat + i);
    }
  }
  for (int i = warp; i < fe * heads; i += kWarps) {
    const int f = i / heads, h = i % heads;
    float w = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxHC / kWarp; ++k) {
      const int j = lane + k * kWarp;
      if (j < hc) {
        w = fmaf(__ldg(we + f * hc + j), __ldg(wemat + j * heads + h), w);
      }
    }
    w = warp_sum(w);
    if (lane == 0) wf_s[i] = w;
  }
}

// This lane's edge: its features into ea_s [32, fe] (the lane's row) and
// its sender's a_j into aj.
template <int MAXH>
__device__ __forceinline__ void load_edge(const float* edge_attr,
                                          const float* a_j, int s, int e,
                                          int heads, int fe, float* ea_row,
                                          float (&aj)[MAXH]) {
#pragma unroll 4
  for (int f = 0; f < fe; ++f) {
    ea_row[f] = __ldg(edge_attr + (size_t)e * fe + f);
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    aj[h] = h < heads ? __ldg(a_j + (size_t)s * heads + h) : 0.f;
  }
}

// This lane's raw logit terms a_i + edge_attr @ Wf + a_j, per head.
template <int MAXH>
__device__ __forceinline__ void raw_logits(const float* ea_row,
                                           const float* wf_s, int heads,
                                           int fe, const float (&ai)[MAXH],
                                           const float (&aj)[MAXH],
                                           float (&x)[MAXH]) {
#pragma unroll
  for (int h = 0; h < MAXH; ++h) x[h] = ai[h] + aj[h];
  for (int f = 0; f < fe; ++f) {
    const float ea = ea_row[f];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) x[h] = fmaf(ea, wf_s[f * heads + h], x[h]);
    }
  }
}

// Slot t's edge projection eh = edge_attr[e_t] @ We on this lane's groups.
template <int W, int VPL>
__device__ __forceinline__ void edge_proj(
    const float* ea_row, const float* we_s, int hc, int fe,
    const Groups<VPL>& gr, int lane, typename Vec<W>::T (&eh)[VPL]) {
  using T = typename Vec<W>::T;
#pragma unroll
  for (int v = 0; v < VPL; ++v) eh[v] = zero<T>();
  for (int f = 0; f < fe; ++f) {
    const float ea = ea_row[f];
    const T* w = reinterpret_cast<const T*>(we_s + f * hc);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (gr.ok[v]) eh[v] = fma4(1.f, eh[v], ea, w[lane + kWarp * v]);
    }
  }
}

// Rows of `src` ([rows, groups] of T) that slots t0 .. t0 + U - 1 (below
// t_end) gather, each slot's row index held by its lane in `my_row`.
template <int W, int VPL, int U>
__device__ __forceinline__ void gather_rows(
    const typename Vec<W>::T* src, int groups, int my_row, int t0, int t_end,
    const Groups<VPL>& gr, int lane, typename Vec<W>::T (&x)[U][VPL]) {
  using T = typename Vec<W>::T;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    const int r = __shfl_sync(kFull, my_row, t < kWarp ? t : 0);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      x[u][v] = t < t_end && gr.ok[v]
                    ? __ldg(src + (size_t)r * groups + lane + kWarp * v)
                    : zero<T>();
    }
  }
}

// Slots of rows of more than kChunk edges in the chunk [c0, c0 + cnt): at
// most two rows; `lng` marks this lane's slot if it is one of them.
struct LongRow {
  int row, beg, end;       // the row and its CSR slots
  int ta, tb;              // its lanes in this chunk
  unsigned mask;
};

// The first long row among the lanes set in `rest` (non-zero).
__device__ __forceinline__ LongRow next_long_row(const SlotRow& me,
                                                 unsigned rest) {
  const int t = __ffs(rest) - 1;
  LongRow lr;
  lr.row = __shfl_sync(kFull, me.row, t);
  lr.beg = __shfl_sync(kFull, me.beg, t);
  lr.end = __shfl_sync(kFull, me.end, t);
  lr.mask = __ballot_sync(kFull, (rest >> (threadIdx.x % kWarp) & 1) &&
                                     me.row == lr.row);
  lr.ta = t;
  lr.tb = kWarp - __clz(lr.mask);
  return lr;
}

// Part slot of this chunk's partial result of row lr (chunk k from c0).
__device__ __forceinline__ size_t part_slot(const LongRow& lr, int c0) {
  return (size_t)(c0 / kChunk) * 2 + (lr.beg < c0 ? 0 : 1);
}

// After this warp wrote its partial result of lr: take a ticket; true
// (warp-uniform) if it was the row's last, and then every part of the row
// is visible to this warp.
__device__ __forceinline__ bool last_ticket(int* tickets, const LongRow& lr,
                                            int lane) {
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    const int bf = lr.beg / kChunk;
    const int n = (lr.end - 1) / kChunk - bf + 1;
    last = atomicAdd(tickets + bf, 1) == n - 1;
  }
  last = __shfl_sync(kFull, last, 0);
  if (last) __threadfence();
  return last;
}

// Make<W, VPL, MAXH>::get() for these widths, or a null kernel.  W = 4 if
// the caller allows float4 groups (C % 4 == 0, aligned tensors), else 1;
// VPL: groups per lane; MAXH: 4 or kMaxHeads.
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
auto pick(int hc, int heads, int channels, int vec)
    -> decltype(Make<4, 1, 4>::get()) {
  if (heads < 1 || heads > kMaxHeads || channels < 1 ||
      hc != heads * channels || hc > kMaxHC) {
    return nullptr;
  }
  if (vec && channels % 4 == 0) {
    return heads <= 4 ? pick_vpl<Make, 4, 4>(hc / 4)
                      : pick_vpl<Make, 4, kMaxHeads>(hc / 4);
  }
  return heads <= 4 ? pick_vpl<Make, 1, 4>(hc)
                    : pick_vpl<Make, 1, kMaxHeads>(hc);
}

// Lanes of a chunk gather U slots' rows at a time: fewer with more groups
// a lane, to bound the registers (8 a lane were slower on a hub row).
template <int VPL>
struct Unroll {
  static constexpr int value = VPL <= 2 ? 4 : (VPL <= 4 ? 2 : 1);
};

}  // namespace triplet
