// Segment softmax + SpMM forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of the JAX package
// (glam_tpu/ops/pallas/segment_mxu.py:100-157, launched by
// `fused_segment_softmax_spmm`'s pallas_call at :208).  For every row r of
// a CSR over M entries, with per-head logits [M, H] and head-major values
// [M, H*C],
//
//   alpha_e = exp(x_e - max_r) / (sum_{e in r} exp(x_e - max_r) + 1e-16)
//   out[r]  = sum_{e in r} alpha_e (per head) * values[e]
//
// with PyG's semantics: an empty row gives 0.  The CSR is given as row
// pointers [R + 1] and the entry of each slot, idx [S]; an entry is listed
// at most once.
//
// Design.  The TPU kernel packs entries into 256-entry blocks whose
// receivers span at most 128 rows and turns gathers and scatters into
// one-hot matmuls, because Mosaic has no gather.  Here the kernel walks
// the CSR directly.  Rows are as short as 2 entries (a molecule's atom) and
// as long as ~14,000 (the padding graph of a serving batch, in a readout),
// so work is cut by slots, not by rows: one warp owns a chunk of 32
// consecutive CSR slots, whatever rows they belong to.
//   1. chunk pass: lanes first take one slot each (its row by a binary
//      search of the row pointers, its entry and logits); then the warp
//      walks the chunk's slots in order, lanes striding over the H*C
//      channels, keeping an online softmax (max, sum, accumulator) of the
//      current row, with the value loads of 4 slots in flight at a time.
//      A row that lies inside the chunk is finished and written here.  A
//      row that crosses the chunk's start or end leaves its partial state
//      in a scratch slot of the chunk (slot 0 for the chunk's first row,
//      slot 1 for its last).
//      The chunk holding a spanning row's first entry appends the row to
//      one of two work lists: rows of at most 16 chunks, and longer ones.
//   2. merge pass: a short row is merged by one warp, lanes over the
//      channels, 4 chunk states' loads in flight; a long row by a whole
//      block, its 16 warps splitting the chunks (the serving batch's
//      longest row, 44,096 padded edges, has 1,378 chunks: 87 per warp),
//      then combining through shared memory.
// Each output element is written by one warp, in an order fixed by the
// CSR, so the result does not depend on scheduling; the only atomics are
// the work lists' counters, whose order decides who merges a row, not
// how.
//
// Bound.  A few flops per byte: memory traffic bounds it, each entry's
// logits and values read once and the [R, H*C] output written once.  What
// it waits on is the latency of each chunk's dependent loads; chunks of 32
// slots give thousands of warps at the serving shapes to cover it.
//
// Interface: plain C, loaded with ctypes.  The launch returns
// cudaGetLastError() after each kernel; the caller raises if it is not 0.

#include "segment_softmax_spmm_common.cuh"

namespace {

using namespace segment_spmm;

constexpr int kMergeWarps = 16;
constexpr int kMergeThreads = kWarp * kMergeWarps;
constexpr int kShortChunks = 16;                // longer rows: a block each

struct Params {
  const float* logits;   // [M, heads]
  const float* values;   // [M, hc]
  const int* rowptr;     // [rows + 1]
  const int* idx;        // [slots]
  float* out;            // [rows, hc], zeroed by the caller
  float* part_m;         // [chunks, 2, heads]
  float* part_l;         // [chunks, 2, heads]
  float* part_acc;       // [chunks, 2, hc]
  int* counts;           // [2]: short and long rows listed, zeroed
  int* short_rows;       // [chunks]
  int* long_rows;        // [chunks]
  int rows, slots, hc, heads, channels;
};

// Merge the softmax state (mc, lc, ac) into (m, l, acc): a state of no
// entries (mc = -inf) leaves it unchanged.
template <int VPL, int MAXH>
__device__ __forceinline__ void merge_state(
    float (&m)[MAXH], float (&l)[MAXH], float (&acc)[VPL],
    const float (&mc)[MAXH], const float (&lc)[MAXH], const float (&ac)[VPL],
    const int (&head_of)[VPL], int heads) {
  float sa[MAXH], sb[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    sa[h] = 1.f;
    sb[h] = 0.f;
    if (h < heads && mc[h] > -INFINITY) {
      const float mn = fmaxf(m[h], mc[h]);
      sa[h] = expf(m[h] - mn);
      sb[h] = expf(mc[h] - mn);
      l[h] = l[h] * sa[h] + lc[h] * sb[h];
      m[h] = mn;
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    acc[v] = acc[v] * of_head<MAXH>(sa, head_of[v]) +
             ac[v] * of_head<MAXH>(sb, head_of[v]);
  }
}

// Write the state of row r: the output if the row lies inside the chunk
// [c0, c1), else a partial state into the chunk's scratch slot.
template <int VPL, int MAXH>
__device__ __forceinline__ void flush(
    const Params& q, int chunk, int c0, int c1, int lane, int r, int beg,
    int end, const float (&m)[MAXH], const float (&l)[MAXH],
    const float (&acc)[VPL], const int (&head_of)[VPL]) {
  const int hc = q.hc, heads = q.heads;
  if (beg >= c0 && end <= c1) {
    float inv[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) inv[h] = 1.f / (l[h] + kEps);
    float* o = q.out + (size_t)r * hc;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = lane + kWarp * v;
      if (j < hc) o[j] = acc[v] * of_head<MAXH>(inv, head_of[v]);
    }
    return;
  }
  const size_t base = part_slot(chunk, beg);
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < heads && lane == h) {
      q.part_m[base * heads + h] = m[h];
      q.part_l[base * heads + h] = l[h];
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + kWarp * v;
    if (j < hc) q.part_acc[base * hc + j] = acc[v];
  }
  // the row's first entry is in this chunk: list the row for merging
  if (beg >= c0 && lane == 0) {
    const bool is_long = (end - 1) / kChunk - beg / kChunk >= kShortChunks;
    int* list = is_long ? q.long_rows : q.short_rows;
    list[atomicAdd(q.counts + (is_long ? 1 : 0), 1)] = r;
  }
}

// VPL: channels per lane (H*C <= 32*VPL); MAXH: most heads.
template <int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const Params q) {
  const int lane = threadIdx.x % kWarp;
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int c0 = chunk * kChunk;
  if (c0 >= q.slots) return;                     // warp-uniform
  const int cnt = min(kChunk, q.slots - c0);
  const int c1 = c0 + cnt;
  const int hc = q.hc, heads = q.heads;

  // one slot per lane: its row, the row's bounds, its entry and logits
  int my_row = 0, my_beg = 0, my_end = 0, my_e = 0;
  float my_x[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) my_x[h] = 0.f;
  if (lane < cnt) {
    const int s = c0 + lane;
    my_row = row_of(q.rowptr, q.rows, s);
    my_beg = __ldg(q.rowptr + my_row);
    my_end = __ldg(q.rowptr + my_row + 1);
    my_e = __ldg(q.idx + s);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) my_x[h] = __ldg(q.logits + (size_t)my_e * heads + h);
    }
  }
  int head_of[VPL];
  heads_of<VPL>(lane, hc, q.channels, head_of);

  float m[MAXH], l[MAXH], acc[VPL];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
  int cur = -1, cur_beg = 0, cur_end = 0;

  for (int t0 = 0; t0 < cnt; t0 += kGroup) {
    float val[kGroup][VPL];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t0 + u;
      const int e = __shfl_sync(kFull, my_e, t);
      const float* src = q.values + (size_t)e * hc;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int j = lane + kWarp * v;
        val[u][v] = (t < cnt && j < hc) ? __ldg(src + j) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t0 + u;
      const int row = __shfl_sync(kFull, my_row, t);
      const int beg = __shfl_sync(kFull, my_beg, t);
      const int end = __shfl_sync(kFull, my_end, t);
      float x[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) x[h] = __shfl_sync(kFull, my_x[h], t);
      if (t >= cnt) break;                       // warp-uniform
      if (row != cur) {
        if (cur >= 0) {
          flush<VPL, MAXH>(q, chunk, c0, c1, lane, cur, cur_beg, cur_end, m,
                           l, acc, head_of);
        }
        cur = row;
        cur_beg = beg;
        cur_end = end;
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          m[h] = -INFINITY;
          l[h] = 0.f;
        }
#pragma unroll
        for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
      }
      float sc[MAXH], p[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        sc[h] = 1.f;
        p[h] = 0.f;
        if (h < heads) {
          const float mn = fmaxf(m[h], x[h]);
          sc[h] = expf(m[h] - mn);
          p[h] = expf(x[h] - mn);
          l[h] = l[h] * sc[h] + p[h];
          m[h] = mn;
        }
      }
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        acc[v] = acc[v] * of_head<MAXH>(sc, head_of[v]) +
                 of_head<MAXH>(p, head_of[v]) * val[u][v];
      }
    }
  }
  if (cur >= 0) {
    flush<VPL, MAXH>(q, chunk, c0, c1, lane, cur, cur_beg, cur_end, m, l,
                     acc, head_of);
  }
}

// Merge the states of the row starting at slot `beg` from its chunks
// c = first, first + stride, ... <= cl into (m, l, acc), kGroup chunks'
// loads in flight.
template <int VPL, int MAXH>
__device__ __forceinline__ void merge_chunks(
    const Params& q, int lane, int beg, int cl, int first, int stride,
    float (&m)[MAXH], float (&l)[MAXH], float (&acc)[VPL],
    const int (&head_of)[VPL]) {
  const int hc = q.hc, heads = q.heads;
  for (int c0 = first; c0 <= cl; c0 += stride * kGroup) {
    float mc[kGroup][MAXH], lc[kGroup][MAXH], ac[kGroup][VPL];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int c = c0 + u * stride;
      const size_t base = part_slot(c, beg);
      const bool ok = c <= cl;
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        const bool hok = ok && h < heads;
        mc[u][h] = hok ? q.part_m[base * heads + h] : -INFINITY;
        lc[u][h] = hok ? q.part_l[base * heads + h] : 0.f;
      }
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int j = lane + kWarp * v;
        ac[u][v] = (ok && j < hc) ? q.part_acc[base * hc + j] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      merge_state<VPL, MAXH>(m, l, acc, mc[u], lc[u], ac[u], head_of, heads);
    }
  }
}

template <int VPL, int MAXH>
__device__ __forceinline__ void reset_state(float (&m)[MAXH],
                                            float (&l)[MAXH],
                                            float (&acc)[VPL]) {
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
}

template <int VPL, int MAXH>
__device__ __forceinline__ void write_row(const Params& q, int lane, int r,
                                          const float (&l)[MAXH],
                                          const float (&acc)[VPL],
                                          const int (&head_of)[VPL]) {
  float inv[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) inv[h] = 1.f / (l[h] + kEps);
  float* o = q.out + (size_t)r * q.hc;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + kWarp * v;
    if (j < q.hc) o[j] = acc[v] * of_head<MAXH>(inv, head_of[v]);
  }
}

// Long rows first, one block each (grid-stride over their list; every
// thread reads the same entry, so the block reaches its barriers
// together); then short rows, one warp each.
template <int VPL, int MAXH>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const Params q) {
  __shared__ float sm_m[kMergeWarps][kMaxHeads];
  __shared__ float sm_l[kMergeWarps][kMaxHeads];
  __shared__ float sm_acc[kMergeWarps][kMaxHC];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int hc = q.hc;
  int head_of[VPL];
  heads_of<VPL>(lane, hc, q.channels, head_of);
  float m[MAXH], l[MAXH], acc[VPL];

  for (int i = blockIdx.x; i < q.counts[1]; i += gridDim.x) {
    const int r = q.long_rows[i];
    const int beg = q.rowptr[r], end = q.rowptr[r + 1];
    const int cf = beg / kChunk, cl = (end - 1) / kChunk;
    reset_state<VPL, MAXH>(m, l, acc);
    merge_chunks<VPL, MAXH>(q, lane, beg, cl, cf + warp, kMergeWarps, m, l,
                            acc, head_of);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (lane == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
    }
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = lane + kWarp * v;
      if (j < hc) sm_acc[warp][j] = acc[v];
    }
    __syncthreads();
    if (warp == 0) {
      reset_state<VPL, MAXH>(m, l, acc);
      for (int w = 0; w < kMergeWarps; ++w) {
        float mc[MAXH], lc[MAXH], ac[VPL];
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          mc[h] = sm_m[w][h];
          lc[h] = sm_l[w][h];
        }
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int j = lane + kWarp * v;
          ac[v] = j < hc ? sm_acc[w][j] : 0.f;
        }
        merge_state<VPL, MAXH>(m, l, acc, mc, lc, ac, head_of, q.heads);
      }
      write_row<VPL, MAXH>(q, lane, r, l, acc, head_of);
    }
    __syncthreads();
  }

  for (int i = blockIdx.x * kMergeWarps + warp; i < q.counts[0];
       i += gridDim.x * kMergeWarps) {
    const int r = q.short_rows[i];
    const int beg = q.rowptr[r], end = q.rowptr[r + 1];
    const int cf = beg / kChunk, cl = (end - 1) / kChunk;
    reset_state<VPL, MAXH>(m, l, acc);
    merge_chunks<VPL, MAXH>(q, lane, beg, cl, cf, 1, m, l, acc, head_of);
    write_row<VPL, MAXH>(q, lane, r, l, acc, head_of);
  }
}

struct Kernels {
  void (*chunk)(const Params);
  void (*merge)(const Params);
};

template <int VPL, int MAXH>
struct Make {
  static Kernels get() {
    return {chunk_kernel<VPL, MAXH>, merge_kernel<VPL, MAXH>};
  }
};

}  // namespace

extern "C" {

int segment_spmm_fwd_max_hc() { return kMaxHC; }
int segment_spmm_fwd_max_heads() { return kMaxHeads; }
int segment_spmm_fwd_chunk() { return kChunk; }

// Pointers are device pointers; `stream` is a cudaStream_t.  `out` must be
// zeroed (empty rows keep it); with chunks = ceil(slots / chunk), part_m
// and part_l hold [chunks, 2, heads] floats, part_acc [chunks, 2, hc],
// counts 2 zeroed ints and lists [2, chunks] ints.  slots >= 1 and
// rowptr[rows] == slots; merge_blocks >= 1 is the merge pass's grid.
int segment_spmm_fwd(const float* logits, const float* values,
                     const int* rowptr, const int* idx, float* out,
                     float* part_m, float* part_l, float* part_acc,
                     int* counts, int* lists, int rows, int slots, int hc,
                     int heads, int channels, int merge_blocks,
                     void* stream) {
  const Kernels k = pick<Make>(hc, heads, channels);
  if (k.chunk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (slots + kChunk - 1) / kChunk;
  const Params q{logits, values, rowptr, idx,   out,   part_m,
                 part_l, part_acc, counts, lists, lists + chunks,
                 rows,   slots,  hc,     heads, channels};
  const int blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  k.chunk<<<blocks, kThreads, 0, s>>>(q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k.merge<<<merge_blocks, kMergeThreads, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
