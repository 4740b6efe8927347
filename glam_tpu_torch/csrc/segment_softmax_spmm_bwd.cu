// Segment softmax + SpMM backward for Hopper (sm_90a).
//
// The TPU kernel (glam_tpu/ops/pallas/segment_mxu.py:100, forward only)
// has no backward; the JAX package differentiates the same function by
// XLA autodiff of `segment_softmax` (glam_tpu/ops/segment.py:50) and
// `segment_sum` (:21).  This is that gradient as a kernel.  With the
// forward of segment_softmax_spmm.cu
//
//   alpha_e = softmax over row r of the logits x_e (per head)
//   out[r]  = sum_{e in r} alpha_e * values[e]
//
// and the output's cotangent g [R, H*C], it computes for every entry e of
// row r
//
//   d_values[e] = alpha_e (per head) * g[r]
//   dalpha_e    = <g[r]_h, values[e]_h>                  (per head h)
//   d_logits[e] = alpha_e * (dalpha_e - sum_{e' in r} alpha_e' dalpha_e')
//
// Each entry belongs to one row, so every output element is written once:
// no atomics, and the result does not depend on scheduling.  Entries that
// no slot lists keep the caller's zeros.
//
// Design.  As the forward, work is cut into chunks of 32 consecutive CSR
// slots, one warp each, so that a row of ~14,000 entries (a readout's
// padding graph) is spread over hundreds of warps.  Three passes:
//   1. stats: the warp walks its chunk's slots, lanes over channels,
//      computes dalpha (a warp sum per head) and keeps per row an online
//      (max, sum of exp, sum of exp * dalpha).  It writes each slot's
//      dalpha and row to scratch, and a row inside the chunk's final
//      statistics (max, 1 / (sum + 1e-16), D = sum alpha dalpha); a row
//      that crosses the chunk's start or end leaves a partial state in
//      the chunk's scratch slot 0 (its first row) or 1 (its last).
//   2. merge: one warp per row that spans chunks; lanes merge the row's
//      chunk states, then a butterfly of shuffles merges the lanes'.
//   3. entries: one warp per chunk again; lanes first take a slot each
//      and write d_logits, then walk the slots writing d_values rows.
//
// Bound.  Memory traffic: the entries' logits and values and the rows of
// g read once, d_logits and d_values written once.  The passes read the
// values once (pass 1) and g twice (passes 1 and 3; a row of g is read by
// each of its entries, from L1 or L2 after the first).
//
// Interface: plain C, loaded with ctypes.  The launch returns
// cudaGetLastError() after each kernel; the caller raises if it is not 0.

#include "segment_softmax_spmm_common.cuh"

namespace {

using namespace segment_spmm;

struct Params {
  const float* logits;   // [M, heads]
  const float* values;   // [M, hc]
  const int* rowptr;     // [rows + 1]
  const int* idx;        // [slots]
  const float* g;        // [rows, hc]
  float* d_logits;       // [M, heads]
  float* d_values;       // [M, hc]
  float* dal;            // [slots, heads] scratch: dalpha of each slot
  int* slot_row;         // [slots] scratch: row of each slot
  float* row_m;          // [rows, heads] softmax max of each row
  float* row_inv;        // [rows, heads] 1 / (sum of exp + 1e-16)
  float* row_d;          // [rows, heads] sum of alpha * dalpha
  float* part_m;         // [chunks, 2, heads]
  float* part_l;         // [chunks, 2, heads]
  float* part_s;         // [chunks, 2, heads]
  int rows, slots, hc, heads, channels;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// Merge one head's state (mc, lc, sc) into (m, l, s); a state of no
// entries (mc = -inf) leaves it unchanged.
__device__ __forceinline__ void merge_stats(float& m, float& l, float& s,
                                            float mc, float lc, float sc) {
  if (!(mc > -INFINITY)) return;
  const float mn = fmaxf(m, mc);
  const float a = expf(m - mn), b = expf(mc - mn);
  l = l * a + lc * b;
  s = s * a + sc * b;
  m = mn;
}

// Final statistics of row r (inside its chunk), or its partial state.
template <int MAXH>
__device__ __forceinline__ void flush_stats(
    const Params& q, int chunk, int c0, int c1, int lane, int r, int beg,
    int end, const float (&m)[MAXH], const float (&l)[MAXH],
    const float (&s)[MAXH]) {
  const int heads = q.heads;
  const bool inside = beg >= c0 && end <= c1;
  const size_t base = part_slot(chunk, beg);
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < heads && lane == h) {
      if (inside) {
        const float inv = 1.f / (l[h] + kEps);
        q.row_m[(size_t)r * heads + h] = m[h];
        q.row_inv[(size_t)r * heads + h] = inv;
        q.row_d[(size_t)r * heads + h] = s[h] * inv;
      } else {
        q.part_m[base * heads + h] = m[h];
        q.part_l[base * heads + h] = l[h];
        q.part_s[base * heads + h] = s[h];
      }
    }
  }
}

// Pass 1.  VPL: channels per lane (H*C <= 32*VPL); MAXH: most heads.
template <int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const Params q) {
  const int lane = threadIdx.x % kWarp;
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int c0 = chunk * kChunk;
  if (c0 >= q.slots) return;                     // warp-uniform
  const int cnt = min(kChunk, q.slots - c0);
  const int c1 = c0 + cnt;
  const int hc = q.hc, heads = q.heads;

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
    q.slot_row[s] = my_row;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) my_x[h] = __ldg(q.logits + (size_t)my_e * heads + h);
    }
  }
  int head_of[VPL];
  heads_of<VPL>(lane, hc, q.channels, head_of);

  float m[MAXH], l[MAXH], sm[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
    sm[h] = 0.f;
  }
  int cur = -1, cur_beg = 0, cur_end = 0;

  for (int t0 = 0; t0 < cnt; t0 += kGroup) {
    float val[kGroup][VPL], gv[kGroup][VPL];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t0 + u;
      const int e = __shfl_sync(kFull, my_e, t);
      const int r = __shfl_sync(kFull, my_row, t);
      const float* src = q.values + (size_t)e * hc;
      const float* gr = q.g + (size_t)r * hc;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int j = lane + kWarp * v;
        const bool ok = t < cnt && j < hc;
        val[u][v] = ok ? __ldg(src + j) : 0.f;
        gv[u][v] = ok ? __ldg(gr + j) : 0.f;
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
          flush_stats<MAXH>(q, chunk, c0, c1, lane, cur, cur_beg, cur_end,
                            m, l, sm);
        }
        cur = row;
        cur_beg = beg;
        cur_end = end;
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          m[h] = -INFINITY;
          l[h] = 0.f;
          sm[h] = 0.f;
        }
      }
      // dalpha per head: this lane's channels, then a warp sum
      float d[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) d[h] = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const float prod = val[u][v] * gv[u][v];
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          if (h == head_of[v]) d[h] += prod;
        }
      }
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h < heads) {
          d[h] = warp_sum(d[h]);
          if (lane == h) q.dal[(size_t)(c0 + t) * heads + h] = d[h];
          const float mn = fmaxf(m[h], x[h]);
          const float sc = expf(m[h] - mn), p = expf(x[h] - mn);
          l[h] = l[h] * sc + p;
          sm[h] = sm[h] * sc + p * d[h];
          m[h] = mn;
        }
      }
    }
  }
  if (cur >= 0) {
    flush_stats<MAXH>(q, chunk, c0, c1, lane, cur, cur_beg, cur_end, m, l,
                      sm);
  }
}

// Pass 2: one warp per row that spans chunks (grid-stride over rows).
__global__ void __launch_bounds__(kThreads)
merge_stats_kernel(const Params q) {
  const int lane = threadIdx.x % kWarp;
  const int warps = gridDim.x * kWarpsPerBlock;
  const int heads = q.heads;
  for (int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
       r < q.rows; r += warps) {
    const int beg = __ldg(q.rowptr + r);
    const int end = __ldg(q.rowptr + r + 1);
    if (beg == end) continue;
    const int cf = beg / kChunk, cl = (end - 1) / kChunk;
    if (cf == cl) continue;                      // written by pass 1
    for (int h = 0; h < heads; ++h) {
      float m = -INFINITY, l = 0.f, s = 0.f;
      for (int c = cf + lane; c <= cl; c += kWarp) {
        const size_t base = part_slot(c, beg);
        merge_stats(m, l, s, q.part_m[base * heads + h],
                    q.part_l[base * heads + h], q.part_s[base * heads + h]);
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float mo = __shfl_xor_sync(kFull, m, off);
        const float lo = __shfl_xor_sync(kFull, l, off);
        const float so = __shfl_xor_sync(kFull, s, off);
        merge_stats(m, l, s, mo, lo, so);
      }
      if (lane == 0) {
        const float inv = 1.f / (l + kEps);
        q.row_m[(size_t)r * heads + h] = m;
        q.row_inv[(size_t)r * heads + h] = inv;
        q.row_d[(size_t)r * heads + h] = s * inv;
      }
    }
  }
}

// Pass 3: d_logits (one slot per lane), then d_values (lanes over
// channels, the chunk's slots in order).
template <int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads)
entries_kernel(const Params q) {
  const int lane = threadIdx.x % kWarp;
  const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int c0 = chunk * kChunk;
  if (c0 >= q.slots) return;                     // warp-uniform
  const int cnt = min(kChunk, q.slots - c0);
  const int hc = q.hc, heads = q.heads;

  int my_row = 0, my_e = 0;
  float my_a[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) my_a[h] = 0.f;
  if (lane < cnt) {
    const int s = c0 + lane;
    my_row = q.slot_row[s];
    my_e = __ldg(q.idx + s);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) {
        const size_t rh = (size_t)my_row * heads + h;
        const float x = __ldg(q.logits + (size_t)my_e * heads + h);
        my_a[h] = expf(x - q.row_m[rh]) * q.row_inv[rh];
        q.d_logits[(size_t)my_e * heads + h] =
            my_a[h] * (q.dal[(size_t)s * heads + h] - q.row_d[rh]);
      }
    }
  }
  int head_of[VPL];
  heads_of<VPL>(lane, hc, q.channels, head_of);

  for (int t0 = 0; t0 < cnt; t0 += kGroup) {
    float gv[kGroup][VPL];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t0 + u;
      const int r = __shfl_sync(kFull, my_row, t);
      const float* gr = q.g + (size_t)r * hc;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int j = lane + kWarp * v;
        gv[u][v] = (t < cnt && j < hc) ? __ldg(gr + j) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = t0 + u;
      const int e = __shfl_sync(kFull, my_e, t);
      float a[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) a[h] = __shfl_sync(kFull, my_a[h], t);
      if (t >= cnt) break;                       // warp-uniform
      float* dv = q.d_values + (size_t)e * hc;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int j = lane + kWarp * v;
        if (j < hc) dv[j] = of_head<MAXH>(a, head_of[v]) * gv[u][v];
      }
    }
  }
}

struct Kernels {
  void (*stats)(const Params);
  void (*entries)(const Params);
};

template <int VPL, int MAXH>
struct Make {
  static Kernels get() {
    return {stats_kernel<VPL, MAXH>, entries_kernel<VPL, MAXH>};
  }
};

}  // namespace

extern "C" {

int segment_spmm_bwd_max_hc() { return kMaxHC; }
int segment_spmm_bwd_max_heads() { return kMaxHeads; }
int segment_spmm_bwd_chunk() { return kChunk; }

// Pointers are device pointers; `stream` is a cudaStream_t.  d_logits and
// d_values must be zeroed where no slot lists an entry.  Scratch: dal
// [slots, heads], slot_row [slots], row_m/row_inv/row_d [rows, heads],
// part_m/part_l/part_s [ceil(slots / chunk), 2, heads].  slots >= 1 and
// rowptr[rows] == slots; merge_blocks >= 1 is pass 2's grid.
int segment_spmm_bwd(const float* logits, const float* values,
                     const int* rowptr, const int* idx, const float* g,
                     float* d_logits, float* d_values, float* dal,
                     int* slot_row, float* row_m, float* row_inv,
                     float* row_d, float* part_m, float* part_l,
                     float* part_s, int rows, int slots, int hc, int heads,
                     int channels, int merge_blocks, void* stream) {
  const Kernels k = pick<Make>(hc, heads, channels);
  if (k.stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Params q{logits,  values, rowptr, idx,    g,      d_logits, d_values,
                 dal,     slot_row, row_m, row_inv, row_d, part_m, part_l,
                 part_s,  rows,   slots,  hc,     heads,  channels};
  const int chunks = (slots + kChunk - 1) / kChunk;
  const int blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  k.stats<<<blocks, kThreads, 0, s>>>(q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_stats_kernel<<<merge_blocks, kThreads, 0, s>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k.entries<<<blocks, kThreads, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
