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
// with PyG's semantics: an empty row gives 0.  It also writes each row's
// statistics, row_max [R, H] and row_inv = 1 / (sum + 1e-16) [R, H] (0 and
// 0 for an empty row), which the backward kernel reads instead of
// recomputing them.  The CSR is given as row pointers [R + 1] and the entry
// of each slot, idx [S]; an entry is listed at most once.
//
// Bound.  Under one flop per byte (an exp and a multiply-add per value
// read): a weighted gather, so tensor cores do not apply and bytes bound
// it at large shapes (each entry's logits and values read once, the
// output written once).  At the trainer's shapes (a few thousand slots,
// ~20 blocks) it is the chain of dependent steps of one warp plus one
// launch: search the row pointers, read the entries, gather the value
// rows, reduce, merge what crosses blocks.
//
// Design (segment_softmax_spmm_common.cuh has the layout):
//  - one launch and no fill: a block owns 32 slots a warp (8 warps where
//    rows are long, so that a row leaves few block states; fewer where
//    they are short, so that the blocks spread over the SMs), writes every
//    row whose slots end in it and the empty rows of its share of the
//    rows; rows that cross blocks are merged in the same launch by the
//    block that takes their last ticket, in CSR order, so the result does
//    not depend on scheduling;
//  - a short chain: the warp finds its rows by a 32-way search (3 rounds
//    at 32k rows) and one window of 33 row pointers, instead of a binary
//    search per lane (12-15 dependent loads); each row's max and sum of
//    exp over the chunk come from segmented scans over the lanes (one exp
//    per slot, in parallel), so the walk over the slots is a chain of
//    multiply-adds only;
//  - the chunk's value rows are requested at once by cp.async.bulk (or
//    cp.async) into a shared-memory ring while the rows are searched, the
//    next stage in flight while one is reduced;
//  - rows that cross warps are merged in shared memory, rows that cross
//    blocks from one state per block (173 for a 44,096-entry serving row,
//    merged by the 8 warps of the last block, several loads in flight
//    each), not one per 32 slots;
//  - lanes own float4 groups of one head each (C % 4 == 0), so multi-head
//    widths need no select across heads.
//
// Interface: plain C, loaded with ctypes.  The launch returns
// cudaGetLastError(); the caller raises if it is not 0.

#include "segment_softmax_spmm_common.cuh"

namespace {

using namespace segment_spmm;

struct Params {
  const float* logits;   // [M, heads]
  const float* values;   // [M, hc]
  const int* rowptr;     // [rows + 1]
  const int* idx;        // [slots]
  float* out;            // [rows, hc]
  float* row_max;        // [rows, heads]
  float* row_inv;        // [rows, heads]
  float* part;           // [blocks, 2, sw]: states of rows crossing blocks
  int* tickets;          // [blocks], zero on entry and on exit
  int rows, slots, hc, heads, channels, stage_rows, copy_mode;
};

// One softmax state (per group of the lane): the max, the sum of
// exp(x - max) and the weighted sum of the values.  In memory a state is
// sw floats: acc [hc], then max [heads], then sum [heads].
template <int W, int VPL>
struct State {
  using T = typename Vec<W>::T;
  float m[VPL], l[VPL];
  T acc[VPL];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      m[v] = -INFINITY;
      l[v] = 0.f;
      acc[v] = zero<T>();
    }
  }

  // A state from memory (cg: through L2, written by other blocks).
  template <bool cg>
  __device__ __forceinline__ void load(const float* src, int hc, int heads,
                                       const Groups<VPL>& gr, int lane) {
    reset();
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!gr.ok[v]) continue;
      const T* a = reinterpret_cast<const T*>(src) + lane + kWarp * v;
      const float* mp = src + hc + gr.head[v];
      m[v] = cg ? __ldcg(mp) : *mp;
      l[v] = cg ? __ldcg(mp + heads) : mp[heads];
      acc[v] = cg ? __ldcg(a) : *a;
    }
  }

  // Merge state o in (a state of no entries, max -inf, changes nothing).
  __device__ __forceinline__ void merge(const State& o) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!(o.m[v] > -INFINITY)) continue;
      const float mn = fmaxf(m[v], o.m[v]);
      const float sa = expf(m[v] - mn), sb = expf(o.m[v] - mn);
      l[v] = l[v] * sa + o.l[v] * sb;
      acc[v] = fma4(sa, acc[v], sb, o.acc[v]);
      m[v] = mn;
    }
  }

  __device__ __forceinline__ void put(float* dst, int hc, int heads,
                                      const Groups<VPL>& gr, int lane) const {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!gr.ok[v]) continue;
      reinterpret_cast<T*>(dst)[lane + kWarp * v] = acc[v];
      if (gr.first[v]) {
        dst[hc + gr.head[v]] = m[v];
        dst[hc + heads + gr.head[v]] = l[v];
      }
    }
  }

  // The finished row r: out and its statistics.
  __device__ __forceinline__ void write(const Params& q, int r,
                                        const Groups<VPL>& gr,
                                        int lane) const {
    T* o = reinterpret_cast<T*>(q.out + (size_t)r * q.hc);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!gr.ok[v]) continue;
      const float inv = 1.f / (l[v] + kEps);
      o[lane + kWarp * v] = inv * acc[v];
      if (gr.first[v]) {
        q.row_max[(size_t)r * q.heads + gr.head[v]] = m[v];
        q.row_inv[(size_t)r * q.heads + gr.head[v]] = inv;
      }
    }
  }
};

__host__ __device__ inline int state_floats(int hc, int heads) {
  return (hc + 2 * heads + 3) & ~3;
}

// Zeros for the empty rows among rows [r0, r1): lanes test 32 rows at a
// time, then write the empty ones' groups and statistics together.
template <int W>
__device__ __forceinline__ void zero_empty_rows(const Params& q, int r0,
                                                int r1, int warp, int lane) {
  using T = typename Vec<W>::T;
  const int groups = q.hc / W, H = q.heads;
  for (int base = r0 + warp * kWarp; base < r1; base += blockDim.x) {
    const int r = base + lane;
    const bool empty =
        r < r1 && __ldg(q.rowptr + r) == __ldg(q.rowptr + r + 1);
    const unsigned mask = __ballot_sync(kFull, empty);
    if (mask == 0) continue;
    T* o = reinterpret_cast<T*>(q.out + (size_t)base * q.hc);
    for (int j = lane; j < kWarp * groups; j += kWarp) {
      if (mask >> (j / groups) & 1) o[j] = zero<T>();
    }
    for (int j = lane; j < kWarp * H; j += kWarp) {
      if (mask >> (j / H) & 1) {
        q.row_max[(size_t)base * H + j] = 0.f;
        q.row_inv[(size_t)base * H + j] = 0.f;
      }
    }
  }
}

// A chunk's segment is summed: write its row (seg: row, start, end) if it
// lies inside the chunk [c0, c1), else leave its state in the warp's
// slot 0 (the row started before the chunk) or 1 for the block's merge.
template <int W, int VPL>
__device__ __forceinline__ void finish(const Params& q,
                                       const State<W, VPL>& s,
                                       const int* seg, int c0, int c1,
                                       float* st, int sw, int* meta,
                                       const Groups<VPL>& gr, int lane) {
  const int r = seg[0], beg = seg[1], end = seg[2];
  if (beg >= c0 && end <= c1) {
    s.write(q, r, gr, lane);
    return;
  }
  const int slot = beg < c0 ? 0 : 1;
  s.put(st + (size_t)slot * sw, q.hc, q.heads, gr, lane);
  if (lane == 0) {
    meta[slot * 3] = r;
    meta[slot * 3 + 1] = beg;
    meta[slot * 3 + 2] = end;
  }
}

// W: channels per group (4 or 1); VPL: groups per lane; MAXH: most heads.
template <int W, int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Params q) {
  using T = typename Vec<W>::T;
  using St = State<W, VPL>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int H = q.heads, hc = q.hc, S = q.slots, P = q.stage_rows;
  const int sw = state_floats(hc, H);
  const int nw = block_warps(), bslots = blockDim.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(bars + kWarps * 2);
  float* st = ring + (size_t)nw * 2 * P * hc;         // [nw][2][sw]
  float* sp = st + (size_t)nw * 2 * sw;                // [nw][32][H]
  float* sm = sp + nw * kChunk * H;                    // [nw][32][H]
  float* sl = sm + nw * kChunk * H;                    // [nw][32][H]
  int* sr = reinterpret_cast<int*>(sl + nw * kChunk * H);  // [nw][32][3]
  int* meta = sr + nw * kChunk * 3;                    // [nw][2][3]
  int* last = meta + nw * 6;                           // [2][3]

  const int b0 = blockIdx.x * bslots;
  const int b1 = min(b0 + bslots, S);
  const int c0 = b0 + warp * kChunk;
  const int cnt = max(0, min(kChunk, S - c0));
  const int c1 = c0 + cnt;
  const Groups<VPL> gr(lane, hc / W, q.channels / W);
  if (lane == 0) {
    for (int i = 0; i < 6; ++i) meta[warp * 6 + i] = -1;
  }
  if (threadIdx.x < 6) last[threadIdx.x] = -1;
  const int per = (q.rows + gridDim.x - 1) / gridDim.x;
  const int r0 = min(q.rows, (int)blockIdx.x * per);

  if (cnt > 0) {                                       // warp-uniform
    const Ring rg{ring + (size_t)warp * 2 * P * hc, bars + warp * 2, P, hc,
                  hc, q.copy_mode};
    // stage i's value rows, requested at once
    auto issue = [&](int i, int my_e) {
      const int t0 = i * P, n = min(P, cnt - t0);
      if (n > 0) {
        rg.begin(i, n, lane);
        rg.copy(i, t0, n, lane, kFull, q.values, my_e, 0);
      }
      rg.end();
    };
    if (q.copy_mode == kBulk && lane == 0) {
      mbar_init(bars + warp * 2);
      mbar_init(bars + warp * 2 + 1);
    }
    __syncwarp();
    const int my_e = lane < cnt ? __ldg(q.idx + c0 + lane) : 0;
    issue(0, my_e);
    issue(1, my_e);
    float x[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      x[h] = lane < cnt && h < H ? __ldg(q.logits + (size_t)my_e * H + h)
                                 : 0.f;
    }
    zero_empty_rows<W>(q, r0, min(q.rows, r0 + per), warp, lane);
    const SlotRow me = slot_rows(q.rowptr, q.rows, c0, cnt, lane);
    const Segs sg = chunk_segments(me, c0, cnt, lane);

    // each row's max and sum of exp over its slots in this chunk, by
    // segmented scans over the lanes; each slot's weight exp(x - max)
    float* p = sp + warp * kChunk * H;                 // [slot][H]
    float* segm = sm + warp * kChunk * H;              // [segment][H]
    float* segl = sl + warp * kChunk * H;              // [segment][H]
    int* segr = sr + warp * kChunk * 3;                // [segment][3]
    const bool start = lane < cnt && (sg.starts >> lane & 1);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        const float m = segment_total<true>(x[h], sg, lane, cnt);
        const float e = expf(x[h] - m);
        const float l = segment_total<false>(e, sg, lane, cnt);
        if (lane < cnt) p[lane * H + h] = e;
        if (start) {
          segm[sg.rank * H + h] = m;
          segl[sg.rank * H + h] = l;
        }
      }
    }
    if (start) {
      segr[sg.rank * 3] = me.row;
      segr[sg.rank * 3 + 1] = me.beg;
      segr[sg.rank * 3 + 2] = me.end;
    }
    __syncwarp();

    // the weighted sums, segment by segment: a row inside the chunk is
    // written, one crossing the chunk's start or end left as a state
    St s;
    int k = -1;
    const int nst = (cnt + P - 1) / P;
    for (int i = 0; i < nst; ++i) {
      rg.wait(i);
      const int t0 = i * P, t1 = t0 + min(P, cnt - t0);
      for (int t = t0; t < t1;) {                      // warp-uniform
        if (sg.starts >> t & 1) {
          if (k >= 0) {
            finish(q, s, segr + k * 3, c0, c1, st + (size_t)warp * 2 * sw,
                   sw, meta + warp * 6, gr, lane);
          }
          ++k;
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            s.m[v] = segm[k * H + gr.head[v]];
            s.l[v] = segl[k * H + gr.head[v]];
            s.acc[v] = zero<T>();
          }
        }
        // the slots up to the next row's first or the stage's end: a loop
        // with no stores, so the loads of several slots are in flight
        const unsigned later = t + 1 < kWarp ? sg.starts >> (t + 1) : 0u;
        const int stop = later ? min(t1, t + __ffs(later)) : t1;
#pragma unroll 4
        for (int u = t; u < stop; ++u) {
          const T* vrow = reinterpret_cast<const T*>(rg.slot_ptr(i, u - t0));
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            if (gr.ok[v]) {
              s.acc[v] = fma4(1.f, s.acc[v], p[u * H + gr.head[v]],
                              vrow[lane + kWarp * v]);
            }
          }
        }
        t = stop;
      }
      rg.release();
      issue(i + 2, my_e);
    }
    finish(q, s, segr + k * 3, c0, c1, st + (size_t)warp * 2 * sw, sw,
           meta + warp * 6, gr, lane);
  } else {
    zero_empty_rows<W>(q, r0, min(q.rows, r0 + per), warp, lane);
  }
  __syncthreads();

  // Rows crossing this block's chunk boundaries: merged by the warp that
  // holds the row's first slot in the block (warp 0 also for the row that
  // started before the block), over the warps' states in order.
  for (int c = 0; c < 2; ++c) {
    const int slot = c == 0 ? 1 : 0;
    if (c == 1 && warp != 0) break;
    const int* mt = meta + (warp * 2 + slot) * 3;
    const int r = mt[0];
    if (r < 0) continue;
    const int beg = mt[1], end = mt[2];
    const int wl = (min(end, b1) - 1 - b0) / kChunk;
    St s, o;
    s.reset();
    for (int w2 = warp; w2 <= wl; ++w2) {
      o.template load<false>(
          st + (size_t)(w2 * 2 + (w2 == warp ? slot : 0)) * sw, hc, H, gr,
          lane);
      s.merge(o);
    }
    if (beg >= b0 && end <= b1) {
      s.write(q, r, gr, lane);
      continue;
    }
    const int bslot = beg < b0 ? 0 : 1;
    s.put(q.part + ((size_t)blockIdx.x * 2 + bslot) * sw, hc, H, gr, lane);
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      const int bf = beg / bslots;
      const int n = (end - 1) / bslots - bf + 1;
      if (atomicAdd(q.tickets + bf, 1) == n - 1) {
        __threadfence();
        last[bslot * 3] = r;
        last[bslot * 3 + 1] = beg;
        last[bslot * 3 + 2] = end;
      }
    }
  }
  __syncthreads();

  // Rows whose last ticket this block took: warp k merges the states of
  // blocks bf + k, bf + k + 8, ... (kU loads in flight), then warp 0 the 8
  // results in order.
  for (int bs = 0; bs < 2; ++bs) {
    const int r = last[bs * 3];
    if (r < 0) continue;                               // block-uniform
    const int beg = last[bs * 3 + 1], end = last[bs * 3 + 2];
    const int bf = beg / bslots, bl = (end - 1) / bslots;
    constexpr int kU = VPL <= 2 ? 4 : 2;
    St s;
    s.reset();
    for (int b = bf + warp; b <= bl; b += kU * nw) {
      St o[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int bb = b + u * nw;
        if (bb <= bl) {
          o[u].template load<true>(
              q.part + ((size_t)bb * 2 + (bb == bf ? 1 : 0)) * sw, hc, H, gr,
              lane);
        } else {
          o[u].reset();
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) s.merge(o[u]);
    }
    s.put(st + (size_t)warp * sw, hc, H, gr, lane);
    __syncthreads();
    if (warp == 0) {
      St f, o;
      f.reset();
      for (int w2 = 0; w2 < nw; ++w2) {
        o.template load<false>(st + (size_t)w2 * sw, hc, H, gr, lane);
        f.merge(o);
      }
      f.write(q, r, gr, lane);
      if (lane == 0) q.tickets[bf] = 0;
    }
    __syncthreads();
  }
}

template <int W, int VPL, int MAXH>
struct Make {
  static void (*get())(const Params) { return fwd_kernel<W, VPL, MAXH>; }
};

}  // namespace

extern "C" {

int segment_spmm_fwd_max_hc() { return kMaxHC; }
int segment_spmm_fwd_max_heads() { return kMaxHeads; }

// Pointers are device pointers; `stream` is a cudaStream_t.  Blocks of
// `warps` warps (1 to 8) take 32 slots a warp; with blocks =
// max(1, ceil(slots / (32 warps))) and sw = (hc + 2 heads + 3) & ~3:
// part holds blocks * 2 * sw floats, tickets `blocks` ints that are zero
// (and are zero again when the kernel ends).  out and part 16-byte
// aligned; copy_mode a CopyMode, kCopy4 unless hc % 4 == 0 and values is
// 16-byte aligned.  rows >= 1 and rowptr[rows] == slots.
int segment_spmm_fwd(const float* logits, const float* values,
                     const int* rowptr, const int* idx, float* out,
                     float* row_max, float* row_inv, float* part,
                     int* tickets, int rows, int slots, int hc, int heads,
                     int channels, int copy_mode, int warps, void* stream) {
  const auto kernel = pick<Make>(hc, heads, channels);
  if (kernel == nullptr || rows < 1 || warps < 1 || warps > kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = stage_rows(hc);
  const Params q{logits, values, rowptr, idx,   out,  row_max,  row_inv,
                 part,   tickets, rows, slots, hc,  heads, channels,
                 P,      copy_mode};
  const size_t bytes =
      sizeof(uint64_t) * kWarps * 2 +
      sizeof(float) * ((size_t)warps * 2 * P * hc +
                       (size_t)warps * 2 * state_floats(hc, heads) +
                       (size_t)3 * warps * kChunk * heads) +
      sizeof(int) * (warps * kChunk * 3 + warps * 6 + 6);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int bslots = warps * kChunk;
  const int blocks = slots > 0 ? (slots + bslots - 1) / bslots : 1;
  kernel<<<blocks, bslots, bytes, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
