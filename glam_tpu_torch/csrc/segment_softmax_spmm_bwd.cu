// Segment softmax + SpMM backward for Hopper (sm_90a).
//
// The TPU kernel (glam_tpu/ops/pallas/segment_mxu.py:100, forward only)
// has no backward; the JAX package differentiates the same function by
// XLA autodiff of `segment_softmax` (glam_tpu/ops/segment.py:50) and
// `segment_sum` (:21).  This is that gradient as a kernel.  With the
// forward's output out [R, H*C] and row statistics (row_max, row_inv =
// 1 / (sum + 1e-16), [R, H] each) and the output's cotangent g [R, H*C],
// it computes for every entry e of row r
//
//   alpha_e     = exp(x_e - row_max[r]) * row_inv[r]      (per head)
//   d_values[e] = alpha_e (per head) * g[r]
//   dalpha_e    = <g[r]_h, values[e]_h>                  (per head h)
//   d_logits[e] = alpha_e * (dalpha_e - D_r),
//   D_r         = sum_{e' in r} alpha_e' dalpha_e' = <g[r]_h, out[r]_h>
//
// (the last identity is the softmax backward's row term read from the
// forward's output, as FlashAttention's backward does).  Entries that no
// slot lists keep the caller's zeros.
//
// Bound.  Under one flop per byte, so tensor cores do not apply and bytes
// bound it at large shapes: the entries' logits and values, the rows' g,
// out and statistics read once, d_logits and d_values written once.  At
// the trainer's shapes it is one warp's chain of dependent steps plus one
// launch.
//
// Design (segment_softmax_spmm_common.cuh has the search and the ring).
// With the forward's statistics alpha is known per entry, and with D_r
// read from out no entry waits for the rest of its row: every warp is
// independent, so one launch, no fill when every entry is listed, no
// scratch, no merges and no atomics.  A warp takes 32 slots: it reads
// their entries and logits, requests their value rows by cp.async.bulk
// (or cp.async) into a shared-memory ring, finds their rows by the
// warp-wide search and loads each of its rows' statistics once (a lane
// per row).  Then, per stage of the ring, lanes over float4 groups of one
// head (C % 4 == 0) write d_values and each slot's per-group products to
// shared memory, and a lane per slot sums its head's groups (dalpha, and
// D_r at a row's first slot) and writes d_logits: no warp reductions, so
// the slots' work does not wait on one another.  A long row is spread
// over as many warps as it has chunks of 32 slots.  The result does not
// depend on scheduling.
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
  const float* out;      // [rows, hc]
  const float* g;        // [rows, hc]
  const float* row_max;  // [rows, heads]
  const float* row_inv;  // [rows, heads]
  float* d_logits;       // [M, heads]
  float* d_values;       // [M, hc]
  int rows, slots, hc, heads, channels, stage_rows, copy_mode;
};

constexpr int kStageMax = 8;                // slots a stage at most

// Floats a warp keeps beside its ring: alpha, D, row_max, row_inv
// [32][H] each, and two [P][Gp] tables of per-group products (Gp = the
// groups, odd, so that lanes reading a column hit distinct banks).
__host__ __device__ inline int padded_groups(int hc, int channels) {
  return (channels % 4 == 0 ? hc / 4 : hc) | 1;
}
__host__ __device__ inline int warp_floats(int hc, int heads, int channels,
                                           int P) {
  return 4 * kChunk * heads + 2 * P * padded_groups(hc, channels);
}

template <int W, int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads) bwd_kernel(const Params q) {
  using T = typename Vec<W>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int H = q.heads, hc = q.hc, S = q.slots, P = q.stage_rows;
  const int C = q.channels, per_head = C / W, Gp = padded_groups(hc, C);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(bars + kWarps * 2);
  const int nw = block_warps();
  float* sa = ring + (size_t)nw * 2 * P * 3 * hc +
              (size_t)warp * warp_floats(hc, H, C, P);  // [slot][H] alpha
  float* sD = sa + kChunk * H;               // [segment][H] D of its row
  float* sM = sD + kChunk * H;               // [segment][H] row_max
  float* sI = sM + kChunk * H;               // [segment][H] row_inv
  float* sP = sI + kChunk * H;               // [P][Gp] <values, g> by group
  float* sQ = sP + P * Gp;                   // [P][Gp] <g, out> by group
  int* sR = reinterpret_cast<int*>(ring + (size_t)nw * 2 * P * 3 * hc +
                                   (size_t)nw * warp_floats(hc, H, C, P)) +
            warp * kChunk;                   // [segment] row

  const int c0 = blockIdx.x * blockDim.x + warp * kChunk;
  const int cnt = max(0, min(kChunk, S - c0));
  if (cnt == 0) return;                      // warps share nothing
  const Groups<VPL> gr(lane, hc / W, per_head);
  const Ring rg{ring + (size_t)warp * 2 * P * 3 * hc, bars + warp * 2, P, hc,
                3 * hc, q.copy_mode};
  if (q.copy_mode == kBulk && lane == 0) {
    mbar_init(bars + warp * 2);
    mbar_init(bars + warp * 2 + 1);
  }
  __syncwarp();
  const int my_e = lane < cnt ? __ldg(q.idx + c0 + lane) : 0;
  float x[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    x[h] = lane < cnt && h < H ? __ldg(q.logits + (size_t)my_e * H + h) : 0.f;
  }
  const SlotRow me = slot_rows(q.rowptr, q.rows, c0, cnt, lane);
  const Segs sg = chunk_segments(me, c0, cnt, lane);
  const bool start = lane < cnt && (sg.starts >> lane & 1);
  if (start) sR[sg.rank] = me.row;
  __syncwarp();

  // Stage i's rows, requested at once: each slot's value row; g of the
  // row at the stage's first slot and at each row's first slot (the
  // stage's other slots read their row's copy); out of the row at each
  // row's first slot.  A slot takes three rows of the ring.
  auto issue = [&](int i) {
    const int t0 = i * P, n = min(P, cnt - t0);
    if (n > 0) {
      const unsigned in = (1u << n) - 1u;          // n <= kStageMax
      const unsigned firsts = (sg.starts >> t0) & in;
      rg.begin(i, n + __popc(firsts | 1u) + __popc(firsts), lane);
      rg.copy(i, t0, n, lane, in, q.values, my_e, 0);
      rg.copy(i, t0, n, lane, firsts | 1u, q.g, me.row, hc);
      rg.copy(i, t0, n, lane, firsts, q.out, me.row, 2 * hc);
    }
    rg.end();
  };
  issue(0);
  issue(1);

  // a lane per row of the chunk loads its statistics; a lane per slot
  // computes its alpha
  if (lane < __popc(sg.starts)) {
    const int r = sR[lane];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        sM[lane * H + h] = __ldg(q.row_max + (size_t)r * H + h);
        sI[lane * H + h] = __ldg(q.row_inv + (size_t)r * H + h);
      }
    }
  }
  __syncwarp();
  if (lane < cnt) {
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        sa[lane * H + h] =
            expf(x[h] - sM[sg.rank * H + h]) * sI[sg.rank * H + h];
      }
    }
  }
  __syncwarp();

  // Per stage: lanes over groups write d_values and each slot's per-group
  // products <values, g> (and <g, out> at a row's first slot) to the
  // tables; then a lane per slot sums its head's groups in order: dalpha,
  // D of the rows starting here, and d_logits.  No shuffles in the walk.
  const int nst = (cnt + P - 1) / P;
  for (int i = 0; i < nst; ++i) {
    rg.wait(i);
    const int t0 = i * P, n = min(P, cnt - t0);
    // the stage's products in registers first (no shared-memory stores
    // among the loads, so they are in flight together), then the tables
    float pv[kStageMax][VPL], pg[kStageMax][VPL];
#pragma unroll
    for (int kk = 0; kk < kStageMax; ++kk) {
      if (kk >= n) break;                               // warp-uniform
      const int t = t0 + kk;
      const int e = __shfl_sync(kFull, my_e, t);
      const int beg = __shfl_sync(kFull, me.beg, t);
      const bool first = sg.starts >> t & 1;
      // the slot of the stage holding this row's g
      const int hk = max(max(beg - c0, 0) - t0, 0);
      const T* vrow = reinterpret_cast<const T*>(rg.slot_ptr(i, kk));
      const T* grow = reinterpret_cast<const T*>(rg.slot_ptr(i, hk) + hc);
      const T* orow = reinterpret_cast<const T*>(rg.slot_ptr(i, kk) + 2 * hc);
      T* dv = reinterpret_cast<T*>(q.d_values + (size_t)e * hc);
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        pv[kk][v] = pg[kk][v] = 0.f;
        if (!gr.ok[v]) continue;
        const int gi = lane + kWarp * v;
        const T gv = grow[gi];
        pv[kk][v] = dot4(vrow[gi], gv);
        if (first) pg[kk][v] = dot4(gv, orow[gi]);
        __stcg(dv + gi, sa[t * H + gr.head[v]] * gv);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kStageMax; ++kk) {
      if (kk >= n) break;
      const bool first = sg.starts >> (t0 + kk) & 1;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (!gr.ok[v]) continue;
        sP[kk * Gp + lane + kWarp * v] = pv[kk][v];
        if (first) sQ[kk * Gp + lane + kWarp * v] = pg[kk][v];
      }
    }
    __syncwarp();
    // lane j takes slot t0 + j of the stage
    const int t = t0 + lane, tl = min(t, kWarp - 1);
    const int e_t = __shfl_sync(kFull, my_e, tl);
    const int seg_t = __shfl_sync(kFull, sg.rank, tl);
    if (lane < n && (sg.starts >> t & 1)) {
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h < H) {
          float d = 0.f;
          for (int gi = h * per_head; gi < (h + 1) * per_head; ++gi) {
            d += sQ[lane * Gp + gi];
          }
          sD[seg_t * H + h] = d;
        }
      }
    }
    __syncwarp();
    if (lane < n) {
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h < H) {
          float d = 0.f;
          for (int gi = h * per_head; gi < (h + 1) * per_head; ++gi) {
            d += sP[lane * Gp + gi];
          }
          q.d_logits[(size_t)e_t * H + h] =
              sa[t * H + h] * (d - sD[seg_t * H + h]);
        }
      }
    }
    rg.release();
    issue(i + 2);
  }
}

template <int W, int VPL, int MAXH>
struct Make {
  static void (*get())(const Params) { return bwd_kernel<W, VPL, MAXH>; }
};

}  // namespace

extern "C" {

int segment_spmm_bwd_max_hc() { return kMaxHC; }
int segment_spmm_bwd_max_heads() { return kMaxHeads; }

// Pointers are device pointers; `stream` is a cudaStream_t.  d_logits and
// d_values must be zeroed where no slot lists an entry.  Blocks of
// `warps` warps (1 to 8), 32 slots a warp.  d_values
// 16-byte aligned; copy_mode a CopyMode, kCopy4 unless hc % 4 == 0 and
// values, g and out are 16-byte aligned.  slots >= 1 and rowptr[rows] ==
// slots.
int segment_spmm_bwd(const float* logits, const float* values,
                     const int* rowptr, const int* idx, const float* out,
                     const float* g, const float* row_max,
                     const float* row_inv, float* d_logits, float* d_values,
                     int rows, int slots, int hc, int heads, int channels,
                     int copy_mode, int warps, void* stream) {
  const auto kernel = pick<Make>(hc, heads, channels);
  if (kernel == nullptr || rows < 1 || slots < 1 || warps < 1 ||
      warps > kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // slots per stage: the ring's three rows and the two tables' rows
  const int P = stage_rows(3 * hc + 2 * padded_groups(hc, channels),
                           kStageMax);
  const Params q{logits,  values,   rowptr,   idx,  out,      g,
                 row_max, row_inv,  d_logits, d_values, rows, slots,
                 hc,      heads,    channels, P,    copy_mode};
  const size_t bytes =
      sizeof(uint64_t) * kWarps * 2 +
      sizeof(float) * ((size_t)warps * 2 * P * 3 * hc +
                       (size_t)warps * warp_floats(hc, heads, channels, P)) +
      sizeof(int) * warps * kChunk;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int bslots = warps * kChunk;
  const int blocks = (slots + bslots - 1) / bslots;
  kernel<<<blocks, bslots, bytes, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
