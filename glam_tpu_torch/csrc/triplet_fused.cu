// Fused TripletMessage attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of the JAX package
// (glam_tpu/ops/pallas/triplet_fused.py:236, launched by `_forward`'s
// pallas_call at :480).  For every receiver r it computes, over the real
// incoming edges e = (s -> r):
//
//   eh    = edge_attr[e] @ We                         [H*C]
//   pre_h = leaky_relu(a_i[r,h] + (eh @ wemat)[h] + a_j[s,h], slope)
//   alpha = softmax of pre over r's incoming edges   (PyG: max shift,
//                                                      +1e-16, 0 if empty)
//   out[r] = sum_e alpha_h * eh * xp[s]               (head-major [H*C])
//
// and each row's softmax statistics, row_max [N, H] and row_inv =
// 1 / (sum + 1e-16) [N, H] (0 and 0 for an empty row), which the backward
// kernel (triplet_fused_bwd.cu) reads instead of recomputing the softmax.
//
// Design (triplet_common.cuh has the layout).  The TPU kernel packs
// receiver-sorted edges into 256-edge blocks with 128-node windows and
// turns every gather into a one-hot matmul, because Mosaic has no gather.
// Hopper gathers, so the host hands over a receiver-sorted CSR of the real
// edges (rowptr, snd, eid; its slot arrays may run past rowptr[n], to the
// batch's edge budget, so that every batch launches the same grid).  One
// launch, no fill:
//  - a row of 1-32 edges is one warp's, one edge a lane: the lane loads
//    its edge's indices, features and a_j, and the warp requests the
//    senders' xp rows, before the block's one barrier; the logits' max and
//    sum are warp reductions, then the warp sums the messages with lanes
//    over float4 groups of channels (C % 4 == 0), each group in one head;
//  - a row of more than 32 edges is cut into the 32-slot chunks of slot
//    warps; each leaves (max, sum, weighted sum) per head, and the last
//    to take the row's ticket merges them in CSR order;
//  - 8 empty rows in a row (a serving batch's padding nodes) cost their
//    block two row pointers and coalesced zero stores.
// Each output row is written once, with no atomics, so two calls give
// bitwise the same result.
//
// Bound.  The work per edge is ~H*C*(2*Fe+3) flops against H*C*4 bytes of
// xp[s], far below the card's ratio of flops to bytes, so bytes bound it
// at large shapes: the out rows (N*H*C*4 bytes, most of them padding rows
// of zeros) and the sender rows of xp.  At a training batch (a few
// thousand rows) what it waits on is one launch and a warp's chain of
// dependent loads: row pointers, indices, then features and xp rows.
//
// Interface: plain C, loaded with ctypes.  The launch returns
// cudaGetLastError(); the caller raises if it is not 0.

#include "triplet_common.cuh"

namespace {

using namespace triplet;

// blocks per SM the register budget must allow: more resident warps hide
// more of the rows' load latency
constexpr int kMinBlocksPerSM = 3;

struct Params {
  const float* xp;          // [n, hc]
  const float* a_i;         // [n, heads]
  const float* a_j;         // [n, heads]
  const float* edge_attr;   // [E, fe]
  const float* we;          // [fe, hc]
  const float* wemat;       // [hc, heads]
  const int* rowptr;        // [n + 1]
  const int* snd;           // [slots]
  const int* eid;           // [slots]
  float* out;               // [n, hc]
  float* row_max;           // [n, heads]
  float* row_inv;           // [n, heads]
  float* part;              // [chunks, 2, sw]: long rows' partial results
  int* tickets;             // [chunks], zero on entry and on exit
  int n, slots, hc, heads, channels, fe, slot_blocks;
  float slope;
};

// Shared memory floats: We [fe, hc] and Wf [fe, heads] for the block, then
// per warp the chunk's edge features [32, fe] and softmax weights
// [32, heads].
__host__ __device__ inline int warp_floats(int heads, int fe) {
  return kChunk * (fe + heads);
}
__host__ __device__ inline size_t smem_floats(int hc, int heads, int fe) {
  return (size_t)fe * hc + up4(fe * heads) +
         (size_t)kWarps * warp_floats(heads, fe);
}

__host__ __device__ inline int state_floats(int hc, int heads) {
  return up4(hc + 2 * heads);
}

// One softmax state per group of the lane: the max, the sum of
// exp(x - max) and the weighted sum of the messages.  In memory a state is
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

  // A state written by another warp (through L2).
  __device__ __forceinline__ void load(const float* src, int hc, int heads,
                                       const Groups<VPL>& gr, int lane) {
    reset();
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!gr.ok[v]) continue;
      m[v] = __ldcg(src + hc + gr.head[v]);
      l[v] = __ldcg(src + hc + heads + gr.head[v]);
      acc[v] = __ldcg(reinterpret_cast<const T*>(src) + lane + kWarp * v);
    }
  }

  // Merge state o in (a state of no edges, max -inf, changes nothing).
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
    T* o = reinterpret_cast<T*>(q.out) + (size_t)r * (q.hc / W);
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

// Zeros for rows [r0, r1), all empty, by the whole block.
template <int W>
__device__ __forceinline__ void zero_rows(const Params& q, int r0, int r1) {
  using T = typename Vec<W>::T;
  const int groups = q.hc / W, H = q.heads;
  T* o = reinterpret_cast<T*>(q.out) + (size_t)r0 * groups;
  for (int i = threadIdx.x; i < (r1 - r0) * groups; i += blockDim.x) {
    o[i] = zero<T>();
  }
  for (int i = threadIdx.x; i < (r1 - r0) * H; i += blockDim.x) {
    q.row_max[(size_t)r0 * H + i] = 0.f;
    q.row_inv[(size_t)r0 * H + i] = 0.f;
  }
}

// The softmax over the lanes with `in` (one row's edges in this chunk):
// per head the max m and the sum l of p = exp(pre - m); each lane's p into
// p_row.
template <int MAXH>
__device__ __forceinline__ void chunk_softmax(const float (&x)[MAXH],
                                              bool in, float slope,
                                              int heads, float* p_row,
                                              float (&m)[MAXH],
                                              float (&l)[MAXH]) {
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    m[h] = 0.f;
    l[h] = 0.f;
    if (h < heads) {
      const float pre = in ? leaky(x[h], slope) : -INFINITY;
      m[h] = warp_max(pre);
      const float p = in ? expf(pre - m[h]) : 0.f;
      l[h] = warp_sum(p);
      if (in) p_row[h] = p;
    }
  }
}

// acc += sum over the chunk's slots [ta, tb) of p_t * eh_t * xp[s_t], on
// this lane's groups; the senders' rows gathered U at a time (the first U
// already in xs if `preloaded`).
template <int W, int VPL, int U>
__device__ __forceinline__ void walk(
    const Params& q, int my_snd, int ta, int tb, bool preloaded,
    const float* ea_s, const float* p_s, const float* we_s,
    const Groups<VPL>& gr, int lane, typename Vec<W>::T (&xs)[U][VPL],
    typename Vec<W>::T (&acc)[VPL]) {
  using T = typename Vec<W>::T;
  const int groups = q.hc / W, H = q.heads, fe = q.fe;
  const T* xp = reinterpret_cast<const T*>(q.xp);
  for (int t0 = ta; t0 < tb; t0 += U) {
    if (!preloaded || t0 != ta) {
      gather_rows<W, VPL, U>(xp, groups, my_snd, t0, tb, gr, lane, xs);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t >= tb) break;                          // warp-uniform
      T eh[VPL];
      edge_proj<W, VPL>(ea_s + t * fe, we_s, q.hc, fe, gr, lane, eh);
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (gr.ok[v]) {
          acc[v] = add(acc[v], p_s[t * H + gr.head[v]] * mul(eh[v], xs[u][v]));
        }
      }
    }
  }
}

// A slot block: the slots of rows of more than 32 edges in each warp's
// chunk; each such row's partial result goes to q.part, and the warp that
// takes the row's last ticket merges them and writes the row.
template <int W, int VPL, int MAXH>
__device__ __forceinline__ void long_rows(const Params& q, float* we_s,
                                          float* wf_s, float* ea_s,
                                          float* p_s, const Groups<VPL>& gr,
                                          int lane, int warp) {
  using T = typename Vec<W>::T;
  using St = State<W, VPL>;
  constexpr int U = Unroll<VPL>::value;
  const int H = q.heads, hc = q.hc, fe = q.fe;
  const int c0 = (blockIdx.x * kWarps + warp) * kChunk;
  const int cnt = max(0, min(kChunk, __ldg(q.rowptr + q.n) - c0));
  stage_weights(q.we, q.wemat, hc, H, fe, we_s, wf_s, nullptr);
  SlotRow me{0, 0, 0};
  bool lng = false;
  if (cnt > 0) {                                   // warp-uniform
    me = slot_rows(q.rowptr, q.n, c0, cnt, lane);
    lng = lane < cnt && me.end - me.beg > kChunk;
  }
  const unsigned longs = __ballot_sync(kFull, lng);
  if (!__syncthreads_or(longs != 0)) return;       // block-uniform
  int s = 0;
  float ai[MAXH], aj[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    ai[h] = lng && h < H ? __ldg(q.a_i + (size_t)me.row * H + h) : 0.f;
    aj[h] = 0.f;
  }
  if (lng) {
    s = __ldg(q.snd + c0 + lane);
    load_edge<MAXH>(q.edge_attr, q.a_j, s, __ldg(q.eid + c0 + lane), H, fe,
                    ea_s + lane * fe, aj);
  }
  __syncthreads();
  if (longs == 0) return;
  float x[MAXH];
  raw_logits<MAXH>(ea_s + lane * fe, wf_s, H, fe, ai, aj, x);
  const int sw = state_floats(hc, H);
  for (unsigned rest = longs; rest != 0;) {        // at most two rows
    const LongRow lr = next_long_row(me, rest);
    float m[MAXH], l[MAXH];
    chunk_softmax<MAXH>(x, lr.mask >> lane & 1, q.slope, H, p_s + lane * H,
                        m, l);
    __syncwarp();
    St st;
    T xs[U][VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      st.m[v] = at_head(m, gr.head[v]);
      st.l[v] = at_head(l, gr.head[v]);
      st.acc[v] = zero<T>();
    }
    walk<W, VPL, U>(q, s, lr.ta, lr.tb, false, ea_s, p_s, we_s, gr, lane, xs,
                    st.acc);
    st.put(q.part + part_slot(lr, c0) * sw, hc, H, gr, lane);
    if (last_ticket(q.tickets, lr, lane)) {
      // merge the row's parts in CSR order, kU loads in flight
      const int bf = lr.beg / kChunk, bl = (lr.end - 1) / kChunk;
      constexpr int kU = VPL <= 2 ? 4 : 2;
      St f;
      f.reset();
      for (int k = bf; k <= bl; k += kU) {
        St o[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int kk = k + u;
          if (kk <= bl) {
            o[u].load(q.part + ((size_t)kk * 2 + (kk == bf ? 1 : 0)) * sw, hc,
                      H, gr, lane);
          } else {
            o[u].reset();
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) f.merge(o[u]);
      }
      f.write(q, lr.row, gr, lane);
      if (lane == 0) q.tickets[bf] = 0;
    }
    rest &= ~lr.mask;
    __syncwarp();
  }
}

// W: channels per group (4 or 1); VPL: groups per lane; MAXH: most heads.
template <int W, int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads, VPL <= 2 ? kMinBlocksPerSM : 2)
fwd_kernel(const Params q) {
  using T = typename Vec<W>::T;
  constexpr int U = Unroll<VPL>::value;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int H = q.heads, hc = q.hc, fe = q.fe, groups = hc / W;
  float* we_s = smem;                                  // [fe, hc]
  float* wf_s = we_s + fe * hc;                        // [fe, heads]
  float* ea_s = wf_s + up4(fe * H) + warp * warp_floats(H, fe);  // [32, fe]
  float* p_s = ea_s + kChunk * fe;                     // [32, heads]
  const Groups<VPL> gr(lane, groups, q.channels / W);
  if ((int)blockIdx.x < q.slot_blocks) {
    long_rows<W, VPL, MAXH>(q, we_s, wf_s, ea_s, p_s, gr, lane, warp);
    return;
  }

  // a row block: rows r0 .. r1 - 1, one a warp
  const int r0 = ((int)blockIdx.x - q.slot_blocks) * kWarps;
  const int r1 = min(r0 + kWarps, q.n);
  if (__ldg(q.rowptr + r0) == __ldg(q.rowptr + r1)) {   // block-uniform
    zero_rows<W>(q, r0, r1);
    return;
  }
  const int r = r0 + warp;
  int beg = 0, end = 0;
  if (r < r1) {
    beg = __ldg(q.rowptr + r);
    end = __ldg(q.rowptr + r + 1);
  }
  // the weights' loads in flight beside the row pointers'
  stage_weights(q.we, q.wemat, hc, H, fe, we_s, wf_s, nullptr);
  const int len = end - beg;
  const bool whole = len > 0 && len <= kChunk;         // warp-uniform
  const bool in = whole && lane < len;
  int s = 0;
  float ai[MAXH], aj[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    ai[h] = whole && h < H ? __ldg(q.a_i + (size_t)r * H + h) : 0.f;
    aj[h] = 0.f;
  }
  if (in) {
    s = __ldg(q.snd + beg + lane);
    load_edge<MAXH>(q.edge_attr, q.a_j, s, __ldg(q.eid + beg + lane), H, fe,
                    ea_s + lane * fe, aj);
  }
  T xs[U][VPL];
  if (whole) {
    gather_rows<W, VPL, U>(reinterpret_cast<const T*>(q.xp), groups, s, 0,
                           len, gr, lane, xs);
  }
  __syncthreads();
  if (r >= r1 || len > kChunk) return;                 // long: slot blocks

  State<W, VPL> st;
  st.reset();
  if (whole) {
    float x[MAXH], m[MAXH], l[MAXH];
    raw_logits<MAXH>(ea_s + lane * fe, wf_s, H, fe, ai, aj, x);
    chunk_softmax<MAXH>(x, in, q.slope, H, p_s + lane * H, m, l);
    __syncwarp();
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      st.m[v] = at_head(m, gr.head[v]);
      st.l[v] = at_head(l, gr.head[v]);
    }
    walk<W, VPL, U>(q, s, 0, len, true, ea_s, p_s, we_s, gr, lane, xs,
                    st.acc);
    st.write(q, r, gr, lane);
    return;
  }
  // an empty row: 0, and statistics 0 and 0
  T* o = reinterpret_cast<T*>(q.out) + (size_t)r * groups;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    if (gr.ok[v]) o[lane + kWarp * v] = zero<T>();
  }
  if (lane < H) {
    q.row_max[(size_t)r * H + lane] = 0.f;
    q.row_inv[(size_t)r * H + lane] = 0.f;
  }
}

template <int W, int VPL, int MAXH>
struct Make {
  static void (*get())(const Params) { return fwd_kernel<W, VPL, MAXH>; }
};

}  // namespace

extern "C" {

int triplet_fused_max_hc() { return kMaxHC; }
int triplet_fused_max_heads() { return kMaxHeads; }
int triplet_fused_max_fe() { return kMaxFe; }
long long triplet_fused_smem_bytes(int hc, int heads, int fe) {
  return (long long)(sizeof(float) * smem_floats(hc, heads, fe));
}

// Pointers are device pointers; `stream` is a cudaStream_t.  n >= 1 and
// rowptr[n] <= slots: the slots past rowptr[n] (a CSR padded to the
// batch's edge budget) belong to no row and are not read.  With chunks = ceil(slots / 32) and sw =
// (hc + 2 heads + 3) & ~3: part holds chunks * 2 * sw floats and tickets
// `chunks` ints that are zero (and are zero again when the kernel ends).
// vec = 1 allows float4 channel groups: C % 4 == 0 and xp, out and part
// 16-byte aligned.
int triplet_fused_fwd(const float* xp, const float* a_i, const float* a_j,
                      const float* edge_attr, const float* we,
                      const float* wemat, const int* rowptr, const int* snd,
                      const int* eid, float* out, float* row_max,
                      float* row_inv, float* part, int* tickets, int n,
                      int slots, int hc, int heads, int channels, int fe,
                      float slope, int vec, void* stream) {
  const auto kernel = pick<Make>(hc, heads, channels, vec);
  if (kernel == nullptr || n < 1 || slots < 0 || fe < 0 || fe > kMaxFe) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = sizeof(float) * smem_floats(hc, heads, fe);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slot_blocks = (slots + kThreads - 1) / kThreads;
  const Params q{xp,      a_i,     a_j,   edge_attr, we,    wemat,
                 rowptr,  snd,     eid,   out,       row_max, row_inv,
                 part,    tickets, n,     slots,     hc,    heads,
                 channels, fe,     slot_blocks, slope};
  const int blocks = slot_blocks + (n + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
