// Fused TripletMessage attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of the JAX package
// (glam_tpu/ops/pallas/triplet_fused.py:296-364, launched by `_backward`'s
// pallas_call at :531).  Given the forward's inputs, its output out [N, H*C]
// and row statistics (row_max, row_inv = 1 / (sum + 1e-16), [N, H] each)
// and the cotangent g of its output, for every real edge e = (s -> r)
//
//   eh      = edge_attr[e] @ We                          [H*C]
//   pre_raw = a_i[r] + eh @ wemat + a_j[s]               [H]
//   alpha   = exp(leaky_relu(pre_raw) - row_max[r]) * row_inv[r]
//
// it emits
//
//   d_xpe[e]  = alpha_h * g[r] * eh     (d_xp[s] = sum over s's edges)
//   dalpha_h  = sum_{c in head h} eh * xp[s] * g[r]
//   dpre_h    = alpha_h * (dalpha_h - D_r,h) * (pre_raw_h >= 0 ? 1 : slope)
//   D_r,h     = sum_row alpha_h * dalpha_h = <g[r], out[r]> on head h
//   d_eh[e]   = alpha_h * g[r] * xp[s] + dpre @ wemat^T
//   d_pre[e]  = dpre;   d_a_i[r] = sum over r's edges of dpre
//
// D_r is the softmax backward's row term read from the forward's output
// (out[r] = sum_e alpha * eh * xp[s]), as FlashAttention's backward does,
// so no edge waits for the rest of its row: one pass.  d_xpe, d_eh and
// d_pre are written at the edge's original index (csr_eid).  The caller's
// edges put the real ones first, the first rowptr[n] = E_real slots of
// csr_eid a permutation of [0, E_real): the kernel zeroes the padded
// edges' rows [E_real, E) of d_eh and d_pre itself, so none needs a fill,
// and leaves those of d_xpe unwritten: its sum ends at the real edges
// (segment_sum_csr's limit; the sender CSR lists the padded edges last)
// and reads none of them.  Slots past
// rowptr[n] (a CSR padded to the batch's edge budget) belong to no row and
// are not read.  The caller sums d_xpe and d_pre over the sender CSR
// (segment_sum_csr.cu) into d_xp and d_a_j; the rest of the gradient
// (d_edge_attr, d_We, d_wemat) is small matrix products.
//
// Design (triplet_common.cuh has the layout: a row of 1-32 edges a warp,
// longer rows cut into 32-slot chunks of slot warps).  A lane takes one
// edge (indices, features, logits, alpha); then lanes over float4 groups
// of channels walk the chunk's edges, each edge's dalpha a warp sum per
// head, and write d_xpe, d_eh and d_pre.  A row's d_a_i is summed by its
// warp; a long row leaves one partial sum per chunk, merged in CSR order
// by the warp that takes its last ticket.
//
// d_xp goes to senders, which the receiver CSR does not group.  The JAX
// kernel assembles it in a fixed order (a one-hot matmul, then an
// overlap-add, glam_tpu/ops/pallas/triplet_fused.py:359,541); here each
// edge's term is written once (d_xpe) and the CSR sum over senders adds
// them in an order fixed by the sender CSR.  Every output is written once
// by one thread: bitwise the same on every call.
//
// Bound.  A few flops per byte, so memory traffic bounds it: the sender
// rows of xp, the g and out rows of receivers with edges, the edge
// features, and the d_xpe, d_eh and d_pre outputs.  At a training batch it
// waits on one launch and a warp's chain of dependent loads.
//
// Interface: plain C, loaded with ctypes.  The launch returns
// cudaGetLastError(); the caller raises if it is not 0.

#include "triplet_common.cuh"

namespace {

using namespace triplet;

constexpr int kMinBlocksPerSM = 2;
constexpr int kPartFloats = kMaxHeads;   // a long row's partial d_a_i

struct Params {
  const float* xp;          // [n, hc]
  const float* a_i;         // [n, heads]
  const float* a_j;         // [n, heads]
  const float* edge_attr;   // [E, fe]
  const float* we;          // [fe, hc]
  const float* wemat;       // [hc, heads]
  const int* rowptr;        // [n + 1]
  const int* snd;           // [slots]
  const int* eid;           // [slots], [0, rowptr[n]) a permutation
  const float* out;         // [n, hc], the forward's
  const float* row_max;     // [n, heads]
  const float* row_inv;     // [n, heads]
  const float* g;           // [n, hc]
  float* d_xpe;             // [E, hc], each edge's term of d_xp
  float* d_eh;              // [E, hc]
  float* d_pre;             // [E, heads]
  float* d_a_i;             // [n, heads]
  float* part;              // [chunks, 2, kPartFloats]
  int* tickets;             // [chunks], zero on entry and on exit
  int n, slots, edges, hc, heads, channels, fe, slot_blocks;
  float slope;
};

// Shared memory floats: We [fe, hc], wemat [hc, heads] and Wf [fe, heads]
// for the block, then per warp the chunk's edge features [32, fe], alpha
// [32, heads] and raw logits [32, heads].
__host__ __device__ inline size_t smem_floats(int hc, int heads, int fe) {
  return (size_t)fe * hc + (size_t)hc * heads + up4(fe * heads) +
         (size_t)kWarps * kChunk * (fe + 2 * heads);
}

// (dpre @ wemat^T)[j] for channel j
template <int MAXH>
__device__ __forceinline__ float wemat_term(const float* wm_s, int j,
                                            int heads,
                                            const float (&dpre)[MAXH]) {
  float d = 0.f;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < heads) d = fmaf(dpre[h], wm_s[j * heads + h], d);
  }
  return d;
}
template <int MAXH>
__device__ __forceinline__ void add_wemat(float4& d, int j0, const float* wm_s,
                                          int heads,
                                          const float (&dpre)[MAXH]) {
  d.x += wemat_term(wm_s, j0, heads, dpre);
  d.y += wemat_term(wm_s, j0 + 1, heads, dpre);
  d.z += wemat_term(wm_s, j0 + 2, heads, dpre);
  d.w += wemat_term(wm_s, j0 + 3, heads, dpre);
}
template <int MAXH>
__device__ __forceinline__ void add_wemat(float& d, int j0, const float* wm_s,
                                          int heads,
                                          const float (&dpre)[MAXH]) {
  d += wemat_term(wm_s, j0, heads, dpre);
}

// Row r's g on this lane's groups, and D = <g[r], out[r]> per head (all
// lanes).
template <int W, int VPL, int MAXH>
__device__ __forceinline__ void row_terms(const Params& q, int r,
                                          const Groups<VPL>& gr, int lane,
                                          typename Vec<W>::T (&gv)[VPL],
                                          float (&D)[MAXH]) {
  using T = typename Vec<W>::T;
  const int groups = q.hc / W;
  const T* gp = reinterpret_cast<const T*>(q.g) + (size_t)r * groups;
  const T* op = reinterpret_cast<const T*>(q.out) + (size_t)r * groups;
  T ov[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    gv[v] = gr.ok[v] ? __ldg(gp + lane + kWarp * v) : zero<T>();
    ov[v] = gr.ok[v] ? __ldg(op + lane + kWarp * v) : zero<T>();
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) D[h] = 0.f;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const float d = dot4(gv[v], ov[v]);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h == gr.head[v]) D[h] += d;
    }
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < q.heads) D[h] = warp_sum(D[h]);
  }
}

// This lane's raw logits into pr_row and its alpha into al_row, from its
// row's statistics.
template <int MAXH>
__device__ __forceinline__ void edge_alpha(const float (&x)[MAXH],
                                           const float (&mx)[MAXH],
                                           const float (&inv)[MAXH],
                                           int heads, float slope,
                                           float* pr_row, float* al_row) {
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < heads) {
      pr_row[h] = x[h];
      al_row[h] = expf(leaky(x[h], slope) - mx[h]) * inv[h];
    }
  }
}

// The chunk's slots [ta, tb) of one row (its g on this lane's groups, D
// per head): writes d_xpe, d_eh and d_pre and adds each edge's
// dpre to dai.  The senders' rows gathered U at a time (the first U
// already in xs if `preloaded`).
template <int W, int VPL, int MAXH, int U>
__device__ __forceinline__ void walk(
    const Params& q, int my_snd, int my_e, int ta, int tb, bool preloaded,
    const float* ea_s, const float* al_s, const float* pr_s,
    const float* we_s, const float* wm_s, const Groups<VPL>& gr, int lane,
    const typename Vec<W>::T (&gv)[VPL], const float (&D)[MAXH],
    typename Vec<W>::T (&xs)[U][VPL], float (&dai)[MAXH]) {
  using T = typename Vec<W>::T;
  const int groups = q.hc / W, H = q.heads, fe = q.fe, hc = q.hc;
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
      edge_proj<W, VPL>(ea_s + t * fe, we_s, hc, fe, gr, lane, eh);
      float dal[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) dal[h] = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const float d = dot4(mul(eh[v], xs[u][v]), gv[v]);
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          if (h == gr.head[v]) dal[h] += d;
        }
      }
      const float* al = al_s + t * H;
      const float* pr = pr_s + t * H;
      float dpre[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        dpre[h] = 0.f;
        if (h < H) {
          dal[h] = warp_sum(dal[h]);
          dpre[h] = al[h] * (dal[h] - D[h]) * (pr[h] >= 0.f ? 1.f : q.slope);
          dai[h] += dpre[h];
        }
      }
      const int e = __shfl_sync(kFull, my_e, t);
      T* dxe = reinterpret_cast<T*>(q.d_xpe + (size_t)e * hc);
      T* deh = reinterpret_cast<T*>(q.d_eh + (size_t)e * hc);
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (!gr.ok[v]) continue;
        const int gi = lane + kWarp * v;
        const float a = al[gr.head[v]];
        dxe[gi] = a * mul(gv[v], eh[v]);
        T d = a * mul(gv[v], xs[u][v]);
        add_wemat<MAXH>(d, gi * W, wm_s, H, dpre);
        deh[gi] = d;
      }
      if (lane < H) q.d_pre[(size_t)e * H + lane] = at_head(dpre, lane);
    }
  }
}

// Zeros for the padded edges' rows of d_eh and d_pre (not d_xpe, which
// no sum reads there): this row block's share of [rowptr[n], edges).
template <int W>
__device__ __forceinline__ void zero_padded_edges(const Params& q) {
  using T = typename Vec<W>::T;
  const int real = __ldg(q.rowptr + q.n);
  const int tail = q.edges - real;
  if (tail <= 0) return;
  const int row_blocks = gridDim.x - q.slot_blocks;
  const int b = blockIdx.x - q.slot_blocks;
  const int per = (tail + row_blocks - 1) / row_blocks;
  const int e0 = real + min(tail, b * per);
  const int e1 = real + min(tail, (b + 1) * per);
  const int groups = q.hc / W;
  T* d = reinterpret_cast<T*>(q.d_eh) + (size_t)e0 * groups;
  for (int i = threadIdx.x; i < (e1 - e0) * groups; i += blockDim.x) {
    d[i] = zero<T>();
  }
  for (int i = threadIdx.x; i < (e1 - e0) * q.heads; i += blockDim.x) {
    q.d_pre[(size_t)e0 * q.heads + i] = 0.f;
  }
}

// A slot block: the slots of rows of more than 32 edges in each warp's
// chunk; each such row's partial d_a_i goes to q.part, and the warp that
// takes the row's last ticket sums them in CSR order.
template <int W, int VPL, int MAXH>
__device__ __forceinline__ void long_rows(const Params& q, float* we_s,
                                          float* wm_s, float* wf_s,
                                          float* ea_s, float* al_s,
                                          float* pr_s, const Groups<VPL>& gr,
                                          int lane, int warp) {
  using T = typename Vec<W>::T;
  constexpr int U = Unroll<VPL>::value;
  const int H = q.heads, hc = q.hc, fe = q.fe;
  const int c0 = (blockIdx.x * kWarps + warp) * kChunk;
  const int cnt = max(0, min(kChunk, __ldg(q.rowptr + q.n) - c0));
  stage_weights(q.we, q.wemat, hc, H, fe, we_s, wf_s, wm_s);
  SlotRow me{0, 0, 0};
  bool lng = false;
  if (cnt > 0) {                                   // warp-uniform
    me = slot_rows(q.rowptr, q.n, c0, cnt, lane);
    lng = lane < cnt && me.end - me.beg > kChunk;
  }
  const unsigned longs = __ballot_sync(kFull, lng);
  if (!__syncthreads_or(longs != 0)) return;       // block-uniform
  int s = 0, e = 0;
  float ai[MAXH], aj[MAXH], mx[MAXH], inv[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    const bool ok = lng && h < H;
    const size_t i = (size_t)me.row * H + h;
    ai[h] = ok ? __ldg(q.a_i + i) : 0.f;
    mx[h] = ok ? __ldg(q.row_max + i) : 0.f;
    inv[h] = ok ? __ldg(q.row_inv + i) : 0.f;
    aj[h] = 0.f;
  }
  if (lng) {
    s = __ldg(q.snd + c0 + lane);
    e = __ldg(q.eid + c0 + lane);
    load_edge<MAXH>(q.edge_attr, q.a_j, s, e, H, fe, ea_s + lane * fe, aj);
  }
  __syncthreads();
  if (longs == 0) return;
  if (lng) {
    float x[MAXH];
    raw_logits<MAXH>(ea_s + lane * fe, wf_s, H, fe, ai, aj, x);
    edge_alpha<MAXH>(x, mx, inv, H, q.slope, pr_s + lane * H,
                     al_s + lane * H);
  }
  __syncwarp();
  for (unsigned rest = longs; rest != 0;) {        // at most two rows
    const LongRow lr = next_long_row(me, rest);
    T gv[VPL], xs[U][VPL];
    float D[MAXH], dai[MAXH];
    row_terms<W, VPL, MAXH>(q, lr.row, gr, lane, gv, D);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) dai[h] = 0.f;
    walk<W, VPL, MAXH, U>(q, s, e, lr.ta, lr.tb, false, ea_s, al_s, pr_s,
                          we_s, wm_s, gr, lane, gv, D, xs, dai);
    float* pt = q.part + part_slot(lr, c0) * kPartFloats;
    if (lane < H) pt[lane] = at_head(dai, lane);
    if (last_ticket(q.tickets, lr, lane)) {
      // sum the row's parts in CSR order, a lane per head
      const int bf = lr.beg / kChunk, bl = (lr.end - 1) / kChunk;
      if (lane < H) {
        float sum = 0.f;
#pragma unroll 4
        for (int k = bf; k <= bl; ++k) {
          sum += __ldcg(q.part + ((size_t)k * 2 + (k == bf ? 1 : 0)) *
                                     kPartFloats + lane);
        }
        q.d_a_i[(size_t)lr.row * H + lane] = sum;
      }
      if (lane == 0) q.tickets[bf] = 0;
    }
    rest &= ~lr.mask;
    __syncwarp();
  }
}

// W: channels per group (4 or 1); VPL: groups per lane; MAXH: most heads.
template <int W, int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
bwd_kernel(const Params q) {
  using T = typename Vec<W>::T;
  constexpr int U = Unroll<VPL>::value;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int H = q.heads, hc = q.hc, fe = q.fe, groups = hc / W;
  float* we_s = smem;                                  // [fe, hc]
  float* wm_s = we_s + fe * hc;                        // [hc, heads]
  float* wf_s = wm_s + hc * H;                         // [fe, heads]
  float* ea_s = wf_s + up4(fe * H) + warp * kChunk * (fe + 2 * H);
  float* al_s = ea_s + kChunk * fe;                    // [32, heads]
  float* pr_s = al_s + kChunk * H;                     // [32, heads]
  const Groups<VPL> gr(lane, groups, q.channels / W);
  if ((int)blockIdx.x < q.slot_blocks) {
    long_rows<W, VPL, MAXH>(q, we_s, wm_s, wf_s, ea_s, al_s, pr_s, gr, lane,
                            warp);
    return;
  }

  // a row block: rows r0 .. r1 - 1, one a warp
  zero_padded_edges<W>(q);
  const int r0 = ((int)blockIdx.x - q.slot_blocks) * kWarps;
  const int r1 = min(r0 + kWarps, q.n);
  if (__ldg(q.rowptr + r0) == __ldg(q.rowptr + r1)) {   // block-uniform
    for (int i = threadIdx.x; i < (r1 - r0) * H; i += blockDim.x) {
      q.d_a_i[(size_t)r0 * H + i] = 0.f;
    }
    return;
  }
  const int r = r0 + warp;
  int beg = 0, end = 0;
  if (r < r1) {
    beg = __ldg(q.rowptr + r);
    end = __ldg(q.rowptr + r + 1);
  }
  // the weights' loads in flight beside the row pointers'
  stage_weights(q.we, q.wemat, hc, H, fe, we_s, wf_s, wm_s);
  const int len = end - beg;
  const bool whole = len > 0 && len <= kChunk;         // warp-uniform
  const bool in = whole && lane < len;
  int s = 0, e = 0;
  float ai[MAXH], aj[MAXH], mx[MAXH], inv[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    const bool ok = whole && h < H;
    const size_t i = (size_t)r * H + h;
    ai[h] = ok ? __ldg(q.a_i + i) : 0.f;
    mx[h] = ok ? __ldg(q.row_max + i) : 0.f;
    inv[h] = ok ? __ldg(q.row_inv + i) : 0.f;
    aj[h] = 0.f;
  }
  if (in) {
    s = __ldg(q.snd + beg + lane);
    e = __ldg(q.eid + beg + lane);
    load_edge<MAXH>(q.edge_attr, q.a_j, s, e, H, fe, ea_s + lane * fe, aj);
  }
  T xs[U][VPL], gv[VPL];
  float D[MAXH];
  if (whole) {
    gather_rows<W, VPL, U>(reinterpret_cast<const T*>(q.xp), groups, s, 0,
                           len, gr, lane, xs);
    row_terms<W, VPL, MAXH>(q, r, gr, lane, gv, D);
  }
  __syncthreads();
  if (r >= r1 || len > kChunk) return;                 // long: slot blocks
  float dai[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) dai[h] = 0.f;
  if (whole) {
    if (in) {
      float x[MAXH];
      raw_logits<MAXH>(ea_s + lane * fe, wf_s, H, fe, ai, aj, x);
      edge_alpha<MAXH>(x, mx, inv, H, q.slope, pr_s + lane * H,
                       al_s + lane * H);
    }
    __syncwarp();
    walk<W, VPL, MAXH, U>(q, s, e, 0, len, true, ea_s, al_s, pr_s, we_s,
                          wm_s, gr, lane, gv, D, xs, dai);
  }
  if (lane < H) q.d_a_i[(size_t)r * H + lane] = at_head(dai, lane);
}

template <int W, int VPL, int MAXH>
struct Make {
  static void (*get())(const Params) { return bwd_kernel<W, VPL, MAXH>; }
};

}  // namespace

extern "C" {

int triplet_bwd_max_hc() { return kMaxHC; }
int triplet_bwd_max_heads() { return kMaxHeads; }
int triplet_bwd_max_fe() { return kMaxFe; }
long long triplet_bwd_smem_bytes(int hc, int heads, int fe) {
  return (long long)(sizeof(float) * smem_floats(hc, heads, fe));
}

// Pointers are device pointers; `stream` is a cudaStream_t.  n >= 1,
// rowptr[n] <= slots <= edges, and eid's first rowptr[n] slots a
// permutation of [0, rowptr[n]); the slots past rowptr[n] are not read.  The
// kernel writes every row of d_eh, d_pre and d_a_i, and of d_xpe the real
// edges' rows [0, rowptr[n]).
// With chunks = ceil(slots / 32): part holds chunks * 2 * 8 floats and
// tickets `chunks` ints that are zero (and are zero again when the kernel
// ends).  vec = 1 allows float4 channel groups: C % 4 == 0 and xp, g, out,
// d_xpe and d_eh 16-byte aligned.
int triplet_bwd(const float* xp, const float* a_i, const float* a_j,
                const float* edge_attr, const float* we, const float* wemat,
                const int* rowptr, const int* snd, const int* eid,
                const float* out, const float* row_max, const float* row_inv,
                const float* g, float* d_xpe, float* d_eh, float* d_pre,
                float* d_a_i, float* part, int* tickets, int n, int slots,
                int edges, int hc, int heads, int channels, int fe,
                float slope, int vec, void* stream) {
  const auto kernel = pick<Make>(hc, heads, channels, vec);
  if (kernel == nullptr || n < 1 || slots < 0 || slots > edges || fe < 0 ||
      fe > kMaxFe) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = sizeof(float) * smem_floats(hc, heads, fe);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slot_blocks = (slots + kThreads - 1) / kThreads;
  const Params q{xp,    a_i,     a_j,     edge_attr, we,      wemat,
                 rowptr, snd,    eid,     out,       row_max, row_inv,
                 g,     d_xpe,   d_eh,    d_pre,     d_a_i,   part,
                 tickets, n,     slots,   edges,     hc,      heads,
                 channels, fe,   slot_blocks, slope};
  const int blocks = slot_blocks + (n + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
