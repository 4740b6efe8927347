// Fixed-order segment sum over a CSR for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package sums segments with XLA
// (`jax.ops.segment_sum`, glam_tpu/ops/segment.py:21-23), whose order is
// fixed by the compiled program, so a training run repeats itself bit for
// bit.  On the card `index_add_` sums with float atomics in the order its
// entries land, which changes from call to call; the port's sums over
// nodes by graph, over edges by receiver or sender, the backward of every
// gather and kernel B's d_xp and d_a_j come here instead.  For every
// segment s of a CSR over `slots` entries, with n = min(rowptr[S], limit)
// (limit: one int on the device, or none),
//
//   out[s] = sum_{k = min(rowptr[s], n)}^{min(rowptr[s+1], n)-1} x[perm[k]]
//
// (perm null: the identity), in an order that depends only on the row
// pointers, n and C, with float32 accumulation for bfloat16 and float16
// rows and one rounding at the end.  Every output row is written, so an
// empty segment gives 0 and the caller needs no fill.  Slots at or past n
// are not read: kernel B's sums stop at the real edges, past which the
// sender CSR lists only the padded ones.
//
// Bound.  One add per element read: bytes bound it (each listed row of x
// read once, each output row written once).  At the trainer's shapes (a
// few thousand entries) a call is one launch and a chain of dependent
// loads; the design keeps that chain short.
//
// Design.  One launch of blocks of 8 warps in clusters of 8 (Hopper's
// thread-block clusters: the blocks of a cluster run at once and write
// each other's shared memory), two kinds of clusters:
//  - row clusters (the last of the grid): warp w of row block b owns
//    segment 8 b + w if it has at most kMed = 64 entries, and walks it
//    whole: at most 32 entries in one pass, as the kernel always did (the
//    same adds, so the same bits), 33-64 in streams (below).  A block
//    whose 8 segments are all empty (the padding nodes' rows of a sender
//    CSR) writes their zeros with coalesced stores;
//  - slot clusters (the first): a longer segment is cut into m =
//    ceil(len / kSpan) pieces of equal length (at most kSpan = 4,096
//    entries: two 32-slot chunks for each of the cluster's 64 warps, one
//    up to 2,048), and each piece is summed by one cluster.  Which: probe
//    slots lie every 64 slots (63, 127, ...); every piece, being longer
//    than 64, holds one, and the cluster whose window (32 probes) holds
//    the piece's first probe takes it, found by one warp search of the
//    probe's row (csr_common.cuh) a probe, all at once.  A piece of at
//    most 256 entries (512 for C <= 8) stays with the block that found
//    it, which sums it alone after the cluster's pieces.  Each block
//    writes its other probes' pieces into every block's list (distributed
//    shared memory) and one cluster.sync() publishes them; then, piece by
//    piece: warp q of the cluster sums its chunks, each block its 8
//    warps' partials in warp order, writing the sum into rank 0's shared
//    memory, and after cluster.sync() rank 0 adds the 8 blocks' rows in
//    rank order.  No global scratch, fence or ticket: a cluster whose
//    window holds no piece is done after its one cluster.sync().  A
//    segment of more than kSpan entries (a serving batch's padding row of
//    44,096) has m > 1 pieces: rank 0 of each writes its piece's sum to
//    global scratch, and the one that takes the segment's last ticket
//    adds the m sums in piece order.  Only this level uses tickets; they
//    are zero on entry and put back to zero, so the buffer needs no fill.
//    Each such merge adds one to a device counter that the host reads
//    (segment_sum_csr_ticket_merges): the level is observed, not inferred.
// Within a chunk the order is fixed by the width C:
//  - C > 8: lanes over channels (float4 groups where C % 4 == 0 and the
//    rows are aligned), each lane adding the chunk's entries in CSR order
//    (8 float4 loads or 16 float loads in flight, then their adds in
//    order: the loads in flight do not change the order of the adds);
//    in a piece or a row of 33-64 entries, where a pass holds fewer than
//    32 groups, the lanes form 32 / L streams of L lanes, each adding
//    every (32 / L)-th entry, then a butterfly adds the streams;
//  - C <= 8 (PairNorm's and LayerNorm's row sums, node counts, per-head
//    logits): lanes over entries, one entry a lane, then a butterfly of
//    xor shuffles.  Each step adds two lanes' values, a + b on one lane and
//    b + a on the other, which IEEE addition makes equal, so every lane
//    ends with the same bits and the order depends only on the offsets.
// So the order of the adds depends on the row pointers, n and C alone:
// not on which block finishes first, on the grid or on the SM count.
//
// Interface: plain C, loaded with ctypes.  The launch (cudaLaunchKernelEx
// with a cluster dimension; no fallback) returns cudaGetLastError(); the
// caller raises if it is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "csr_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace csr;

constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kMinBlocks = 3;       // resident blocks an SM (registers)
constexpr int kCluster = 8;                     // blocks a cluster
constexpr int kEntryC = 8;          // widths summed with lanes over entries
constexpr int kInFlight = 8;        // loads a lane issues before its adds
// ... for rows of W channels a group: 8 float4 or 16 floats (one-lane
// rows, C % 4 != 0 or not float32: twice the loads in the same registers)
template <int W>
__host__ __device__ constexpr int in_flight() {
  return W == 1 ? 2 * kInFlight : kInFlight;
}
constexpr int kMed = 2 * kChunk;    // longest segment a row warp walks
constexpr int kProbe = kMed;        // slots between probes
constexpr int kPerWarp = 2;         // a piece's most chunks a warp
constexpr int kSpan = kCluster * kWarps * kPerWarp * kChunk;   // 4,096
// the longest piece its finding block sums alone: 256 slots, a chunk a
// warp, or 512 where lanes take entries (C <= kEntryC: two loads a lane)
constexpr int kBlockSpan = kWarps * kChunk;
constexpr int kBlockSpanEntry = kPerWarp * kBlockSpan;
constexpr int kBlockSlots = kThreads;               // a slot block's window
constexpr int kBlockProbes = kBlockSlots / kProbe;  // 4
constexpr int kClusterProbes = kCluster * kBlockProbes;  // 32
constexpr int kTile = 512;          // channels a piece's pass sums
static_assert(kBlockProbes <= kWarps, "a warp a probe");
static_assert(kClusterProbes <= kWarp, "one ballot holds the pieces");
static_assert(kProbe <= kMed + 1, "every piece holds a probe");
// a piece of a segment cut in m > 1 holds at least kSpan / 2 slots, so
// it is never one that a block sums alone (straight into the output row)
static_assert(kBlockSpanEntry < kSpan / 2 && kBlockSpan < kSpan / 2,
              "a split segment's pieces are never block pieces");

// Segments merged at the global level (a ticket's last holder adding the
// pieces' sums) since the host last read it: what the caller observes of
// that level (segment_sum_csr_ticket_merges).
__device__ unsigned long long ticket_merges;

struct Params {
  const void* x;        // [rows of x, channels] of the element type
  const int* rowptr;    // [segments + 1]
  const int* perm;      // [slots] or null (the identity)
  const int* limit;     // [1] or null: the slots read end there
  void* out;            // [segments, channels] of the element type
  float* part;          // [probes, channels]: long segments' pieces' sums
  int* tickets;         // [probes], zero on entry and on exit
  int segments, slots, channels, slot_blocks;
};

// A piece of a long segment: its row, its slots [ps, pe), and the
// segment's first slot, its slots read and its pieces (piece j holds
// [beg + j len / m, beg + (j + 1) len / m)).
struct Piece {
  int row, ps, pe, beg, len, m;
};

__device__ __forceinline__ int piece_start(const Piece& pc, int j) {
  return pc.beg + (int)((long long)j * pc.len / pc.m);
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ void acc_add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void acc_add(float& a, float b) { a += b; }

// Channel group g (W channels) of row i of x, as floats.
template <typename T, int W>
struct Rows;
template <typename T>
struct Rows<T, 1> {
  using V = float;
  __device__ __forceinline__ static V load(const T* x, size_t i, int C,
                                           int g) {
    return to_f<T>(x[i * C + g]);
  }
  __device__ __forceinline__ static void store(T* out, size_t r, int C, int g,
                                               V v) {
    out[r * C + g] = from_f<T>(v);
  }
  __device__ __forceinline__ static void put(float* p, int g, V v) {
    p[g] = v;
  }
};
template <>
struct Rows<float, 4> {
  using V = float4;
  __device__ __forceinline__ static V load(const float* x, size_t i, int C,
                                           int g) {
    return __ldg(reinterpret_cast<const float4*>(x + i * C) + g);
  }
  __device__ __forceinline__ static void store(float* out, size_t r, int C,
                                               int g, V v) {
    reinterpret_cast<float4*>(out + r * C)[g] = v;
  }
  __device__ __forceinline__ static void put(float* p, int g, V v) {
    reinterpret_cast<float4*>(p)[g] = v;
  }
};

__device__ __forceinline__ void zero_v(float& v) { v = 0.f; }
__device__ __forceinline__ void zero_v(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Entry index of slot k (held by its lane).
__device__ __forceinline__ int entry(const Params& q, int k) {
  return q.perm != nullptr ? __ldg(q.perm + k) : k;
}

// The slots read: rowptr[segments], or the limit where it is smaller.
__device__ __forceinline__ int listed(const Params& q) {
  const int n = __ldg(q.rowptr + q.segments);
  return q.limit != nullptr ? min(n, __ldg(q.limit)) : n;
}

// Lanes over channels: adds to `acc` (channel group g of this lane; `ok`
// whether it exists), in slot order, the entries that lanes 0..tb-1 hold
// in `my`.  Warp-uniform tb.
template <typename T, int W>
__device__ __forceinline__ void add_entries(const Params& q, int my, int tb,
                                            int g, bool ok,
                                            typename Rows<T, W>::V& acc) {
  using R = Rows<T, W>;
  using V = typename R::V;
  const T* x = static_cast<const T*>(q.x);
  const int C = q.channels;
  constexpr int F = in_flight<W>();
  int t = 0;
  for (; t + F <= tb; t += F) {                   // the loads in flight,
    V v[F];                                       // then the adds in order
#pragma unroll
    for (int u = 0; u < F; ++u) {
      const int i = __shfl_sync(kFull, my, t + u);
      if (ok) v[u] = R::load(x, i, C, g);
    }
#pragma unroll
    for (int u = 0; u < F; ++u) {
      if (ok) acc_add(acc, v[u]);
    }
  }
  for (; t < tb; ++t) {
    const int i = __shfl_sync(kFull, my, t);
    if (ok) acc_add(acc, R::load(x, i, C, g));
  }
}

// Lanes over entries (C <= kEntryC): the sum of the entries that the lanes
// hold in my0 (where in0) and my1 (where in1), per channel, the same on
// every lane.
template <typename T>
__device__ __forceinline__ void sum_entries(const Params& q, int my0,
                                            bool in0, int my1, bool in1,
                                            float (&acc)[kEntryC]) {
  const T* x = static_cast<const T*>(q.x);
  const int C = q.channels;
#pragma unroll
  for (int c = 0; c < kEntryC; ++c) {
    acc[c] = (in0 && c < C) ? to_f<T>(x[(size_t)my0 * C + c]) : 0.f;
    if (in1 && c < C) acc[c] += to_f<T>(x[(size_t)my1 * C + c]);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kEntryC; ++c) {
      if (c < C) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
    }
  }
}

__device__ __forceinline__ float at(const float (&a)[kEntryC], int c) {
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < kEntryC; ++k) {
    if (k == c) r = a[k];
  }
  return r;
}

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(kFull, v, off);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int off) {
  return make_float4(__shfl_xor_sync(kFull, v.x, off),
                     __shfl_xor_sync(kFull, v.y, off),
                     __shfl_xor_sync(kFull, v.z, off),
                     __shfl_xor_sync(kFull, v.w, off));
}

// Adds to `acc`, in slot order, stream s's entries of the tb that the
// lanes hold in `my`: entries s, s + S, s + 2 S, ... (warp-uniform tb).
template <typename T, int W>
__device__ __forceinline__ void add_stream(const Params& q, int my, int tb,
                                           int s, int S, int g, bool ok,
                                           typename Rows<T, W>::V& acc) {
  using R = Rows<T, W>;
  using V = typename R::V;
  const T* x = static_cast<const T*>(q.x);
  constexpr int F = in_flight<W>();
  for (int t0 = 0; t0 < tb; t0 += S * F) {          // loads, then adds
    V v[F];
#pragma unroll
    for (int u = 0; u < F; ++u) {
      const int t = t0 + s + u * S;
      const int i = __shfl_sync(kFull, my, t & (kWarp - 1));
      zero_v(v[u]);
      if (ok && t < tb) v[u] = R::load(x, i, q.channels, g);
    }
#pragma unroll
    for (int u = 0; u < F; ++u) {
      if (t0 + s + u * S < tb) acc_add(acc, v[u]);
    }
  }
}

// Lanes over channels, for a piece's warp or a row of 33-64 entries:
// channel groups [gb, ge) of the entries the lanes hold in my0 (n0 of
// them) and my1 (n1).  Where a pass
// takes fewer than 32 groups, the warp's lanes form S = 32 / L streams
// of L lanes (L the groups rounded up to a power of two), each adding
// every S-th entry, and a butterfly of xor shuffles adds the streams
// (a + b and b + a alike, so every stream ends with the same bits);
// each group's sum goes to put(g - gb, v).
template <typename T, int W, typename Put>
__device__ __forceinline__ void walk_streams(const Params& q, int my0,
                                             int n0, int my1, int n1,
                                             int gb, int ge, int lane,
                                             Put put) {
  using V = typename Rows<T, W>::V;
  int L = 1;
  while (L < ge - gb && L < kWarp) L <<= 1;
  const int S = kWarp / L, s = lane / L;
  for (int g0 = gb; g0 < ge; g0 += L) {
    const int g = g0 + lane % L;
    const bool ok = g < ge;
    V acc;
    zero_v(acc);
    add_stream<T, W>(q, my0, n0, s, S, g, ok, acc);
    if (n1 > 0) add_stream<T, W>(q, my1, n1, s, S, g, ok, acc);
    for (int off = kWarp / 2; off >= L; off >>= 1) {
      acc_add(acc, shfl_xor(acc, off));
    }
    if (ok && s == 0) put(g - gb, acc);
  }
}

// A row warp: segment r, slots [beg, end) with end - beg <= kMed, walked
// whole (two 32-slot chunks at most) into its output row.
template <typename T, int W, bool ENTRY>
__device__ __forceinline__ void walk_row(const Params& q, int r, int beg,
                                         int end, int lane) {
  using R = Rows<T, W>;
  using V = typename R::V;
  T* out = static_cast<T*>(q.out);
  const int C = q.channels;
  const int n0 = min(end - beg, kChunk), n1 = end - beg - n0;
  const int my0 = lane < n0 ? entry(q, beg + lane) : 0;
  const int my1 = lane < n1 ? entry(q, beg + kChunk + lane) : 0;
  if (ENTRY) {
    float acc[kEntryC];
    sum_entries<T>(q, my0, lane < n0, my1, lane < n1, acc);
    if (lane < C) out[(size_t)r * C + lane] = from_f<T>(at(acc, lane));
    return;
  }
  const int groups = C / W;
  if (n1 > 0) {                          // 33-64 entries: in streams
    walk_streams<T, W>(q, my0, n0, my1, n1, 0, groups, lane,
                       [&](int g, V v) { R::store(out, r, C, g, v); });
    return;
  }
  for (int g0 = 0; g0 < groups; g0 += kWarp) {
    const int g = g0 + lane;
    const bool ok = g < groups;
    V acc;
    zero_v(acc);
    add_entries<T, W>(q, my0, n0, g, ok, acc);
    if (ok) R::store(out, r, C, g, acc);
  }
}

// A row block: segments 8 b .. 8 b + 7, one a warp; those of more than
// kMed slots are the slot clusters'.
template <typename T, int W, bool ENTRY>
__device__ __forceinline__ void row_block(const Params& q, int b, int n,
                                          int lane, int warp) {
  const int C = q.channels;
  const int r0 = b * kWarps;
  if (r0 >= q.segments) return;                      // the grid's rounding
  const int r1 = min(r0 + kWarps, q.segments);
  if (min(__ldg(q.rowptr + r0), n) == min(__ldg(q.rowptr + r1), n)) {
    T* out = static_cast<T*>(q.out);                 // block-uniform
    const T z = from_f<T>(0.f);
    for (int i = threadIdx.x; i < (r1 - r0) * C; i += blockDim.x) {
      out[(size_t)r0 * C + i] = z;
    }
    return;
  }
  const int r = r0 + warp;
  if (r >= r1) return;
  const int beg = min(__ldg(q.rowptr + r), n);
  const int end = min(__ldg(q.rowptr + r + 1), n);
  if (end - beg > kMed) return;                      // a slot cluster's
  walk_row<T, W, ENTRY>(q, r, beg, end, lane);
}

// The piece of a long segment whose first probe is slot p, if any: a
// whole warp's search of p's row (p < n).
__device__ __forceinline__ Piece probe(const Params& q, int p, int n,
                                       int lane) {
  Piece pc{-1, 0, 0, 0, 0, 0};
  if (p >= n || p < __ldg(q.rowptr)) return pc;
  const int r = warp_find_row(q.rowptr, q.segments, p, 0, lane);
  const int beg = __ldg(q.rowptr + r);
  const int end = min(__ldg(q.rowptr + r + 1), n);
  const int len = end - beg;
  if (len <= kMed) return pc;                        // a row warp's
  Piece seg{r, 0, 0, beg, len, (len + kSpan - 1) / kSpan};
  int j = (int)((long long)(p - beg) * seg.m / len);
  if (j + 1 < seg.m && piece_start(seg, j + 1) <= p) ++j;
  seg.ps = piece_start(seg, j);
  seg.pe = piece_start(seg, j + 1);
  return seg.ps > p - kProbe ? seg : pc;             // else an earlier probe's
}

// The chunks of a piece of `len` slots that each of the cluster's warps
// sums: 1 up to half the span, else 2 (consecutive).
__device__ __forceinline__ int per_warp(int len) {
  const int chunks = (len + kChunk - 1) / kChunk;
  return (chunks + kCluster * kWarps - 1) / (kCluster * kWarps);
}

// Cluster-wide: the sum of piece `pc` over the channel groups [gb, ge)
// (this warp's chunks: n0 and n1 slots whose entries the lanes hold in
// my0 and my1).  Each block adds its warps' partials in warp order and
// writes the result into rank 0's shared memory (`bpart`, one row a
// rank); after cluster.sync() rank 0 adds the ranks' rows in rank order
// and hands each channel c of [0, (ge - gb) W) to emit(c, sum).  The
// other blocks are then done with the piece: rank 0 reads only its own
// shared memory, and a later call first waits (cluster.sync()) until it
// has.  Every block of the cluster calls it alike.
template <typename T, int W, bool ENTRY, typename Emit>
__device__ __forceinline__ void sum_piece(const Params& q, const Piece& pc,
                                          int my0, int n0, int my1, int n1,
                                          int gb, int ge, bool again,
                                          float* wpart, float* bpart,
                                          cg::cluster_group& cluster,
                                          int lane, int warp, Emit emit) {
  using R = Rows<T, W>;
  const int tile = ENTRY ? q.channels : (ge - gb) * W;   // floats
  const int rank = (int)cluster.block_rank();
  const int per = per_warp(pc.pe - pc.ps);
  const int busy = (pc.pe - pc.ps + per * kChunk - 1) / (per * kChunk);
  const int warps_here = min(max(busy - rank * kWarps, 0), kWarps);
  const int ranks = (busy + kWarps - 1) / kWarps;
  float* mine = wpart + warp * tile;
  if (warp < warps_here) {
    if (ENTRY) {
      float acc[kEntryC];
      sum_entries<T>(q, my0, lane < n0, my1, lane < n1, acc);
      if (lane < q.channels) mine[lane] = at(acc, lane);
    } else {
      walk_streams<T, W>(q, my0, n0, my1, n1, gb, ge, lane,
                         [&](int g, typename R::V v) { R::put(mine, g, v); });
    }
  }
  __syncthreads();
  if (again) cluster.sync();           // rank 0 has read the last piece
  if (warps_here > 0) {
    float* dst = cluster.map_shared_rank(&bpart[0], 0) + rank * tile;
    for (int c = threadIdx.x; c < tile; c += blockDim.x) {   // warp order
      float s = 0.f;
      for (int w = 0; w < warps_here; ++w) s += wpart[w * tile + c];
      dst[c] = s;
    }
  }
  cluster.sync();
  if (rank != 0) return;
  for (int c = threadIdx.x; c < tile; c += blockDim.x) {     // rank order
    float s = 0.f;
    for (int k = 0; k < ranks; ++k) s += bpart[k * tile + c];
    emit(c, s);
  }
}

// A piece of at most kBlockSpan slots (kBlockSpanEntry for C <= 8),
// summed by the block that found it alone: warp w its chunks (one, or
// two past 256 slots), then the warps' partials in warp order.
template <typename T, int W, bool ENTRY>
__device__ __forceinline__ void block_piece(const Params& q, const Piece& pc,
                                            float* wpart, int lane,
                                            int warp) {
  using R = Rows<T, W>;
  T* out = static_cast<T*>(q.out);
  const int C = q.channels, groups = ENTRY ? 1 : C / W;
  const int tile_groups = ENTRY ? 1 : min(groups, kTile / W);
  const int len = pc.pe - pc.ps;
  const int per = (len + kWarps * kChunk - 1) / (kWarps * kChunk);
  const int c0 = pc.ps + warp * per * kChunk;
  const int n0 = max(min(pc.pe - c0, kChunk), 0);
  const int n1 = per > 1 ? max(min(pc.pe - c0 - kChunk, kChunk), 0) : 0;
  const int my0 = lane < n0 ? entry(q, c0 + lane) : 0;
  const int my1 = lane < n1 ? entry(q, c0 + kChunk + lane) : 0;
  const int warps = (len + per * kChunk - 1) / (per * kChunk);
#pragma unroll 1
  for (int gb = 0; gb < groups; gb += tile_groups) {
    const int ge = min(groups, gb + tile_groups);
    const int tile = ENTRY ? C : (ge - gb) * W, cb = gb * W;
    float* mine = wpart + warp * tile;
    if (n0 > 0) {
      if (ENTRY) {
        float acc[kEntryC];
        sum_entries<T>(q, my0, lane < n0, my1, lane < n1, acc);
        if (lane < C) mine[lane] = at(acc, lane);
      } else {
        walk_streams<T, W>(q, my0, n0, my1, n1, gb, ge, lane,
                           [&](int g, typename R::V v) { R::put(mine, g, v); });
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < tile; c += blockDim.x) {   // warp order
      float s = 0.f;
      for (int w = 0; w < warps; ++w) s += wpart[w * tile + c];
      out[(size_t)pc.row * C + cb + c] = from_f<T>(s);
    }
    __syncthreads();
  }
}

// A slot cluster: the pieces of long segments whose first probe lies in
// its window of kClusterProbes probes, one after another, then each
// block's pieces of at most kBlockSpan slots.  Every block of the cluster
// takes the same branches and the same cluster.sync()s.
template <typename T, int W, bool ENTRY>
__device__ __forceinline__ void slot_cluster(const Params& q, int n,
                                             int lane, int warp) {
  __shared__ Piece list[kClusterProbes];
  __shared__ Piece own[kBlockProbes];     // the pieces it sums alone
  __shared__ unsigned present;
  __shared__ int last;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = q.channels, groups = ENTRY ? 1 : C / W;
  const int tile_groups = ENTRY ? 1 : min(groups, kTile / W);
  const int tile = ENTRY ? kEntryC : tile_groups * W;
  float* wpart = smem;                                // [kWarps, tile]
  float* bpart = smem + kWarps * tile;                // [kCluster, tile]
  const int rank = (int)cluster.block_rank();
  // this block has started; the probes' searches overlap the other
  // blocks' start, which the wait below makes sure of before any block
  // writes into another's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  Piece found{-1, 0, 0, 0, 0, 0};
  if (warp < kBlockProbes) {
    found = probe(q, (blockIdx.x * kBlockProbes + warp + 1) * kProbe - 1,
                  n, lane);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // a piece one block sums stays with it; the others go into every
  // block's list
  const bool small =
      found.pe - found.ps <= (ENTRY ? kBlockSpanEntry : kBlockSpan);
  if (warp < kBlockProbes && lane == 0) {
    own[warp] = found;
    if (!small) own[warp].row = -1;
  }
  if (small) found.row = -1;
  if (warp < kBlockProbes && lane < kCluster) {
    *cluster.map_shared_rank(&list[rank * kBlockProbes + warp], lane) =
        found;
  }
  cluster.sync();
  if (warp == 0) {                        // the cluster's pieces, a bit each
    const bool has = lane < kClusterProbes && list[lane].row >= 0;
    const unsigned bits = __ballot_sync(kFull, has);
    if (lane == 0) present = bits;
  }
  __syncthreads();
  const unsigned pieces = present;                    // cluster-uniform
  T* out = static_cast<T*>(q.out);
  const int qw = rank * kWarps + warp;                // the cluster's warp
  bool again = false;
#pragma unroll 1
  for (unsigned rest = pieces; rest != 0; rest &= rest - 1) {
    const Piece pc = list[__ffs(rest) - 1];
    const int row = pc.row, m = pc.m;
    const int per = per_warp(pc.pe - pc.ps);
    const int c0 = pc.ps + qw * per * kChunk;
    const int n0 = max(min(pc.pe - c0, kChunk), 0);
    const int n1 = per > 1 ? max(min(pc.pe - c0 - kChunk, kChunk), 0) : 0;
    const int my0 = lane < n0 ? entry(q, c0 + lane) : 0;
    const int my1 = lane < n1 ? entry(q, c0 + kChunk + lane) : 0;
    float* sums = q.part + (size_t)(pc.ps / kProbe) * C;
#pragma unroll 1
    for (int gb = 0; gb < groups; gb += tile_groups) {
      const int ge = min(groups, gb + tile_groups);
      const int cb = gb * W;
      sum_piece<T, W, ENTRY>(
          q, pc, my0, n0, my1, n1, gb, ge, again, wpart, bpart, cluster,
          lane, warp, [&](int c, float v) {
            if (m == 1) {
              out[(size_t)row * C + cb + c] = from_f<T>(v);
            } else {
              sums[cb + c] = v;
            }
          });
      again = true;
    }
    if (m == 1 || rank != 0) continue;
    // a segment of m > 1 pieces: rank 0 of the cluster that takes its
    // last ticket adds the pieces' sums in piece order
    __threadfence();
    __syncthreads();
    int* ticket = q.tickets + pc.beg / kProbe;
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == m - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float s = 0.f;
        for (int j = 0; j < m; ++j) {
          s += __ldcg(q.part + (size_t)(piece_start(pc, j) / kProbe) * C + c);
        }
        out[(size_t)row * C + c] = from_f<T>(s);
      }
      if (threadIdx.x == 0) {
        *ticket = 0;
        atomicAdd(&ticket_merges, 1ull);
      }
    }
  }
#pragma unroll 1
  for (int w = 0; w < kBlockProbes; ++w) {
    const Piece pc = own[w];                          // block-uniform
    if (pc.row >= 0) block_piece<T, W, ENTRY>(q, pc, wpart, lane, warp);
  }
}

// W: channels per group (4: float4 rows, else 1); ENTRY: lanes over
// entries (C <= kEntryC).  The first slot_blocks blocks are the slot
// clusters (a whole number of clusters), the rest row blocks.
template <typename T, int W, bool ENTRY>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sum_kernel(const Params q) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n = listed(q);
  if ((int)blockIdx.x < q.slot_blocks) {
    // a cluster whose window starts at or past n has nothing to take
    // (cluster-uniform, so no block of it waits on a cluster.sync())
    const int first = (int)blockIdx.x / kCluster * kCluster * kBlockSlots;
    if (first < n) slot_cluster<T, W, ENTRY>(q, n, lane, warp);
    return;
  }
  row_block<T, W, ENTRY>(q, (int)blockIdx.x - q.slot_blocks, n, lane, warp);
}

using Kernel = void (*)(const Params);

template <typename T>
Kernel pick(int channels, bool vec) {
  if (channels <= kEntryC) return sum_kernel<T, 1, true>;
  if (vec && channels % 4 == 0) return sum_kernel<float, 4, false>;
  return sum_kernel<T, 1, false>;
}

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The launch's shape: (blocks, slot blocks, dynamic shared memory bytes).
void shape(int segments, int slots, int channels, int* blocks,
           int* slot_blocks, size_t* smem) {
  *slot_blocks = round_up((slots + kBlockSlots - 1) / kBlockSlots, kCluster);
  *blocks = *slot_blocks +
            round_up((segments + kWarps - 1) / kWarps, kCluster);
  const int tile = channels <= kEntryC ? kEntryC : min(channels, kTile);
  *smem = sizeof(float) * (size_t)(kWarps + kCluster) * tile;
}

}  // namespace

extern "C" {

int segment_sum_csr_entry_channels() { return kEntryC; }
int segment_sum_csr_cluster() { return kCluster; }
int segment_sum_csr_span() { return kSpan; }
int segment_sum_csr_probe() { return kProbe; }

// The launch a call makes: out[0] blocks, out[1] threads a block, out[2]
// the cluster's blocks, out[3] slot blocks, out[4] dynamic shared memory
// bytes, out[5] the most clusters of this shape the card runs at once
// (cudaOccupancyMaxActiveClusters).  Returns a cudaError_t.
int segment_sum_csr_launch_info(int segments, int slots, int channels,
                                int dtype, int vec, int* out) {
  Kernel kernel = nullptr;
  if (dtype == 0) kernel = pick<float>(channels, vec != 0);
  if (dtype == 1) kernel = pick<__nv_bfloat16>(channels, false);
  if (dtype == 2) kernel = pick<__half>(channels, false);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, slot_blocks = 0;
  size_t smem = 0;
  shape(segments, slots, channels, &blocks, &slot_blocks, &smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(kernel), &cfg);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = kCluster;
  out[3] = slot_blocks;
  out[4] = static_cast<int>(smem);
  out[5] = clusters;
  return static_cast<int>(err);
}

// The segments merged at the global level by this device's launches
// since the last call (counted by the kernels, on the device), into *out;
// the count starts again at 0.  Synchronous: not during a graph capture.
// Returns a cudaError_t.
int segment_sum_csr_ticket_merges(long long* out) {
  unsigned long long got = 0, zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(&got, ticket_merges, sizeof(got));
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(ticket_merges, &zero, sizeof(zero));
  }
  *out = static_cast<long long>(got);
  return static_cast<int>(err);
}

// Pointers are device pointers; `stream` is a cudaStream_t.  dtype: 0
// float32, 1 bfloat16, 2 float16 (x and out).  segments >= 1, channels >=
// 1, rowptr[segments] <= slots, where slots is perm's length (or, with a
// null perm, the rows of x); limit is null or one int: the slots at or
// past min(rowptr[segments], *limit) are not read.  With probes =
// slots / 64 + 1: part holds probes * channels floats and tickets `probes`
// ints that are zero (and are zero again when the kernel ends).  vec = 1
// allows float4 rows: float32, channels % 4 == 0 and x and out 16-byte
// aligned.  The kernel writes every row of out.
int segment_sum_csr(const void* x, const int* rowptr, const int* perm,
                    const int* limit, void* out, float* part, int* tickets,
                    int segments, int slots, int channels, int dtype,
                    int vec, void* stream) {
  if (segments < 1 || slots < 0 || channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Kernel kernel = nullptr;
  if (dtype == 0) kernel = pick<float>(channels, vec != 0);
  if (dtype == 1) kernel = pick<__nv_bfloat16>(channels, false);
  if (dtype == 2) kernel = pick<__half>(channels, false);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, slot_blocks = 0;
  size_t smem = 0;
  shape(segments, slots, channels, &blocks, &slot_blocks, &smem);
  const Params q{x,        rowptr, perm,     limit,    out,        part,
                 tickets,  segments, slots,  channels, slot_blocks};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
