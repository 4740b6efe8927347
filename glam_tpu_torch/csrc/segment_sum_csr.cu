// Fixed-order segment sum over a CSR for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package sums segments with XLA
// (`jax.ops.segment_sum`, glam_tpu/ops/segment.py:21-23), whose order is
// fixed by the compiled program, so a training run repeats itself bit for
// bit.  On the card `index_add_` sums with float atomics in the order its
// entries land, which changes from call to call; the port's sums over
// nodes by graph, over edges by receiver or sender, the backward of every
// gather and kernel B's d_xp and d_a_j come here instead.  For every
// segment s of a CSR over `slots` entries,
//
//   out[s] = sum_{k = rowptr[s]}^{rowptr[s+1]-1} x[perm[k]]     [S, C]
//
// (perm null: the identity), in an order that depends only on the row
// pointers, with float32 accumulation for bfloat16 and float16 rows and
// one rounding at the end.  Every output row is written, so an empty
// segment gives 0 and the caller needs no fill.
//
// Bound.  One add per element read: bytes bound it (each listed row of x
// read once, each output row written once).  At the trainer's shapes (a
// few thousand entries) it is one launch and a warp's chain of dependent
// loads.
//
// Design.  One launch, two kinds of blocks of 8 warps, as kernels A, B and
// C lay out their work (csr_common.cuh):
//  - row blocks (the last blocks of the grid): warp w of row block b owns
//    segment 8 b + w whole if it has at most 32 entries.  A block whose 8
//    segments are all empty (the padding nodes' rows of a sender CSR)
//    writes their zeros with coalesced stores;
//  - slot blocks (the first blocks): warp w of slot block b owns the 32
//    slots from 32 (8 b + w) and sums the slots of its chunk that belong
//    to segments of more than 32 entries (the padding graph's nodes, the
//    padding node's edges: thousands); each such segment leaves one
//    partial sum per chunk in global scratch, and the warp that takes the
//    last ticket of a group of 32 chunks adds theirs in chunk order, into
//    the output (a segment of at most 32 chunks) or into the group's
//    state, whose last ticket's warp adds the groups' states in order: a
//    44,096-entry row is 1,378 partials, merged 32 and then 44 at a time,
//    each merge's loads in flight together across the warp's lanes.
//    Tickets are zero on entry and are put back to zero, so the buffer
//    needs no fill.
// Within a chunk the order is fixed by the width C:
//  - C > 8: lanes over channels (float4 groups where C % 4 == 0 and the
//    rows are aligned), each lane adding the chunk's entries in CSR order;
//  - C <= 8 (PairNorm's and LayerNorm's row sums, node counts, per-head
//    logits): lanes over entries, one entry a lane, then a butterfly of
//    xor shuffles.  Each step adds two lanes' values, a + b on one lane and
//    b + a on the other, which IEEE addition makes equal, so every lane
//    ends with the same bits and the order depends only on the offsets.
//
// Interface: plain C, loaded with ctypes.  The launch returns
// cudaGetLastError(); the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "csr_common.cuh"

namespace {

using namespace csr;

constexpr int kWarps = 8;
constexpr int kThreads = kWarp * kWarps;
constexpr int kEntryC = 8;          // widths summed with lanes over entries
constexpr int kInFlight = 8;        // loads a lane issues before its adds
constexpr int kGroup = 32;          // a long segment's chunks merged at once

struct Params {
  const void* x;        // [rows of x, channels] of the element type
  const int* rowptr;    // [segments + 1]
  const int* perm;      // [slots] or null (the identity)
  void* out;            // [segments, channels] of the element type
  float* part;          // [chunks, 2, channels]: long segments' partials
  float* spart;         // [chunks, 2, channels]: their groups' states
  int* tickets;         // [3 chunks], zero on entry and on exit
  int segments, slots, channels, chunks, slot_blocks;
};

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
  __device__ __forceinline__ static V get(const float* p, int g) {
    return __ldcg(p + g);
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
  __device__ __forceinline__ static V get(const float* p, int g) {
    return __ldcg(reinterpret_cast<const float4*>(p) + g);
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

// Lanes over channels: the sum, in slot order, of the slots [c0 + ta,
// c0 + tb) whose entries lanes ta..tb-1 hold in `my`, over every channel
// group; each group's total handed to `emit(g, v)`.  Warp-uniform bounds.
template <typename T, int W, typename Emit>
__device__ __forceinline__ void walk_channels(const Params& q, int my, int ta,
                                              int tb, int lane, Emit emit) {
  using R = Rows<T, W>;
  using V = typename R::V;
  const T* x = static_cast<const T*>(q.x);
  const int C = q.channels, groups = C / W;
  for (int g0 = 0; g0 < groups; g0 += kWarp) {
    const int g = g0 + lane;
    const bool ok = g < groups;
    V acc;
    zero_v(acc);
    int t = ta;
    for (; t + kInFlight <= tb; t += kInFlight) {   // the loads in flight,
      V v[kInFlight];                               // then the adds in order
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = __shfl_sync(kFull, my, t + u);
        if (ok) v[u] = R::load(x, i, C, g);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (ok) acc_add(acc, v[u]);
      }
    }
    for (; t < tb; ++t) {
      const int i = __shfl_sync(kFull, my, t);
      if (ok) acc_add(acc, R::load(x, i, C, g));
    }
    if (ok) emit(g, acc);
  }
}

// Lanes over entries (C <= kEntryC): the sum of lanes ta..tb-1's entries,
// per channel, the same on every lane.
template <typename T>
__device__ __forceinline__ void sum_entries(const Params& q, int my, bool in,
                                            float (&acc)[kEntryC]) {
  const T* x = static_cast<const T*>(q.x);
  const int C = q.channels;
#pragma unroll
  for (int c = 0; c < kEntryC; ++c) {
    acc[c] = (in && c < C) ? to_f<T>(x[(size_t)my * C + c]) : 0.f;
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

// The sum of m partials of C floats (item i at addr(i)), handed to
// emit(g, sum) for every channel group g, in a fixed order.  Lanes are
// (r, j): lane j of each of the R = 32 / G2 lane groups takes channel group
// g0 + j (G2 = the groups of a pass rounded up to a power of two, at most
// 32) and the items r, r + R, ..., kInFlight loads in flight before their
// adds in order; then the R sums of each group meet in a butterfly over
// the lane bits above G2.
template <int W, typename Addr, typename Emit>
__device__ __forceinline__ void merge_list(int C, int m, int lane, Addr addr,
                                           Emit emit) {
  using R = Rows<float, W>;
  using V = typename R::V;
  const int groups = C / W;
  int G2 = 1;
  while (G2 < groups && G2 < kWarp) G2 <<= 1;
  const int lanes_r = kWarp / G2, r = lane / G2;
  for (int g0 = 0; g0 < groups; g0 += G2) {
    const int g = g0 + lane % G2;
    const bool ok = g < groups;
    V s;
    zero_v(s);
    for (int i0 = r; i0 < m; i0 += lanes_r * kInFlight) {
      V v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * lanes_r;
        zero_v(v[u]);
        if (ok && i < m) v[u] = R::get(addr(i), g);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) acc_add(s, v[u]);
    }
    for (int off = kWarp / 2; off >= G2; off >>= 1) {
      acc_add(s, shfl_xor(s, off));
    }
    if (ok && r == 0) emit(g, s);
  }
}

// After this warp wrote its partial of a long segment (chunk k of the
// segment's chunks bf..bl): its chunks are merged in groups of kGroup
// consecutive chunks, each by the warp that takes the group's last ticket
// (tickets[2 f + slot], f the group's first chunk, slot 1 for the group
// that holds bf), into the segment's output if one group holds them all,
// else into the group's state (spart, indexed like part); then the
// groups' states by the warp that takes the last of the segment's second
// tickets (tickets[2 chunks + bf]).  Both levels add in chunk order.
template <typename T, int W>
__device__ __forceinline__ void merge_long(const Params& q, int row, int beg,
                                           int end, int k, int lane) {
  using V = typename Rows<float, W>::V;
  const int C = q.channels;
  const int bf = beg / kChunk, bl = (end - 1) / kChunk, n = bl - bf + 1;
  const int first = bf + (k - bf) / kGroup * kGroup;
  const int slot = first == bf ? 1 : 0;
  const int gn = min(first + kGroup - 1, bl) - first + 1;
  int* t1 = q.tickets + 2 * first + slot;
  int last = 0;
  if (lane == 0) last = atomicAdd(t1, 1) == gn - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  T* out = static_cast<T*>(q.out);
  const auto to_out = [&](int g, V v) {
    Rows<T, W>::store(out, row, C, g, v);
  };
  const auto part_of = [&](int i) {
    const int c = first + i;
    return q.part + ((size_t)c * 2 + (c == bf ? 1 : 0)) * C;
  };
  if (n <= kGroup) {
    merge_list<W>(C, gn, lane, part_of, to_out);
    if (lane == 0) *t1 = 0;
    return;
  }
  float* sp = q.spart + ((size_t)first * 2 + slot) * C;
  merge_list<W>(C, gn, lane, part_of,
                [&](int g, V v) { Rows<float, W>::put(sp, g, v); });
  if (lane == 0) *t1 = 0;
  __threadfence();
  __syncwarp();
  const int groups = (n + kGroup - 1) / kGroup;
  int* t2 = q.tickets + 2 * q.chunks + bf;
  if (lane == 0) last = atomicAdd(t2, 1) == groups - 1;
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  merge_list<W>(C, groups, lane, [&](int j) {
    return q.spart + ((size_t)(bf + j * kGroup) * 2 + (j == 0 ? 1 : 0)) * C;
  }, to_out);
  if (lane == 0) *t2 = 0;
}

// A slot block: the slots of segments of more than 32 entries in each
// warp's chunk.
template <typename T, int W, bool ENTRY>
__device__ __forceinline__ void long_segments(const Params& q, int lane,
                                              int warp) {
  using R = Rows<T, W>;
  using V = typename R::V;
  const int C = q.channels;
  const int c0 = (blockIdx.x * kWarps + warp) * kChunk;
  const int cnt = min(kChunk, __ldg(q.rowptr + q.segments) - c0);
  if (cnt <= 0) return;                                // warp-uniform
  const SlotRow me = slot_rows(q.rowptr, q.segments, c0, cnt, lane);
  const bool lng = lane < cnt && me.end - me.beg > kChunk;
  const int my = lng ? entry(q, c0 + lane) : 0;
  for (unsigned rest = __ballot_sync(kFull, lng); rest != 0;) {
    // the first long segment among the lanes left (at most two a chunk)
    const int t0 = __ffs(rest) - 1;
    const int row = __shfl_sync(kFull, me.row, t0);
    const int beg = __shfl_sync(kFull, me.beg, t0);
    const int end = __shfl_sync(kFull, me.end, t0);
    const unsigned mask =
        __ballot_sync(kFull, (rest >> lane & 1) && me.row == row);
    const int tb = kWarp - __clz(mask);
    float* pt = q.part + ((size_t)(c0 / kChunk) * 2 + (beg < c0 ? 0 : 1)) * C;
    if (ENTRY) {
      float acc[kEntryC];
      sum_entries<T>(q, my, lane >= t0 && lane < tb, acc);
      if (lane < C) pt[lane] = at(acc, lane);
    } else {
      walk_channels<T, W>(q, my, t0, tb, lane,
                          [&](int g, V v) { R::put(pt, g, v); });
    }
    __threadfence();
    __syncwarp();
    if (ENTRY) {
      merge_long<T, 1>(q, row, beg, end, c0 / kChunk, lane);
    } else {
      merge_long<T, W>(q, row, beg, end, c0 / kChunk, lane);
    }
    rest &= ~mask;
  }
}

// W: channels per group (4: float4 rows, else 1); ENTRY: lanes over
// entries (C <= kEntryC).
template <typename T, int W, bool ENTRY>
__global__ void __launch_bounds__(kThreads) sum_kernel(const Params q) {
  using R = Rows<T, W>;
  using V = typename R::V;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if ((int)blockIdx.x < q.slot_blocks) {
    long_segments<T, W, ENTRY>(q, lane, warp);
    return;
  }
  const int C = q.channels;
  T* out = static_cast<T*>(q.out);
  const int r0 = ((int)blockIdx.x - q.slot_blocks) * kWarps;
  const int r1 = min(r0 + kWarps, q.segments);
  if (__ldg(q.rowptr + r0) == __ldg(q.rowptr + r1)) {    // block-uniform
    const T z = from_f<T>(0.f);
    for (int i = threadIdx.x; i < (r1 - r0) * C; i += blockDim.x) {
      out[(size_t)r0 * C + i] = z;
    }
    return;
  }
  const int r = r0 + warp;
  if (r >= r1) return;
  const int beg = __ldg(q.rowptr + r), end = __ldg(q.rowptr + r + 1);
  const int len = end - beg;
  if (len > kChunk) return;                          // the slot blocks'
  const int my = lane < len ? entry(q, beg + lane) : 0;
  if (ENTRY) {
    float acc[kEntryC];
    sum_entries<T>(q, my, lane < len, acc);
    if (lane < C) out[(size_t)r * C + lane] = from_f<T>(at(acc, lane));
  } else {
    walk_channels<T, W>(q, my, 0, len, lane,
                        [&](int g, V v) { R::store(out, r, C, g, v); });
  }
}

using Kernel = void (*)(const Params);

template <typename T>
Kernel pick(int channels, bool vec) {
  if (channels <= kEntryC) return sum_kernel<T, 1, true>;
  if (vec && channels % 4 == 0) return sum_kernel<float, 4, false>;
  return sum_kernel<T, 1, false>;
}

}  // namespace

extern "C" {

int segment_sum_csr_entry_channels() { return kEntryC; }

// Pointers are device pointers; `stream` is a cudaStream_t.  dtype: 0
// float32, 1 bfloat16, 2 float16 (x and out).  segments >= 1, channels >=
// 1, rowptr[segments] <= slots, where slots is perm's length (or, with a
// null perm, the rows of x); the slots past rowptr[segments] are not read.
// With chunks = ceil(slots / 32): part holds chunks * 4 * channels floats
// and tickets 3 * chunks ints that are zero (and are zero again when the
// kernel ends).  vec = 1 allows float4 rows: float32, channels % 4 == 0
// and x and out 16-byte aligned.  The kernel writes every row of out.
int segment_sum_csr(const void* x, const int* rowptr, const int* perm,
                    void* out, float* part, int* tickets, int segments,
                    int slots, int channels, int dtype, int vec,
                    void* stream) {
  if (segments < 1 || slots < 0 || channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Kernel kernel = nullptr;
  if (dtype == 0) kernel = pick<float>(channels, vec != 0);
  if (dtype == 1) kernel = pick<__nv_bfloat16>(channels, false);
  if (dtype == 2) kernel = pick<__half>(channels, false);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int slot_blocks = (slots + kThreads - 1) / kThreads;
  const int chunks = (slots + kChunk - 1) / kChunk;
  const Params q{x,       rowptr,   perm,     out,    part,
                 part + (size_t)chunks * 2 * channels, tickets, segments,
                 slots,   channels, chunks,   slot_blocks};
  const int blocks = slot_blocks + (segments + kWarps - 1) / kWarps;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
