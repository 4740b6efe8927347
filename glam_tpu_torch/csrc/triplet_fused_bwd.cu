// Fused TripletMessage attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of the JAX package
// (glam_tpu/ops/pallas/triplet_fused.py:296-364, launched by `_backward`'s
// pallas_call at :531).  Given the forward's inputs and the cotangent g of
// its output, it recomputes the forward of every real edge e = (s -> r)
//
//   eh      = edge_attr[e] @ We                          [H*C]
//   pre_raw = a_i[r] + eh @ wemat + a_j[s]               [H]
//   alpha   = softmax of leaky_relu(pre_raw) over r's incoming edges
//
// and emits
//
//   d_xp[s]  += alpha_h * g[r] * eh                 (to senders, atomics)
//   dalpha_h  = sum_{c in head h} eh * xp[s] * g[r]
//   dpre_h    = alpha_h * (dalpha_h - sum_row alpha_h * dalpha_h)
//               * (pre_raw_h >= 0 ? 1 : slope)
//   d_eh[e]   = alpha_h * g[r] * xp[s] + dpre @ wemat^T
//   d_pre[e]  = dpre;   d_a_i[r] = sum over r's edges of dpre
//
// d_eh and d_pre are written at the edge's original index (csr_eid); the
// caller zeroes them first, so padded edges, which the CSR leaves out,
// keep zeros.  The rest of the gradient (d_edge_attr, d_We, d_wemat,
// d_a_j) is small matrix products done by the caller.
//
// Design.  The TPU kernel packs edges into 256-edge blocks with 128-node
// windows and turns gathers and scatters into one-hot matmuls; here, as in
// the forward kernel (triplet_fused.cu), the host hands over a
// receiver-sorted CSR of the real edges and one warp owns one receiver
// row, lanes striding over the H*C channels, with g[r] held in registers.
// The softmax backward needs a sum over the whole row before any edge's
// dpre is known, so a row takes three passes over its edges, each in
// chunks of 32 (one edge per lane for the indices, features and logits),
// which keeps every row correct at any in-degree:
//   1. the running max and sum of the softmax, per head;
//   2. per edge alpha and dalpha (a warp sum over each head's channels),
//      the row sum of alpha * dalpha, and the edge's d_xp term;
//   3. per edge dalpha again, then dpre and d_eh.
// Passes 2 and 3 read the edge's sender row of xp again; the rows of one
// chunk are in L1 or L2 by then.
//
// d_xp goes to senders, which the receiver CSR does not group, so it is
// summed with float atomicAdd into a zeroed d_xp.  Its sums therefore run
// in another order on every call: the result is not bitwise reproducible
// and agrees with a sequential sum to float32 rounding (the plain version
// is held to 1e-4 relative and absolute).
//
// Bound.  As for the forward: a few flops per byte, so memory traffic
// bounds it: the sender rows of xp, the g rows of receivers with edges,
// the edge features, and the d_xp, d_eh and d_pre outputs.  What it waits
// on in practice is the latency of each row's dependent loads, so the grid
// is the blocks that fit on the card at once and each warp walks many rows.
//
// Interface: plain C, loaded with ctypes.  Every entry returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMaxHeads = 8;
constexpr int kMaxValuesPerLane = 16;             // H*C <= 512
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinBlocksPerSM = 2;

struct Params {
  const float* xp;          // [n, hc]
  const float* a_i;         // [n, heads]
  const float* a_j;         // [n, heads]
  const float* edge_attr;   // [E, fe]
  const float* we;          // [fe, hc]
  const float* wemat;       // [hc, heads]
  const int* rowptr;        // [n + 1]
  const int* snd;           // [E_real]
  const int* eid;           // [E_real]
  const float* g;           // [n, hc]
  float* d_xp;              // [n, hc], zeroed by the caller
  float* d_eh;              // [E, hc], zeroed by the caller
  float* d_pre;             // [E, heads], zeroed by the caller
  float* d_a_i;             // [n, heads]
  int n, hc, heads, channels, fe;
  float slope;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// Shared memory floats: We, Wf = We @ wemat and wemat for the block, then
// per warp the chunk's alpha [32, heads], pre_raw [32, heads], edge
// features [32, fe], senders [32] and edge ids [32].
size_t smem_floats(int hc, int heads, int fe) {
  return (size_t)fe * hc + (size_t)fe * heads + (size_t)hc * heads +
         (size_t)kWarpsPerBlock * kWarp * (2 * heads + fe + 2);
}

// The chunk's edges [c0, c0 + cnt) of a row, one per lane: their senders,
// ids, features and raw logits go to shared memory.  Returns this lane's
// raw logits in pre_raw (-inf past the chunk's end).
template <int MAXH>
__device__ __forceinline__ void load_chunk(
    const Params& q, const float* wf_s, const float* ai, int c0, int cnt,
    int lane, float* pr_s, float* ea_s, int* snd_s, int* eid_s,
    float (&pre_raw)[MAXH]) {
  const int heads = q.heads, fe = q.fe;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) pre_raw[h] = -INFINITY;
  if (lane >= cnt) return;
  const int s = q.snd[c0 + lane];
  const int e = q.eid[c0 + lane];
  snd_s[lane] = s;
  eid_s[lane] = e;
  float a_e[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) a_e[h] = 0.f;
  for (int f = 0; f < fe; ++f) {
    const float ea = q.edge_attr[(size_t)e * fe + f];
    ea_s[lane * fe + f] = ea;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads) a_e[h] = fmaf(ea, wf_s[f * heads + h], a_e[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < heads) {
      pre_raw[h] = ai[h] + a_e[h] + q.a_j[(size_t)s * heads + h];
      pr_s[lane * heads + h] = pre_raw[h];
    }
  }
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// VPL: channels per lane (H*C <= 32*VPL); MAXH: most heads (heads <= MAXH).
template <int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
triplet_bwd_kernel(const Params q) {
  extern __shared__ float smem[];
  const int hc = q.hc, heads = q.heads, fe = q.fe;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  float* we_s = smem;                               // [fe, hc]
  float* wf_s = we_s + fe * hc;                     // [fe, heads]
  float* wm_s = wf_s + fe * heads;                  // [hc, heads]
  float* al_s = wm_s + hc * heads + warp * kWarp * (2 * heads + fe + 2);
  float* pr_s = al_s + kWarp * heads;               // [32, heads]
  float* ea_s = pr_s + kWarp * heads;               // [32, fe]
  int* snd_s = reinterpret_cast<int*>(ea_s + kWarp * fe);   // [32]
  int* eid_s = snd_s + kWarp;                                // [32]

  for (int i = threadIdx.x; i < fe * hc; i += blockDim.x) we_s[i] = q.we[i];
  for (int i = threadIdx.x; i < hc * heads; i += blockDim.x) {
    wm_s[i] = q.wemat[i];
  }
  __syncthreads();
  // Wf[f, h] = sum_j We[f, j] * wemat[j, h]: one warp per entry
  for (int i = warp; i < fe * heads; i += kWarpsPerBlock) {
    const int f = i / heads, h = i % heads;
    float w = 0.f;
    for (int j = lane; j < hc; j += kWarp) {
      w = fmaf(we_s[f * hc + j], wm_s[j * heads + h], w);
    }
    w = warp_sum(w);
    if (lane == 0) wf_s[i] = w;
  }
  __syncthreads();

  // head of each channel this lane owns (-1: past the end of the row)
  int head_of[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + kWarp * v;
    head_of[v] = j < hc ? j / q.channels : -1;
  }

  const int warps_total = gridDim.x * kWarpsPerBlock;
  for (int r = blockIdx.x * kWarpsPerBlock + warp; r < q.n; r += warps_total) {
    const int beg = q.rowptr[r];
    const int end = q.rowptr[r + 1];
    if (beg == end) {
      if (lane < heads) q.d_a_i[(size_t)r * heads + lane] = 0.f;
      continue;
    }
    float ai[MAXH], m[MAXH], l[MAXH], rowsum[MAXH], dai[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      ai[h] = h < heads ? q.a_i[(size_t)r * heads + h] : 0.f;
      m[h] = -INFINITY;
      l[h] = 0.f;
      rowsum[h] = 0.f;
      dai[h] = 0.f;
    }
    float gr[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = lane + kWarp * v;
      gr[v] = j < hc ? q.g[(size_t)r * hc + j] : 0.f;
    }

    // pass 1: softmax max and sum per head, online over the chunks
    for (int c0 = beg; c0 < end; c0 += kWarp) {
      const int cnt = min(kWarp, end - c0);
      float pre_raw[MAXH];
      load_chunk<MAXH>(q, wf_s, ai, c0, cnt, lane, pr_s, ea_s, snd_s, eid_s,
                       pre_raw);
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h < heads) {
          const float x = lane < cnt ? leaky(pre_raw[h], q.slope) : -INFINITY;
          const float m_new = fmaxf(m[h], warp_max(x));
          const float p = lane < cnt ? expf(x - m_new) : 0.f;
          l[h] = l[h] * expf(m[h] - m_new) + warp_sum(p);
          m[h] = m_new;
        }
      }
      __syncwarp();
    }
    float inv[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) inv[h] = 1.f / (l[h] + 1e-16f);

    // passes 2 and 3 over the same chunks
    for (int pass = 2; pass <= 3; ++pass) {
      for (int c0 = beg; c0 < end; c0 += kWarp) {
        const int cnt = min(kWarp, end - c0);
        float pre_raw[MAXH];
        load_chunk<MAXH>(q, wf_s, ai, c0, cnt, lane, pr_s, ea_s, snd_s,
                         eid_s, pre_raw);
        if (lane < cnt) {
#pragma unroll
          for (int h = 0; h < MAXH; ++h) {
            if (h < heads) {
              al_s[lane * heads + h] =
                  expf(leaky(pre_raw[h], q.slope) - m[h]) * inv[h];
            }
          }
        }
        __syncwarp();

        for (int t = 0; t < cnt; ++t) {
          const int s = snd_s[t];
          const float* xs = q.xp + (size_t)s * hc;
          const float* al = al_s + t * heads;
          float eh[VPL], xj[VPL];
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const int j = lane + kWarp * v;
            eh[v] = 0.f;
            xj[v] = j < hc ? xs[j] : 0.f;
          }
          for (int f = 0; f < fe; ++f) {
            const float eaf = ea_s[t * fe + f];
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
              const int j = lane + kWarp * v;
              if (j < hc) eh[v] = fmaf(eaf, we_s[f * hc + j], eh[v]);
            }
          }
          // dalpha per head: this lane's channels, then a warp sum
          float dal[MAXH];
#pragma unroll
          for (int h = 0; h < MAXH; ++h) dal[h] = 0.f;
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const float x = eh[v] * xj[v] * gr[v];
#pragma unroll
            for (int h = 0; h < MAXH; ++h) {
              if (h == head_of[v]) dal[h] += x;
            }
          }
#pragma unroll
          for (int h = 0; h < MAXH; ++h) {
            if (h < heads) dal[h] = warp_sum(dal[h]);
          }

          if (pass == 2) {
#pragma unroll
            for (int h = 0; h < MAXH; ++h) {
              if (h < heads) rowsum[h] = fmaf(al[h], dal[h], rowsum[h]);
            }
            float* dx = q.d_xp + (size_t)s * hc;
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
              const int j = lane + kWarp * v;
              if (j < hc) atomicAdd(dx + j, al[head_of[v]] * gr[v] * eh[v]);
            }
            continue;
          }

          // pass 3: dpre, then d_eh, d_pre and the row's d_a_i
          const int e = eid_s[t];
          const float* pr = pr_s + t * heads;
          float dpre[MAXH];
#pragma unroll
          for (int h = 0; h < MAXH; ++h) {
            dpre[h] = 0.f;
            if (h < heads) {
              dpre[h] = al[h] * (dal[h] - rowsum[h]) *
                        (pr[h] >= 0.f ? 1.f : q.slope);
              dai[h] += dpre[h];
            }
          }
          float* deh = q.d_eh + (size_t)e * hc;
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const int j = lane + kWarp * v;
            if (j < hc) {
              float d = al[head_of[v]] * gr[v] * xj[v];
#pragma unroll
              for (int h = 0; h < MAXH; ++h) {
                if (h < heads) d = fmaf(dpre[h], wm_s[j * heads + h], d);
              }
              deh[j] = d;
            }
          }
#pragma unroll
          for (int h = 0; h < MAXH; ++h) {
            if (h < heads && lane == h) q.d_pre[(size_t)e * heads + h] = dpre[h];
          }
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < heads && lane == h) q.d_a_i[(size_t)r * heads + h] = dai[h];
    }
  }
}

using Kernel = void (*)(const Params);

template <int MAXH>
Kernel pick_vpl(int vpl) {
  if (vpl <= 1) return triplet_bwd_kernel<1, MAXH>;
  if (vpl <= 2) return triplet_bwd_kernel<2, MAXH>;
  if (vpl <= 4) return triplet_bwd_kernel<4, MAXH>;
  if (vpl <= 8) return triplet_bwd_kernel<8, MAXH>;
  if (vpl <= kMaxValuesPerLane) {
    return triplet_bwd_kernel<kMaxValuesPerLane, MAXH>;
  }
  return nullptr;
}

// The instantiation for these widths, or nullptr if there is none.
Kernel pick(int hc, int heads, int channels) {
  if (heads < 1 || heads > kMaxHeads || hc != heads * channels) {
    return nullptr;
  }
  const int vpl = (hc + kWarp - 1) / kWarp;
  return heads <= 4 ? pick_vpl<4>(vpl) : pick_vpl<kMaxHeads>(vpl);
}

}  // namespace

extern "C" {

int triplet_bwd_max_hc() { return kWarp * kMaxValuesPerLane; }
int triplet_bwd_max_heads() { return kMaxHeads; }
int triplet_bwd_warps_per_block() { return kWarpsPerBlock; }
long long triplet_bwd_smem_bytes(int hc, int heads, int fe) {
  return (long long)(sizeof(float) * smem_floats(hc, heads, fe));
}

// Blocks of the kernel for these widths that fit on one SM at once (0 if
// the widths have no kernel).
int triplet_bwd_blocks_per_sm(int hc, int heads, int channels, int fe) {
  const Kernel k = pick(hc, heads, channels);
  int blocks = 0;
  if (k == nullptr) return 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, kThreads, sizeof(float) * smem_floats(hc, heads, fe));
  return blocks;
}

// Pointers are device pointers; `stream` is a cudaStream_t.  `blocks` is
// the grid size (each warp walks rows r, r + warps_total, ...); it must be
// at least 1.  d_xp, d_eh and d_pre must be zeroed.  The caller checks
// triplet_bwd_smem_bytes against the block's shared memory.
int triplet_bwd(const float* xp, const float* a_i, const float* a_j,
                const float* edge_attr, const float* we, const float* wemat,
                const int* rowptr, const int* snd, const int* eid,
                const float* g, float* d_xp, float* d_eh, float* d_pre,
                float* d_a_i, int n, int hc, int heads, int channels, int fe,
                float slope, int blocks, void* stream) {
  const Kernel k = pick(hc, heads, channels);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Params q{xp,  a_i,  a_j,   edge_attr, we, wemat,    rowptr,
                 snd, eid,  g,     d_xp,      d_eh, d_pre,  d_a_i,
                 n,   hc,   heads, channels,  fe, slope};
  k<<<blocks, kThreads, sizeof(float) * smem_floats(hc, heads, fe),
      static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
