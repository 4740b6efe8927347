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
// Design.  The TPU kernel packs receiver-sorted edges into 256-edge blocks
// with 128-node windows and turns every gather and scatter into a one-hot
// matmul, because Mosaic has no gather.  Hopper gathers, so the host hands
// over a receiver-sorted CSR of the real edges (rowptr, snd, eid) instead,
// and one warp owns one receiver row, with lanes striding over the H*C
// channels.  We sits in shared memory, beside Wf = We @ wemat [Fe, H], so
// an edge's logit term (eh @ wemat)[h] = edge_attr[e] @ Wf[:, h] needs no
// reduction over channels.  A row's edges go in chunks of 32: each lane
// loads one edge's indices and features and forms its logits, the chunk
// updates an online softmax per head (running max m_h, sum l_h, rescaled
// accumulator), and the warp then sums the chunk's messages with the
// edges' sender rows loaded independently of one another.  Each real edge
// is read once and each output row is written once, with no atomics and no
// second pass.  Rows without edges write 0.
//
// Bound.  The work per edge is ~H*C*(2*Fe+3) flops against H*C*4 bytes of
// xp[s], far below the card's ratio of flops to bytes, so the kernel is
// bounded by memory traffic: the out rows (N*H*C*4 bytes, most of them
// padding rows of zeros) and the sender rows of xp.  What it waits on in
// practice is the latency of the dependent loads of a row (rowptr, then
// the edges' indices, then their sender rows), so the grid is sized to
// the blocks that fit on the card at once and each warp walks many rows.
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
// blocks per SM the register budget must allow (80 registers a thread):
// more resident warps hide more of the rows' load latency
constexpr int kMinBlocksPerSM = 3;

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
  float* out;               // [n, hc]
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

// Shared memory floats: We and Wf for the block, then per warp the
// chunk's unnormalised softmax weights p [32, heads], edge features
// [32, fe] and senders [32].
size_t smem_floats(int hc, int heads, int fe) {
  return (size_t)fe * hc + (size_t)fe * heads +
         (size_t)kWarpsPerBlock * kWarp * (heads + fe + 1);
}

// VPL: channels per lane (H*C <= 32*VPL); MAXH: most heads (heads <= MAXH).
template <int VPL, int MAXH>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
triplet_fwd_kernel(const Params q) {
  extern __shared__ float smem[];
  const int hc = q.hc, heads = q.heads, fe = q.fe;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  float* we_s = smem;                               // [fe, hc]
  float* wf_s = we_s + fe * hc;                     // [fe, heads]
  float* p_s = wf_s + fe * heads + warp * kWarp * (heads + fe + 1);
  float* ea_s = p_s + kWarp * heads;                // [32, fe]
  int* snd_s = reinterpret_cast<int*>(ea_s + kWarp * fe);   // [32]

  for (int i = threadIdx.x; i < fe * hc; i += blockDim.x) we_s[i] = q.we[i];
  __syncthreads();
  // Wf[f, h] = sum_j We[f, j] * wemat[j, h]: one warp per entry
  for (int i = warp; i < fe * heads; i += kWarpsPerBlock) {
    const int f = i / heads, h = i % heads;
    float w = 0.f;
    for (int j = lane; j < hc; j += kWarp) {
      w = fmaf(we_s[f * hc + j], q.wemat[j * heads + h], w);
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
    float acc[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
    float m[MAXH], l[MAXH], ai[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
      ai[h] = (h < heads && beg < end) ? q.a_i[(size_t)r * heads + h] : 0.f;
    }

    for (int c0 = beg; c0 < end; c0 += kWarp) {
      const int cnt = min(kWarp, end - c0);
      const bool valid = lane < cnt;

      // this lane's edge: indices, features and logits
      float pre[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) pre[h] = -INFINITY;
      if (valid) {
        const int s = q.snd[c0 + lane];
        const int e = q.eid[c0 + lane];
        snd_s[lane] = s;
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
            const float x = ai[h] + a_e[h] + q.a_j[(size_t)s * heads + h];
            pre[h] = x >= 0.f ? x : q.slope * x;
          }
        }
      }

      // online softmax update per head, over the chunk
      float scale[MAXH];
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        scale[h] = 1.f;
        if (h < heads) {
          const float m_new = fmaxf(m[h], warp_max(pre[h]));
          scale[h] = expf(m[h] - m_new);
          const float p = valid ? expf(pre[h] - m_new) : 0.f;
          l[h] = l[h] * scale[h] + warp_sum(p);
          m[h] = m_new;
          if (valid) p_s[lane * heads + h] = p;
        }
      }
      __syncwarp();

#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float sc = 1.f;
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          if (h == head_of[v]) sc = scale[h];
        }
        acc[v] *= sc;
      }

      // messages of the chunk's edges
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const float* xs = q.xp + (size_t)snd_s[t] * hc;
        const float* p = p_s + t * heads;
        // edge projection eh = edge_attr[e] @ We, this lane's channels
        float eh[VPL];
#pragma unroll
        for (int v = 0; v < VPL; ++v) eh[v] = 0.f;
        for (int f = 0; f < fe; ++f) {
          const float eaf = ea_s[t * fe + f];
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const int j = lane + kWarp * v;
            if (j < hc) eh[v] = fmaf(eaf, we_s[f * hc + j], eh[v]);
          }
        }
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int j = lane + kWarp * v;
          if (j < hc) acc[v] = fmaf(p[head_of[v]] * eh[v], xs[j], acc[v]);
        }
      }
      __syncwarp();
    }

    float* orow = q.out + (size_t)r * hc;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = lane + kWarp * v;
      if (j < hc) {
        float den = 0.f;
#pragma unroll
        for (int h = 0; h < MAXH; ++h) {
          if (h == head_of[v]) den = l[h];
        }
        orow[j] = acc[v] / (den + 1e-16f);
      }
    }
  }
}

using Kernel = void (*)(const Params);

template <int MAXH>
Kernel pick_vpl(int vpl) {
  if (vpl <= 1) return triplet_fwd_kernel<1, MAXH>;
  if (vpl <= 2) return triplet_fwd_kernel<2, MAXH>;
  if (vpl <= 4) return triplet_fwd_kernel<4, MAXH>;
  if (vpl <= 8) return triplet_fwd_kernel<8, MAXH>;
  if (vpl <= kMaxValuesPerLane) {
    return triplet_fwd_kernel<kMaxValuesPerLane, MAXH>;
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

int triplet_fused_max_hc() { return kWarp * kMaxValuesPerLane; }
int triplet_fused_max_heads() { return kMaxHeads; }
int triplet_fused_warps_per_block() { return kWarpsPerBlock; }
long long triplet_fused_smem_bytes(int hc, int heads, int fe) {
  return (long long)(sizeof(float) * smem_floats(hc, heads, fe));
}

// Blocks of the kernel for these widths that fit on one SM at once (0 if
// the widths have no kernel).
int triplet_fused_blocks_per_sm(int hc, int heads, int channels, int fe) {
  const Kernel k = pick(hc, heads, channels);
  int blocks = 0;
  if (k == nullptr) return 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, kThreads, sizeof(float) * smem_floats(hc, heads, fe));
  return blocks;
}

// Pointers are device pointers; `stream` is a cudaStream_t.  `blocks` is
// the grid size (each warp walks rows r, r + warps_total, ...); it must be
// at least 1.  The caller checks triplet_fused_smem_bytes against the
// block's shared memory.
int triplet_fused_fwd(const float* xp, const float* a_i, const float* a_j,
                      const float* edge_attr, const float* we,
                      const float* wemat, const int* rowptr, const int* snd,
                      const int* eid, float* out, int n, int hc, int heads,
                      int channels, int fe, float slope, int blocks,
                      void* stream) {
  const Kernel k = pick(hc, heads, channels);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Params q{xp, a_i, a_j, edge_attr, we, wemat, rowptr, snd, eid, out,
                 n, hc, heads, channels, fe, slope};
  k<<<blocks, kThreads, sizeof(float) * smem_floats(hc, heads, fe),
      static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
