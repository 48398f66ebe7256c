// K4: forward flash attention for prefill, with explicit positions.
//
// Replaces the Pallas TPU kernel flash_attention_hsd (body _kernel) in
// src/repro/kernels/flash_attention.py, together with the layout work of
// its wrapper kernels/ops.py:flash_attention.
//
// Computes out[b, i, h, g] = Σ_j softmax_j(s)·v[b, j, h] with
//   s[i, j] = (q[b, i, h, g]·k[b, j, h]) / sqrt(hd), masked unless
//   k_pos[j] >= 0, (causal) q_pos[i] >= k_pos[j], (window) q_pos - k_pos <
//   window — the same online softmax as the TPU kernel, without its zeroing
//   of fully masked tiles (a row with no valid key is undefined there too).
//
// What bounds it on an H100: at the serving prefill (S = 256, hd = 96,
// 32 heads) the work is 2·2·S²·hd FLOPs per head on a few MB of q/k/v, so
// it is bound by operations; this first kernel runs them in f32 on the
// CUDA cores, not the tensor cores — a later kernel moves it to wgmma.
//
// Design: the model layout stays as it is — q (B, Sq, KV, G, hd), k and v
// (B, Sk, KV, hd) — and the kernel indexes the KV head of query head
// (h, g) directly, where the TPU wrapper broadcast K/V over G and
// transposed everything to (B·KV·G, S, hd) in memory first. One block of
// 128 threads owns 32 query rows of one head and walks the keys in 32-row
// tiles (the TPU's sequential K grid axis becomes this loop): the tile is
// staged in shared memory as f32 with a padded row stride, scores are
// computed by thread (key, 8 query rows), a warp per query row updates
// the running max and sum, and P·V runs one thread per head-dim column
// with the 32 rows' accumulators in registers, so hd = 96 needs no
// power-of-two tiling. Key slots past Sk contribute nothing.
//
// The limits below repeat src/repro_torch/kernels/constraints.py.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;           // query rows per block
constexpr int kBK = 32;           // key rows per tile (one per lane)
constexpr int kMaxHd = 128;       // constraints.ATTN_MAX_HEAD_DIM
constexpr float kNegInf = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ out,
                       int Sq, int Sk, int KVH, int G, int hd, int causal,
                       int window, float scale) {
  __shared__ float qs[kBQ][kMaxHd + 1];
  __shared__ float tile[kBK][kMaxHd + 1];      // K tile, then V tile
  __shared__ float ps[kBQ][kBK];               // scores, then probabilities
  __shared__ float m_s[kBQ], l_s[kBQ], corr_s[kBQ];
  __shared__ int qp_s[kBQ], kp_s[kBK];

  const int head = blockIdx.y;                 // b·KV·G + h·G + g
  const int g = head % G;
  const int h = (head / G) % KVH;              // the KV head: (h·G + g) // G
  const int b = head / (G * KVH);
  const int i0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_row = static_cast<size_t>(KVH) * G * hd;   // q stride over i
  const size_t k_row = static_cast<size_t>(KVH) * hd;       // k stride over j
  const T* qb = q + static_cast<size_t>(b) * Sq * q_row
      + (static_cast<size_t>(h) * G + g) * hd;
  const T* kb = k + static_cast<size_t>(b) * Sk * k_row
      + static_cast<size_t>(h) * hd;
  const T* vb = v + static_cast<size_t>(b) * Sk * k_row
      + static_cast<size_t>(h) * hd;

  for (int idx = threadIdx.x; idx < kBQ * hd; idx += kThreads) {
    const int i = idx / hd, d = idx % hd;
    qs[i][d] = i0 + i < Sq ? to_f32(qb[(i0 + i) * q_row + d]) : 0.f;
  }
  if (threadIdx.x < kBQ) {
    const int i = threadIdx.x;
    qp_s[i] = i0 + i < Sq ? q_pos[i0 + i] : 0;
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  float acc[kBQ];
#pragma unroll
  for (int i = 0; i < kBQ; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < Sk; j0 += kBK) {
    const int tk = min(kBK, Sk - j0);
    if (threadIdx.x < kBK)
      kp_s[threadIdx.x] = threadIdx.x < tk ? k_pos[j0 + threadIdx.x] : -1;
    for (int idx = threadIdx.x; idx < tk * hd; idx += kThreads) {
      const int j = idx / hd, d = idx % hd;
      tile[j][d] = to_f32(kb[(j0 + j) * k_row + d]);
    }
    __syncthreads();

    {  // scores: this thread's key `lane`, query rows warp + 4·c
      const int j = lane;
      const int kp = kp_s[j];
      for (int c = 0; c < kBQ / 4; ++c) {
        const int i = warp + 4 * c;
        float s = kNegInf;
        if (j < tk) {
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qs[i][d], tile[j][d], dot);
          const int qp = qp_s[i];
          bool ok = kp >= 0;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && qp - kp < window;
          s = ok ? dot * scale : kNegInf;
        }
        ps[i][j] = s;
      }
    }
    __syncthreads();

    for (int i = warp; i < kBQ; i += kThreads / 32) {
      const float s = ps[i][lane];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < tk ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[i][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[i] = m_new;
        l_s[i] = l_s[i] * corr + sum;
        corr_s[i] = corr;
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < tk * hd; idx += kThreads) {
      const int j = idx / hd, d = idx % hd;
      tile[j][d] = to_f32(vb[(j0 + j) * k_row + d]);
    }
    __syncthreads();

    if (threadIdx.x < hd) {
      const int d = threadIdx.x;
#pragma unroll
      for (int i = 0; i < kBQ; ++i) acc[i] *= corr_s[i];
      for (int j = 0; j < tk; ++j) {
        const float vv = tile[j][d];
#pragma unroll
        for (int i = 0; i < kBQ; ++i) acc[i] = fmaf(ps[i][j], vv, acc[i]);
      }
    }
    __syncthreads();
  }

  if (threadIdx.x < hd) {
    T* ob = out + static_cast<size_t>(b) * Sq * q_row
        + (static_cast<size_t>(h) * G + g) * hd + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kBQ; ++i)
      if (i0 + i < Sq)
        ob[(i0 + i) * q_row] = from_f32<T>(acc[i] / fmaxf(l_s[i], 1e-30f));
  }
}

}  // namespace

// q, out (B, Sq, KVH, G, hd); k, v (B, Sk, KVH, hd); all f32 or all bf16
// (bf16 != 0); q_pos (Sq,), k_pos (Sk,) int32 with k_pos = -1 invalid.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int Sq, int Sk, int KVH, int G, int hd,
                                      int causal, int window, int bf16,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * KVH * G);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  if (bf16) {
    flash_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qp, kp,
        static_cast<__nv_bfloat16*>(out), Sq, Sk, KVH, G, hd, causal, window,
        scale);
  } else {
    flash_attention_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qp, kp, static_cast<float*>(out), Sq, Sk,
        KVH, G, hd, causal, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
