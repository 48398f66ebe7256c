// K3: single-query flash-decode attention over the head-major slot cache,
// and K5: the same attention over the paged cache, through a block table.
//
// K3 replaces the Pallas TPU kernel flash_decode_bkgd (body _decode_kernel)
// in src/repro/kernels/decode_attention.py; K5 replaces flash_decode_paged
// (body _paged_decode_kernel, which wraps the same _decode_kernel) there.
//
// Computes, for every batch row b and KV head h, the G query heads of the
// group against the row's cache pages (B, KV, S, hd):
//   s[g, j] = (q[g]·k[j]) · k_scale[j] · scale, masked unless
//             0 <= k_pos[b, j] <= q_pos[b] (and q_pos - k_pos < window);
//   out[g]  = Σ_j softmax(s)[g, j] · v_scale[j] · v[j]
// with an online softmax over tiles of the slot axis. A row with no valid
// slot outputs zeros: p is zeroed while the running max still sits at the
// -0.7·FLT_MAX sentinel, as the TPU kernel does.
//
// What bounds it on an H100: bytes. Each decode step reads the whole live
// cache once (bf16 B=8, KV=32, S=512, hd=96: 50 MB for K and V) for
// 2·G·hd FLOPs per slot, far below the card's ops-per-byte balance.
//
// Design: one 128-thread block per (row, KV head) — 256 blocks at the
// serving shape, about two per SM — walks the slot axis in 64-slot tiles;
// the sequential TPU grid axis becomes this loop. Each tile is loaded
// coalesced into shared memory as f32, in 8- or 16-byte vectors with
// several loads in flight per thread (bf16 widened, int8 codes converted,
// packed4 bytes split into their two slots with the shift-based sign
// extension of unpack_codes_4bit), scores one thread per (head, slot),
// the running max/sum per head by one warp, and P·V one thread per
// head-dim column, so hd = 96 needs no power-of-two tiling. int8/int4
// scales are folded into the score and probability columns, never into
// the tile: the dequantized cache exists nowhere. The K tile's buffer is
// reused for V, keeping the block under 48 KB of static shared memory.
//
// The limits below repeat src/repro_torch/kernels/constraints.py.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileS = 64;        // slots per tile (even: packed4 pairs)
constexpr int kMaxHd = 128;       // constraints.ATTN_MAX_HEAD_DIM
constexpr int kMaxG = 8;          // constraints.DECODE_MAX_GROUP
constexpr float kNegInf = -0.7f * FLT_MAX;

enum KvKind { kF32 = 0, kBF16 = 1, kInt8 = 2, kPacked4 = 3 };

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

// One vector load of the tile: 16 bytes of f32/bf16, 8 bytes of int8 codes
// or packed4 bytes, i.e. VecLoad<KV>::kElems head-dim columns of one
// stored row.
// hd is a multiple of 8 (constraints.ATTN_HEAD_DIM_ALIGN), so a row splits
// into whole vectors and every vector is aligned once the pool's base is
// (constraints.KV_PTR_ALIGN, checked by the wrapper).
template <int KV> struct VecLoad;
template <> struct VecLoad<kF32> { using T = uint4; static constexpr int kElems = 4; };
template <> struct VecLoad<kBF16> { using T = uint4; static constexpr int kElems = 8; };
template <> struct VecLoad<kInt8> { using T = uint2; static constexpr int kElems = 8; };
template <> struct VecLoad<kPacked4> { using T = uint2; static constexpr int kElems = 8; };
constexpr int kLoadsInFlight = 8;   // vector loads a thread starts before storing

// Widen one loaded vector into tile row r (packed4: rows 2r, 2r+1), columns
// d0.. of the vector.
template <int KV>
__device__ __forceinline__ void store_vec(float (*tile)[kMaxHd + 1], int r,
                                          int d0,
                                          const typename VecLoad<KV>::T& x) {
  constexpr int n = VecLoad<KV>::kElems;
  if (KV == kF32) {
    const float* e = reinterpret_cast<const float*>(&x);
#pragma unroll
    for (int i = 0; i < n; ++i) tile[r][d0 + i] = e[i];
  } else if (KV == kBF16) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
    for (int i = 0; i < n; ++i) tile[r][d0 + i] = to_f32(e[i]);
  } else if (KV == kInt8) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int i = 0; i < n; ++i) tile[r][d0 + i] = static_cast<float>(e[i]);
  } else {
    const uint8_t* e = reinterpret_cast<const uint8_t*>(&x);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const int b = static_cast<int>(e[i]);
      tile[2 * r][d0 + i] = static_cast<float>((b << 28) >> 28);
      tile[2 * r + 1][d0 + i] = static_cast<float>((b << 24) >> 28);
    }
  }
}

// Load the tile's ts slots into tile[j][d] as f32. slot_s[j] is slot j's
// flat index in the (rows or pages) x KV x slots layout; a packed4 pair's
// byte row is slot_s[2jp] / 2 (pairs never straddle a row or a page). Each
// thread starts kLoadsInFlight independent vector loads before it stores
// any, so the loads overlap instead of waiting on each other's latency.
template <int KV>
__device__ __forceinline__ void load_tile(float (*tile)[kMaxHd + 1],
                                          const void* src,
                                          const long long* slot_s, int ts,
                                          int hd) {
  using T = typename VecLoad<KV>::T;
  constexpr int kE = VecLoad<KV>::kElems;
  constexpr int kEltBytes = KV == kF32 ? 4 : (KV == kBF16 ? 2 : 1);
  const char* base = static_cast<const char*>(src);
  const int per_row = hd / kE;
  const int n = (KV == kPacked4 ? ts / 2 : ts) * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kLoadsInFlight) {
    T buf[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int r = i / per_row, c = i % per_row;
        const long long row = KV == kPacked4 ? slot_s[2 * r] / 2 : slot_s[r];
        buf[u] = *reinterpret_cast<const T*>(
            base + (static_cast<size_t>(row) * hd + c * kE) * kEltBytes);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) store_vec<KV>(tile, i / per_row, (i % per_row) * kE, buf[u]);
    }
  }
}

// S counts a row's logical slots (nb * page when PAGED). Unpaged, slot j of
// (b, h) is flat slot bh * S + j; paged, it is (pg * KVH + h) * page +
// j % page with pg = block_table[b * nb + j / page].
template <typename QT, int KV, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos,
                    const int* __restrict__ block_table, QT* __restrict__ out,
                    int KVH, int G, int S, int nb, int page, int hd,
                    int window, float scale) {
  __shared__ float qs[kMaxG][kMaxHd];
  __shared__ float tile[kTileS][kMaxHd + 1];   // K tile, then V tile
  __shared__ float ps[kMaxG][kTileS];          // scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ int ok_s[kTileS];
  __shared__ long long slot_s[kTileS];         // flat slot index in k/v

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * KVH + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool quantized = k_scale != nullptr;
  const int qp = q_pos[b];

  for (int i = threadIdx.x; i < G * hd; i += kThreads)
    qs[i / hd][i % hd] = to_f32(q[bh * G * hd + i]);
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kTileS) {
    const int ts = min(kTileS, S - s0);
    if (threadIdx.x < kTileS) {
      const int j = threadIdx.x;
      const int kp = j < ts ? k_pos[static_cast<size_t>(b) * S + s0 + j] : -1;
      ok_s[j] = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
      if (j < ts) {
        if (PAGED) {
          const int pg = block_table[static_cast<size_t>(b) * nb
                                     + (s0 + j) / page];
          slot_s[j] = (static_cast<long long>(pg) * KVH + h) * page
              + (s0 + j) % page;
        } else {
          slot_s[j] = static_cast<long long>(bh) * S + s0 + j;
        }
      }
    }
    __syncthreads();
    load_tile<KV>(tile, k, slot_s, ts, hd);
    __syncthreads();

    for (int p = threadIdx.x; p < G * kTileS; p += kThreads) {
      const int g = p / kTileS, j = p % kTileS;
      float s = kNegInf;
      if (ok_s[j]) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qs[g][d], tile[j][d], dot);
        if (quantized) dot *= k_scale[slot_s[j]];
        s = dot * scale;
      }
      ps[g][j] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      const float a = ps[g][lane], c = ps[g][lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const bool live = m_new > 0.5f * kNegInf;
      float pa = live ? expf(a - m_new) : 0.f;
      float pc = live ? expf(c - m_new) : 0.f;
      const float sum = warp_sum(pa + pc);
      const float corr = expf(m_prev - m_new);
      if (quantized) {
        if (lane < ts) pa *= v_scale[slot_s[lane]];
        if (lane + 32 < ts) pc *= v_scale[slot_s[lane + 32]];
      }
      ps[g][lane] = pa;
      ps[g][lane + 32] = pc;
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    load_tile<KV>(tile, v, slot_s, ts, hd);
    __syncthreads();

    if (threadIdx.x < hd) {
      const int d = threadIdx.x;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= corr_s[g];
      for (int j = 0; j < ts; ++j) {
        const float vv = tile[j][d];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(ps[g][j], vv, acc[g]);
      }
    }
    __syncthreads();
  }

  if (threadIdx.x < hd) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
        out[(bh * G + g) * hd + threadIdx.x] =
            from_f32<QT>(acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename QT, bool PAGED>
int launch_q(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* q_pos, const void* k_pos,
             const void* block_table, void* out, int B, int KVH, int G, int S,
             int nb, int ps, int hd, int window, float scale, int kv_kind,
             cudaStream_t stream) {
  const dim3 grid(KVH, B);
  const QT* qq = static_cast<const QT*>(q);
  QT* oo = static_cast<QT*>(out);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const int* bt = static_cast<const int*>(block_table);
  switch (kv_kind) {
    case kF32:
      flash_decode_kernel<QT, kF32, PAGED><<<grid, kThreads, 0, stream>>>(
          qq, k, v, kss, vss, qp, kp, bt, oo, KVH, G, S, nb, ps, hd, window,
          scale);
      break;
    case kBF16:
      flash_decode_kernel<QT, kBF16, PAGED><<<grid, kThreads, 0, stream>>>(
          qq, k, v, kss, vss, qp, kp, bt, oo, KVH, G, S, nb, ps, hd, window,
          scale);
      break;
    case kInt8:
      flash_decode_kernel<QT, kInt8, PAGED><<<grid, kThreads, 0, stream>>>(
          qq, k, v, kss, vss, qp, kp, bt, oo, KVH, G, S, nb, ps, hd, window,
          scale);
      break;
    case kPacked4:
      flash_decode_kernel<QT, kPacked4, PAGED><<<grid, kThreads, 0, stream>>>(
          qq, k, v, kss, vss, qp, kp, bt, oo, KVH, G, S, nb, ps, hd, window,
          scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out (B, KVH, G, hd) f32/bf16 (q_bf16); k, v per kv_kind (0 f32, 1 bf16,
// 2 int8, 3 packed4 (B, KVH, S/2, hd) uint8); k_scale, v_scale (B, KVH, S)
// f32 or null; q_pos (B,) and k_pos (B, S) int32. S counts logical slots.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* q_pos, const void* k_pos,
                                   void* out, int B, int KVH, int G, int S,
                                   int hd, int window, int kv_kind, int q_bf16,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16
      ? launch_q<__nv_bfloat16, false>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                                       nullptr, out, B, KVH, G, S, 0, 1, hd,
                                       window, scale, kv_kind, s)
      : launch_q<float, false>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                               nullptr, out, B, KVH, G, S, 0, 1, hd, window,
                               scale, kv_kind, s);
}

// K5. q, out as above; k, v the page pools (P, KVH, ps, hd) per kv_kind
// (packed4: (P, KVH, ps/2, hd) uint8); k_scale, v_scale (P, KVH, ps) f32 or
// null; block_table (B, nb) int32, every entry a valid page; q_pos (B,) and
// k_pos (B, nb * ps) int32. ps is even.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* q_pos, const void* k_pos,
    const void* block_table, void* out, int B, int KVH, int G, int nb, int ps,
    int hd, int window, int kv_kind, int q_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16
      ? launch_q<__nv_bfloat16, true>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                                      block_table, out, B, KVH, G, nb * ps, nb,
                                      ps, hd, window, scale, kv_kind, s)
      : launch_q<float, true>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                              block_table, out, B, KVH, G, nb * ps, nb, ps, hd,
                              window, scale, kv_kind, s);
}
