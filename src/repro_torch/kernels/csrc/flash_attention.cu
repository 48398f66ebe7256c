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
// What bounds it on an H100: operations. A 256-token causal prefill of 32
// heads at hd = 96 does 2·2·h·(S(S+1)/2)·hd ≈ 0.4 GFLOP on 9 MB of
// q/k/v/out. The models compute in f32; the tensor cores take f32 only as
// TF32 (495 TFLOP/s), whose single product keeps ~1e-3 relative error,
// far above the 1e-4 gate. So the f32 instantiation runs the 3×TF32
// split: x = hi + lo with hi = x rounded to TF32, lo = x − hi, and
// a·b ≈ hi·hi + hi·lo + lo·hi summed in f32 — about f32 accuracy at a
// third of the TF32 rate (~165 TFLOP/s), still 2.5× the CUDA cores'
// 67 TFLOP/s f32 peak that chip_smoke.py's bound uses.
//
// Design (FlashAttention-2 on mma.sync):
// - A block of 8 warps owns 64 query rows of one head (h, g): 4 row warps
//   of 16 rows each, times 2 key groups that split every 64-key tile (32
//   keys each) and merge their (max, sum, O) through shared memory at the
//   end. Each warp keeps its 16 rows of Q in registers as mma A fragments,
//   loaded once. The KV head is indexed as h // G in place (q (B, Sq, KV,
//   G, hd), k/v (B, Sk, KV, hd)): nothing is broadcast or transposed.
// - QKᵀ and P·V are warp-level mma.sync: m16n8k8 TF32 with the 3×TF32
//   split for f32, m16n8k16 bf16 with f32 accumulators for bf16. There
//   P·V runs P as two bf16 terms, hi = bf16(p) and lo = bf16(p − hi):
//   FlashAttention-2's single bf16 P moved outputs by one bf16 ulp
//   (2^-6 at |out| in [2, 4)) against the plain version, past the 2^-8
//   gate of the output scale, on the card. The scores stay in registers;
//   the running max and sum per row live in the four threads of a quad
//   and reduce with two shuffles; the score fragment is reused as P·V's
//   A operand with no trip through shared memory (TF32: P·V's k index t
//   ↔ key 2t, t+4 ↔ key 2t+1, and V's B fragment is read in the same key
//   order).
// - K and V have separate shared-memory buffers, double-buffered and
//   filled by cp.async (16-byte chunks, zero-filled past Sk): the loads of
//   the next live key tile are in flight while this tile is multiplied.
//   Rows are padded by 16 bytes so fragment reads hit distinct banks.
//   Dynamic shared memory: f32 100 KB at hd 96 and 132 KB at hd 128
//   (opted in with cudaFuncSetAttribute), bf16 52 / 68 KB.
// - Dead tiles are skipped from the positions: the block reads its rows'
//   min and max q_pos, and a key tile is walked only if one of its keys
//   has k_pos >= 0, (causal) k_pos <= max q_pos and (window) k_pos >
//   min q_pos − window. Partially valid tiles are masked per element. In
//   a causal 256-token prefill 6 of 16 (query tile, key tile) pairs are
//   skipped; in chunk mode the stored slots at k_pos = −1 are never
//   loaded.
// - Query tiles run heaviest first (the last causal tile walks the most
//   keys). Grid (ceil(Sq / 64), B·KV·G): 4 × 32 = 128 blocks for a phi3
//   prefill (S = 256, 32 heads) and 4 × 16 = 64 for deepseek-moe-16b's,
//   against 132 SMs — one wave. `nvcc -Xptxas -v` (CUDA 12.8): f32 255
//   registers with 8 bytes spilled, bf16 168 registers, 64 bytes of
//   static shared memory; 256 threads at 255 registers take a whole SM's
//   register file, so one f32 block runs per SM. Splitting into TF32 with
//   integer ops instead of cvt.rna.tf32 (the conversion pipe) made the
//   f32 kernel about a quarter faster on the card; keeping f32 Q's
//   fragments in shared memory (no spill), 8-byte K fragment reads, and
//   32-row blocks of 2 row warps × 4 key groups (faster at deepseek's 16
//   heads, two waves at phi3's 32) did not pay. The critical path is the
//   last causal query tile: its block walks 4 of the 4 key tiles while
//   the first walks 1.
// - hd is any multiple of 8 up to 128: fragments past hd are zero.
//
// The wide instance (WIDE): hd past 128, up to kWideHd = 256
// (recurrentgemma-9b's local layers: 16 query heads over one KV head, a
// window of 2048). At 256 the output fragment alone is 128 f32 a lane,
// f32 Q's fragments another 128, and a 64-key f32 K + V tile pair
// double-buffered 266 KB, over the 227 KB a block may have. So:
// - the two warps of a row warp split the output columns instead of the
//   key tile: each scores all keys of the tile against the full head
//   (the same scores, computed twice: QKᵀ is half the products) and owns
//   128 of the output columns, 64 f32 a lane as at hd 128; no end merge;
// - Q's 64 × hd tile is copied once into shared memory and each k-step's
//   A fragment read from there (4 values), not held in registers;
// - key tiles are 32 keys (kWideBK): K and V double-buffered plus Q take
//   195 KB in f32 (one block an SM) and 98 KB in bf16, at hd 256.
// The masks, the dead-tile skip (which honours the window, so a long
// local prefill walks only the tiles within 2048 of its rows) and the
// numerics (3×TF32, bf16 P as hi + lo) are the narrow instance's.
//
// The limits below repeat src/repro_torch/kernels/constraints.py.
#include <cfloat>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 4;      // warps over a block's query rows
constexpr int kKeyGroups = 2;     // ... times groups over a tile's keys
constexpr int kWarps = kRowWarps * kKeyGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kRowWarps;  // constraints.ATTN_Q_TILE: 16 rows a warp
constexpr int kBK = 64;           // constraints.ATTN_K_TILE: keys per tile
constexpr int kSubK = kBK / kKeyGroups;   // keys of a tile one warp scores
constexpr int kNT = kSubK / 8;            // its 8-key n-tiles
constexpr int kMaxHd = 128;       // constraints.ATTN_MAX_HEAD_DIM
constexpr int kWideHd = 256;      // constraints.ATTN_WIDE_HEAD_DIM
constexpr int kWideBK = 32;       // constraints.ATTN_WIDE_K_TILE
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may opt in to
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (half up in
// magnitude, by integer ops: cvt.rna.tf32 runs on the slower conversion
// pipe), lo = x − hi exactly, handed to the tensor core as f32 bits,
// which it reads as TF32 (the low 13 bits dropped). Finite inputs only.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split once into hi + lo, reused over the n-tiles.
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], hi[e], lo[e]);
  }
};

// 3×TF32: d += a·b with a, b split into hi + lo (lo·lo dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const SplitA& a,
                                           const float (&b)[2]) {
  uint32_t bhi[2], blo[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) split_tf32(b[e], bhi[e], blo[e]);
  const uint32_t (&ahi)[4] = a.hi;
  const uint32_t (&alo)[4] = a.lo;
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The tiling of an instance: keys a tile, keys a warp scores of it, the
// widest head, and the output columns a warp owns (128 in both).
template <bool WIDE>
struct Tiling {
  static constexpr int kTileK = WIDE ? kWideBK : kBK;
  static constexpr int kWarpK = WIDE ? kTileK : kSubK;
  static constexpr int kHd = WIDE ? kWideHd : kMaxHd;
};

// Shared memory: K and V tiles [2][kTileK][ld] each (ld = hd + 16 bytes of
// padding), (WIDE) the Q tile [kBQ][ld], the tiles' k_pos [2][kTileK],
// then one live flag per key tile.
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return 16 / static_cast<int>(sizeof(T));
}
template <typename T, bool WIDE>
size_t smem_bytes(int hd, int n_tiles) {
  constexpr int bk = Tiling<WIDE>::kTileK;
  return ((4 * static_cast<size_t>(bk) + (WIDE ? kBQ : 0))
          * (hd + row_pad<T>())) * sizeof(T)
      + (2 * bk + n_tiles) * sizeof(int);
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ out,
                       int Sq, int Sk, int KVH, int G, int hd, int causal,
                       int window, float scale) {
  constexpr bool kBf = sizeof(T) == 2;
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // elems a cp.async
  constexpr int kBK = Tiling<WIDE>::kTileK;     // keys a tile
  constexpr int kSubK = Tiling<WIDE>::kWarpK;   // keys of a tile a warp scores
  constexpr int kNT = kSubK / 8;                // its 8-key n-tiles
  constexpr int kHdMax = Tiling<WIDE>::kHd;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qlo_s[kWarps], qhi_s[kWarps];
  const int ld = hd + row_pad<T>();
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + 2 * kBK * ld;
  T* qs = vs + 2 * kBK * ld;                    // WIDE: the Q tile
  int* kp_s = reinterpret_cast<int*>(qs + (WIDE ? kBQ * ld : 0));
  int* live = kp_s + 2 * kBK;

  const int head = blockIdx.y;                 // b·KV·G + h·G + g
  const int g = head % G;
  const int h = (head / G) % KVH;              // the KV head: (h·G + g) // G
  const int b = head / (G * KVH);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest tile first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;    // mma fragment coordinates
  const size_t q_row = static_cast<size_t>(KVH) * G * hd;   // q stride over i
  const size_t k_row = static_cast<size_t>(KVH) * hd;       // k stride over j
  const T* qb = q + static_cast<size_t>(b) * Sq * q_row
      + (static_cast<size_t>(h) * G + g) * hd;
  const T* kb = k + static_cast<size_t>(b) * Sk * k_row
      + static_cast<size_t>(h) * hd;
  const T* vb = v + static_cast<size_t>(b) * Sk * k_row
      + static_cast<size_t>(h) * hd;
  const int n_tiles = (Sk + kBK - 1) / kBK;

  // the block's query positions → which key tiles hold a valid pair
  {
    int lo = INT_MAX, hi = INT_MIN;
    if (threadIdx.x < kBQ && i0 + threadIdx.x < Sq)
      lo = hi = q_pos[i0 + threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      qlo_s[warp] = lo;
      qhi_s[warp] = hi;
    }
  }
  __syncthreads();
  int qlo = qlo_s[0], qhi = qhi_s[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    qlo = min(qlo, qlo_s[w]);
    qhi = max(qhi, qhi_s[w]);
  }
  for (int t = warp; t < n_tiles; t += kWarps) {
    bool any = false;
    for (int jj = lane; jj < kBK; jj += 32) {
      const int j = t * kBK + jj;
      if (j < Sk) {
        const int kp = k_pos[j];
        any |= kp >= 0 && (!causal || kp <= qhi)
            && (window <= 0 || static_cast<long long>(kp) >
                                   static_cast<long long>(qlo) - window);
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live[t] = any;
  }
  __syncthreads();

  auto next_live = [&](int t) {
    while (t < n_tiles && !live[t]) ++t;
    return t;
  };
  // a thread copies chunk lc of rows lr, lr + rows_per_pass, ... (no
  // division in the loop)
  const int per_row = hd / kChunk;
  const int rows_per_pass = kThreads / per_row;
  const int lr = threadIdx.x / per_row, lc = threadIdx.x % per_row;
  auto load_tile = [&](int t, int buf) {
    const int j0 = t * kBK;
    for (int r = lr; r < kBK && lr < rows_per_pass; r += rows_per_pass) {
      const bool ok = j0 + r < Sk;
      const size_t off = (ok ? static_cast<size_t>(j0 + r) * k_row : 0)
          + lc * kChunk;
      const int so = (buf * kBK + r) * ld + lc * kChunk;
      cp_async16(ks + so, kb + off, ok);
      cp_async16(vs + so, vb + off, ok);
    }
    if (threadIdx.x < kBK)
      kp_s[buf * kBK + threadIdx.x] =
          j0 + threadIdx.x < Sk ? k_pos[j0 + threadIdx.x] : -1;
    cp_async_commit();
  };

  int t = next_live(0);
  if (t < n_tiles) {
    if constexpr (WIDE) {   // the Q tile joins the first tile's copy group
      for (int i = threadIdx.x; i < kBQ * per_row; i += kThreads) {
        const int r = i / per_row, c = (i % per_row) * kChunk;
        const bool ok = i0 + r < Sq;
        cp_async16(qs + r * ld + c,
                   qb + (ok ? static_cast<size_t>(i0 + r) * q_row : 0) + c,
                   ok);
      }
    }
    load_tile(t, 0);
  }

  // this thread's two query rows and their Q fragments (zero past Sq/hd)
  // group: which half of each key tile (WIDE: which 128 output columns)
  const int group = warp / kRowWarps;
  const int koff = WIDE ? 0 : group * kSubK;  // the warp's first key of a tile
  const int cbase = WIDE ? group * kMaxHd : 0;  // its first output column
  const int r0 = i0 + (warp % kRowWarps) * 16 + gid, r1 = r0 + 8;
  const int qp0 = r0 < Sq ? q_pos[r0] : qhi;
  const int qp1 = r1 < Sq ? q_pos[r1] : qhi;
  constexpr int kKSteps = kBf ? kHdMax / 16 : kHdMax / 8;
  // WIDE reads each step's fragment from the Q tile instead
  float qf[kBf || WIDE ? 1 : kKSteps][4];
  uint32_t qa[kBf && !WIDE ? kKSteps : 1][4];
#pragma unroll
  for (int st = 0; st < (WIDE ? 0 : kKSteps); ++st) {
    if constexpr (kBf) {
      const int c0 = 16 * st + 2 * tig, c1 = c0 + 8;
      const T* q0 = qb + static_cast<size_t>(r0) * q_row;
      const T* q1 = qb + static_cast<size_t>(r1) * q_row;
      qa[st][0] = r0 < Sq && c0 < hd ? ld32(q0 + c0) : 0u;
      qa[st][1] = r1 < Sq && c0 < hd ? ld32(q1 + c0) : 0u;
      qa[st][2] = r0 < Sq && c1 < hd ? ld32(q0 + c1) : 0u;
      qa[st][3] = r1 < Sq && c1 < hd ? ld32(q1 + c1) : 0u;
    } else {
      const int c0 = 8 * st + tig, c1 = c0 + 4;
      const bool in = 8 * st < hd;
      const T* q0 = qb + static_cast<size_t>(r0) * q_row;
      const T* q1 = qb + static_cast<size_t>(r1) * q_row;
      qf[st][0] = in && r0 < Sq ? static_cast<float>(q0[c0]) : 0.f;
      qf[st][1] = in && r1 < Sq ? static_cast<float>(q1[c0]) : 0.f;
      qf[st][2] = in && r0 < Sq ? static_cast<float>(q0[c1]) : 0.f;
      qf[st][3] = in && r1 < Sq ? static_cast<float>(q1[c1]) : 0.f;
    }
  }

  float o[kMaxHd / 8][4];
#pragma unroll
  for (int dn = 0; dn < kMaxHd / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows r0, r1 (log2 units)
  float l0 = 0.f, l1 = 0.f;           // this thread's part of the row sums
  const float sl2 = scale * kLog2e;
  int buf = 0;

  while (t < n_tiles) {
    const int tn = next_live(t + 1);
    if (tn < n_tiles) {
      load_tile(tn, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {
      const T* kt = ks + (buf * kBK + koff) * ld;
      const T* vt = vs + (buf * kBK + koff) * ld;
      const int* kpt = kp_s + buf * kBK + koff;
      const T* q0s = qs + ((warp % kRowWarps) * 16 + gid) * ld;  // WIDE
      const T* q1s = q0s + 8 * ld;

      // S = Q·Kᵀ: 16 rows × kSubK keys a warp
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int st = 0; st < kKSteps; ++st) {
        if constexpr (kBf) {
          if (16 * st < hd) {
            uint32_t qw[4];
            if constexpr (WIDE) {
              const int c0 = 16 * st + 2 * tig, c1 = c0 + 8;
              qw[0] = ld32(q0s + c0);
              qw[1] = ld32(q1s + c0);
              qw[2] = c1 < hd ? ld32(q0s + c1) : 0u;
              qw[3] = c1 < hd ? ld32(q1s + c1) : 0u;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) qw[e] = qa[st][e];
            }
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              const T* kr = kt + (8 * n + gid) * ld + 16 * st + 2 * tig;
              const uint32_t bb[2] = {ld32(kr),
                                      16 * st + 8 < hd ? ld32(kr + 8) : 0u};
              mma_bf16(s[n], qw, bb);
            }
          }
        } else {
          if (8 * st < hd) {
            float qv[4];
            if constexpr (WIDE) {
              const int c0 = 8 * st + tig;
              qv[0] = q0s[c0];
              qv[1] = q1s[c0];
              qv[2] = q0s[c0 + 4];
              qv[3] = q1s[c0 + 4];
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) qv[e] = qf[st][e];
            }
            const SplitA a(qv);
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              const T* kr = kt + (8 * n + gid) * ld + 8 * st + tig;
              const float bb[2] = {kr[0], kr[4]};
              mma_3xtf32(s[n], a, bb);
            }
          }
        }
      }

      // mask, scale to log2 units, online softmax per row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kpt[8 * n + 2 * tig + e];
          bool ok0 = kp >= 0, ok1 = kp >= 0;
          if (causal) {
            ok0 = ok0 && qp0 >= kp;
            ok1 = ok1 && qp1 >= kp;
          }
          if (window > 0) {
            ok0 = ok0 && qp0 - kp < window;
            ok1 = ok1 && qp1 - kp < window;
          }
          s[n][e] = ok0 ? s[n][e] * sl2 : kNegInf;
          s[n][2 + e] = ok1 ? s[n][2 + e] * sl2 : kNegInf;
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        s[n][0] = exp2f(s[n][0] - m0);
        s[n][1] = exp2f(s[n][1] - m0);
        s[n][2] = exp2f(s[n][2] - m1);
        s[n][3] = exp2f(s[n][3] - m1);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int dn = 0; dn < kMaxHd / 8; ++dn) {
        o[dn][0] *= c0;
        o[dn][1] *= c0;
        o[dn][2] *= c1;
        o[dn][3] *= c1;
      }

      // O += P·V, P straight from the score fragments
      if constexpr (kBf) {
#pragma unroll
        for (int j = 0; j < kSubK / 16; ++j) {
          // P = hi + lo, both bf16: a bf16 P alone moves an output by up
          // to an ulp of its own, which the 2^-8 gate does not allow
          const float p8[8] = {s[2 * j][0], s[2 * j][1], s[2 * j][2],
                               s[2 * j][3], s[2 * j + 1][0], s[2 * j + 1][1],
                               s[2 * j + 1][2], s[2 * j + 1][3]};
          uint32_t phi[4], plo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat16 h0 = __float2bfloat16(p8[2 * e]);
            const __nv_bfloat16 h1 = __float2bfloat16(p8[2 * e + 1]);
            phi[e] = pack_bf16(h0, h1);
            plo[e] = pack_bf16(p8[2 * e] - __bfloat162float(h0),
                               p8[2 * e + 1] - __bfloat162float(h1));
          }
          const T* v0 = vt + (16 * j + 2 * tig) * ld + cbase + gid;
#pragma unroll
          for (int dn = 0; dn < kMaxHd / 8; ++dn) {
            if (cbase + 8 * dn < hd) {
              const T* vr = v0 + 8 * dn;
              const uint32_t bb[2] = {pack_bf16(vr[0], vr[ld]),
                                      pack_bf16(vr[8 * ld], vr[9 * ld])};
              mma_bf16(o[dn], plo, bb);
              mma_bf16(o[dn], phi, bb);
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          // k index t ↔ key 8j + 2t, k index t + 4 ↔ key 8j + 2t + 1
          const float p4[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          const SplitA pa(p4);
          const T* v0 = vt + (8 * j + 2 * tig) * ld + cbase + gid;
#pragma unroll
          for (int dn = 0; dn < kMaxHd / 8; ++dn) {
            if (cbase + 8 * dn < hd) {
              const T* vr = v0 + 8 * dn;
              const float bb[2] = {vr[0], vr[ld]};
              mma_3xtf32(o[dn], pa, bb);
            }
          }
        }
      }
    }
    __syncthreads();   // this buffer is refilled two tiles from now
    buf ^= 1;
    t = tn;
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // the second key group hands its (m, l, O) to the first through the
  // idle tile buffers; the first merges and writes the output (WIDE: each
  // warp scored every key, and writes its own columns)
  if constexpr (!WIDE) {
    float* xo = reinterpret_cast<float*>(smem)
        + (warp % kRowWarps) * 16 * (hd + 2);    // [16 rows][hd | m | l]
    if (group == 1) {
#pragma unroll
      for (int dn = 0; dn < kMaxHd / 8; ++dn) {
        if (8 * dn < hd) {
          float* x0 = xo + gid * (hd + 2) + 8 * dn + 2 * tig;
          float* x1 = x0 + 8 * (hd + 2);
          x0[0] = o[dn][0];
          x0[1] = o[dn][1];
          x1[0] = o[dn][2];
          x1[1] = o[dn][3];
        }
      }
      if (tig == 0) {
        xo[gid * (hd + 2) + hd] = m0;
        xo[gid * (hd + 2) + hd + 1] = l0;
        xo[(gid + 8) * (hd + 2) + hd] = m1;
        xo[(gid + 8) * (hd + 2) + hd + 1] = l1;
      }
    }
    __syncthreads();
    if (group == 1) return;
    {
      const float* x0 = xo + gid * (hd + 2);
      const float* x1 = x0 + 8 * (hd + 2);
      const float mx0 = fmaxf(m0, x0[hd]), mx1 = fmaxf(m1, x1[hd]);
      const float a0 = exp2f(m0 - mx0), b0 = exp2f(x0[hd] - mx0);
      const float a1 = exp2f(m1 - mx1), b1 = exp2f(x1[hd] - mx1);
      l0 = l0 * a0 + x0[hd + 1] * b0;
      l1 = l1 * a1 + x1[hd + 1] * b1;
#pragma unroll
      for (int dn = 0; dn < kMaxHd / 8; ++dn) {
        if (8 * dn < hd) {
          const int c = 8 * dn + 2 * tig;
          o[dn][0] = o[dn][0] * a0 + x0[c] * b0;
          o[dn][1] = o[dn][1] * a0 + x0[c + 1] * b0;
          o[dn][2] = o[dn][2] * a1 + x1[c] * b1;
          o[dn][3] = o[dn][3] * a1 + x1[c + 1] * b1;
        }
      }
    }
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  T* o0 = out + static_cast<size_t>(b) * Sq * q_row
      + (static_cast<size_t>(h) * G + g) * hd + cbase + 2 * tig;
#pragma unroll
  for (int dn = 0; dn < kMaxHd / 8; ++dn) {
    if (cbase + 8 * dn < hd) {
      if constexpr (kBf) {
        if (r0 < Sq)
          *reinterpret_cast<uint32_t*>(o0 + r0 * q_row + 8 * dn) =
              pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
        if (r1 < Sq)
          *reinterpret_cast<uint32_t*>(o0 + r1 * q_row + 8 * dn) =
              pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
      } else {
        if (r0 < Sq)
          *reinterpret_cast<float2*>(o0 + r0 * q_row + 8 * dn) =
              make_float2(o[dn][0] * inv0, o[dn][1] * inv0);
        if (r1 < Sq)
          *reinterpret_cast<float2*>(o0 + r1 * q_row + 8 * dn) =
              make_float2(o[dn][2] * inv1, o[dn][3] * inv1);
      }
    }
  }
}

template <typename T, bool WIDE>
int launch(const void* q, const void* k, const void* v, const int* qp,
           const int* kp, void* out, int B, int Sq, int Sk, int KVH, int G,
           int hd, int causal, int window, float scale, cudaStream_t s) {
  constexpr int bk = Tiling<WIDE>::kTileK;
  const size_t smem = smem_bytes<T, WIDE>(hd, (Sk + bk - 1) / bk);
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t opted = 48 * 1024;   // the default a launch may use
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * KVH * G);
  flash_attention_kernel<T, WIDE><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qp, kp, static_cast<T*>(out), Sq, Sk, KVH, G,
      hd, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const int* qp,
              const int* kp, void* out, int B, int Sq, int Sk, int KVH, int G,
              int hd, int causal, int window, float scale, cudaStream_t s) {
  if (hd < 8 || hd % 8 || hd > kWideHd)
    return static_cast<int>(cudaErrorInvalidValue);
  return hd > kMaxHd
      ? launch<T, true>(q, k, v, qp, kp, out, B, Sq, Sk, KVH, G, hd, causal,
                        window, scale, s)
      : launch<T, false>(q, k, v, qp, kp, out, B, Sq, Sk, KVH, G, hd, causal,
                         window, scale, s);
}

// q, out (B, Sq, KVH, G, hd); k, v (B, Sk, KVH, hd); all f32 or all bf16
// (bf16 != 0), 16-byte aligned; q_pos (Sq,), k_pos (Sk,) int32 with
// k_pos = -1 invalid; hd a multiple of 8 up to 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int Sq, int Sk, int KVH, int G, int hd,
                                      int causal, int window, int bf16,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  return bf16 ? launch_hd<__nv_bfloat16>(q, k, v, qp, kp, out, B, Sq, Sk, KVH,
                                         G, hd, causal, window, scale, s)
              : launch_hd<float>(q, k, v, qp, kp, out, B, Sq, Sk, KVH, G, hd,
                                 causal, window, scale, s);
}
