// K1, K2 and K6: the fused MXINT Q + LR matmul,
// y = x·dequant(codes, scale) + (x·L)·R.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/mxint_matmul.py:
//   K1  mxint_lowrank_matmul_fused_2d (body _fused_kernel): x·L accumulated
//       in the same pass over K — the decode regime (rows <= 128);
//   K2  mxint_lowrank_matmul_2d (body _kernel): xl = x·L precomputed by the
//       caller and added at the end — the prefill regime (rows > 128);
//   K6  mxint_lowrank_matmul_batched_2d (body _batched_kernel): K2 over a
//       leading stack of E independent int8 weights — every MoE expert
//       projection, on the (E, capacity, K) dispatch buffer.
//
// What bounds it on an H100: at decode (M = 8 lanes) the codes dominate
// the bytes — a 3072×8192 int8 projection is 25 MB against 0.2 MB of
// activations — so the kernel has to stream every code byte exactly once,
// coalesced, from as many SMs as the card has. At M = 8 the f32 FMAs on
// the CUDA cores (M·K·N) take about as long as the bytes, so the inner
// loop does nothing but one 32-bit code load, four converts, four scale
// multiplies and 4·MT FMAs against x held in shared memory.
//
// Design:
//   * the TPU kernel walks K as a sequential grid axis with the output
//     tile resident in VMEM; here K is split across blocks instead
//     (kSplitRows rows each, grid.y), so even a 3072-column projection
//     puts 24 × 6 = 144 blocks on the 132 SMs. Each block writes its
//     partial (MT, 128) tile to a workspace, and a second small kernel
//     sums the splits in a fixed order (deterministic, no atomics) and
//     adds the low-rank term (x·L)·R;
//   * a warp reads one MXINT block row at a time: 32 lanes × 4 columns =
//     one 128-byte coalesced load of int8 codes (64 bytes of a packed4
//     row pair), one float4 of scales per 32 rows;
//   * packed4 codes are unpacked in registers with the shift-based sign
//     extension of repro.quant.mxint.unpack_codes_4bit (low nibble = row
//     2i, high nibble = row 2i+1), so packed weights stream at half the
//     int8 bytes and are never expanded in memory;
//   * K1 computes x·L only in the blocks of the first column tile (the
//     sliver does not depend on N), where the TPU kernel recomputes it per
//     N block; K2 reads the precomputed sliver in the finishing kernel.
//   * rank 0 needs no zero sliver: the low-rank loops simply run empty;
//   * K6 is K2's body instantiated with STACKED: the stack entry is folded
//     into grid.z next to the row tile (z = entry · row_tiles + tile),
//     every block offsets its pointers by its entry's strides, and the
//     finishing kernel takes the entry from its own grid.z. K1 and K2
//     compile without that arithmetic, which slowed K1 on the card
//     (PERF.md). At decode (M = 8 lanes, E = 64 experts, K = 2048,
//     N = 1408) one gate/up call streams 185 MB of codes from 64 · 4 · 11
//     = 2816 blocks; the tile is 8 rows up to 8 rows, 16 above.
//
// The limits below repeat src/repro_torch/kernels/constraints.py, whose
// wrapper checks raise before a launch the kernel cannot take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMxBlock = 32;      // constraints.MXINT_BLOCK
constexpr int kColsPerLane = 4;   // constraints.QLR_COL_VEC
constexpr int kMaxRank = 64;      // constraints.QLR_MAX_RANK
constexpr int kSplitRows = 512;   // constraints.QLR_SPLIT_ROWS
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 32 * kColsPerLane;  // 128 output columns per block
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Byte c of a 32-bit word as a sign-extended int8 code.
__device__ __forceinline__ int int8_at(uint32_t word, int c) {
  return static_cast<int>(word << (24 - 8 * c)) >> 24;
}

// Nibbles of byte c: low = row 2i, high = row 2i+1, sign-extended by
// shifts in int32 exactly as unpack_codes_4bit does.
__device__ __forceinline__ int nib_lo(uint32_t word, int c) {
  const int b = static_cast<int>((word >> (8 * c)) & 0xFFu);
  return (b << 28) >> 28;
}
__device__ __forceinline__ int nib_hi(uint32_t word, int c) {
  const int b = static_cast<int>((word >> (8 * c)) & 0xFFu);
  return (b << 24) >> 28;
}

// One (column tile, K split, row tile) block of partial sums.
//   x       (M, K) f32 or bf16
//   codes   (K, N) int8, or (K/2, N) packed4 uint8
//   scale   (K/32, N) f32
//   l       (K, rank) f32                     FUSED only
//   part    (splits, M, N) f32   partial x·dequant(codes) per K split
//   xl_part (splits, M, rank) f32 partial x·L per K split   FUSED only
// STACKED (K6): x, codes, scale and part carry a leading entry axis and
// grid.z = entries · row_tiles.
template <int MT, bool PACKED, bool FUSED, bool STACKED, typename XT>
__global__ void __launch_bounds__(kThreads)
qlr_partial_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                   const float* __restrict__ scale, const float* __restrict__ l,
                   float* __restrict__ part, float* __restrict__ xl_part,
                   int M, int K, int N, int rank, int row_tiles) {
  __shared__ float xs[kSplitRows][MT];              // x tile, transposed
  __shared__ float red[MT][kTileN];                 // cross-warp reduction
  __shared__ float xlr[FUSED ? MT : 1][kMaxRank];   // x·L reduction

  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  int m0 = blockIdx.z * MT;
  if (STACKED) {
    const size_t entry = blockIdx.z / row_tiles;
    m0 = (blockIdx.z % row_tiles) * MT;
    x += entry * M * K;
    codes += entry * (PACKED ? K / 2 : K) * N;
    scale += entry * (K / kMxBlock) * N;
    part += entry * gridDim.y * M * N;
  }
  const int k_begin = split * kSplitRows;
  const int rows = min(K - k_begin, kSplitRows);    // a multiple of 32
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < rows * MT; i += kThreads) {
    const int kk = i % rows;
    const int m = i / rows;
    xs[kk][m] = (m0 + m < M)
        ? to_f32(x[static_cast<size_t>(m0 + m) * K + k_begin + kk]) : 0.f;
  }
  __syncthreads();

  const int n = n0 + lane * kColsPerLane;
  const bool col_ok = n < N;                 // N % 4 == 0: all 4 or none
  const bool do_xl = FUSED && blockIdx.x == 0;

  float acc[MT][kColsPerLane];
  float xl_acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[m][c] = 0.f;
    xl_acc[m][0] = 0.f;
    xl_acc[m][1] = 0.f;
  }

  for (int blk = warp; blk < rows / kMxBlock; blk += kWarps) {
    const int kb = k_begin + blk * kMxBlock;        // first row of the block
    const int kr = blk * kMxBlock;                  // same row, in xs
    if (col_ok) {
      const float4 sc4 = *reinterpret_cast<const float4*>(
          scale + static_cast<size_t>(kb / kMxBlock) * N + n);
      const float sc[kColsPerLane] = {sc4.x, sc4.y, sc4.z, sc4.w};
#pragma unroll 4
      for (int j = 0; j < kMxBlock; j += 2) {       // one row pair per step
        float w0[kColsPerLane], w1[kColsPerLane];
        if (PACKED) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              codes + static_cast<size_t>((kb + j) / 2) * N + n);
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            w0[c] = static_cast<float>(nib_lo(word, c)) * sc[c];
            w1[c] = static_cast<float>(nib_hi(word, c)) * sc[c];
          }
        } else {
          const uint32_t word0 = *reinterpret_cast<const uint32_t*>(
              codes + static_cast<size_t>(kb + j) * N + n);
          const uint32_t word1 = *reinterpret_cast<const uint32_t*>(
              codes + static_cast<size_t>(kb + j + 1) * N + n);
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            w0[c] = static_cast<float>(int8_at(word0, c)) * sc[c];
            w1[c] = static_cast<float>(int8_at(word1, c)) * sc[c];
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float x0 = xs[kr + j][m];
          const float x1 = xs[kr + j + 1][m];
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            acc[m][c] = fmaf(x0, w0[c], acc[m][c]);
            acc[m][c] = fmaf(x1, w1[c], acc[m][c]);
          }
        }
      }
    }
    if (do_xl) {
      for (int j = 0; j < kMxBlock; ++j) {
        const float* lrow = l + static_cast<size_t>(kb + j) * rank;
        const float l0 = lane < rank ? lrow[lane] : 0.f;
        const float l1 = lane + 32 < rank ? lrow[lane + 32] : 0.f;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[kr + j][m];
          xl_acc[m][0] = fmaf(xv, l0, xl_acc[m][0]);
          xl_acc[m][1] = fmaf(xv, l1, xl_acc[m][1]);
        }
      }
    }
  }

  // cross-warp reduction in a fixed warp order (deterministic)
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          float* dst = &red[m][lane * kColsPerLane + c];
          *dst = (w == 0 ? 0.f : *dst) + acc[m][c];
        }
        if (do_xl) {
          xlr[m][lane] = (w == 0 ? 0.f : xlr[m][lane]) + xl_acc[m][0];
          xlr[m][lane + 32] = (w == 0 ? 0.f : xlr[m][lane + 32])
              + xl_acc[m][1];
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < MT * kTileN; i += kThreads) {
    const int m = i / kTileN;
    const int col = n0 + i % kTileN;
    if (m0 + m < M && col < N)
      part[(static_cast<size_t>(split) * M + m0 + m) * N + col] =
          red[m][i % kTileN];
  }
  if (do_xl) {
    for (int i = threadIdx.x; i < MT * rank; i += kThreads) {
      const int m = i / rank;
      if (m0 + m < M)
        xl_part[(static_cast<size_t>(split) * M + m0 + m) * rank + i % rank] =
            xlr[m][i % rank];
    }
  }
}

// y[m, n] = Σ_split part[split, m, n] + Σ_r xl[m, r]·R[r, n], where xl is
// Σ_split xl_part (K1) or the caller's precomputed sliver (K2, K6).
// STACKED (K6): part, xl, r and y carry a leading entry axis: grid.z.
template <bool FUSED, bool STACKED>
__global__ void __launch_bounds__(kFinishThreads)
qlr_finish_kernel(const float* __restrict__ part, int splits,
                  const float* __restrict__ xl, const float* __restrict__ r,
                  float* __restrict__ y, int M, int N, int rank) {
  __shared__ float xl_s[kMaxRank];
  if (STACKED) {
    const size_t entry = blockIdx.z;
    part += entry * splits * M * N;
    xl += entry * M * rank;
    r += entry * rank * N;
    y += entry * M * N;
  }
  const int m = blockIdx.y;
  const int n = blockIdx.x * kFinishThreads + threadIdx.x;
  if (threadIdx.x < rank) {
    float s = 0.f;
    if (FUSED) {
      for (int sp = 0; sp < splits; ++sp)
        s += xl[(static_cast<size_t>(sp) * M + m) * rank + threadIdx.x];
    } else {
      s = xl[static_cast<size_t>(m) * rank + threadIdx.x];
    }
    xl_s[threadIdx.x] = s;
  }
  __syncthreads();
  if (n >= N) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    acc += part[(static_cast<size_t>(sp) * M + m) * N + n];
  for (int rr = 0; rr < rank; ++rr)
    acc = fmaf(xl_s[rr], r[static_cast<size_t>(rr) * N + n], acc);
  y[static_cast<size_t>(m) * N + n] = acc;
}

template <int MT, bool PACKED, bool FUSED, bool STACKED, typename XT>
int launch(const void* x, const void* codes, const void* scale, const void* l,
           const void* xl, const void* r, void* y, void* part, void* xl_part,
           int E, int M, int K, int N, int rank, cudaStream_t stream) {
  const int splits = (K + kSplitRows - 1) / kSplitRows;
  const int row_tiles = (M + MT - 1) / MT;
  const dim3 grid((N + kTileN - 1) / kTileN, splits, E * row_tiles);
  qlr_partial_kernel<MT, PACKED, FUSED, STACKED, XT>
      <<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const float*>(l),
      static_cast<float*>(part), static_cast<float*>(xl_part), M, K, N, rank,
      row_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 fgrid((N + kFinishThreads - 1) / kFinishThreads, M, E);
  qlr_finish_kernel<FUSED, STACKED><<<fgrid, kFinishThreads, 0, stream>>>(
      static_cast<const float*>(part), splits,
      static_cast<const float*>(FUSED ? xl_part : xl),
      static_cast<const float*>(r), static_cast<float*>(y), M, N, rank);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool FUSED>
int dispatch(const void* x, const void* codes, const void* scale, const void* l,
             const void* xl, const void* r, void* y, void* part, void* xl_part,
             int M, int K, int N, int rank, int x_bf16, int packed,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return packed
        ? launch<MT, true, FUSED, false, __nv_bfloat16>(
              x, codes, scale, l, xl, r, y, part, xl_part, 1, M, K, N, rank, s)
        : launch<MT, false, FUSED, false, __nv_bfloat16>(
              x, codes, scale, l, xl, r, y, part, xl_part, 1, M, K, N, rank, s);
  }
  return packed
      ? launch<MT, true, FUSED, false, float>(x, codes, scale, l, xl, r, y,
                                              part, xl_part, 1, M, K, N, rank,
                                              s)
      : launch<MT, false, FUSED, false, float>(x, codes, scale, l, xl, r, y,
                                               part, xl_part, 1, M, K, N, rank,
                                               s);
}

// K6: int8 codes only, like the TPU kernel.
template <int MT>
int dispatch_stacked(const void* x, const void* codes, const void* scale,
                     const void* xl, const void* r, void* y, void* part, int E,
                     int M, int K, int N, int rank, int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16
      ? launch<MT, false, false, true, __nv_bfloat16>(
            x, codes, scale, nullptr, xl, r, y, part, nullptr, E, M, K, N,
            rank, s)
      : launch<MT, false, false, true, float>(
            x, codes, scale, nullptr, xl, r, y, part, nullptr, E, M, K, N,
            rank, s);
}

}  // namespace

// K1: y (M, N) f32 = x·dequant(codes, scale) + (x·L)·R, x·L in the pass.
// Workspaces: part (splits, M, N) f32, xl_part (splits, M, rank) f32.
extern "C" int qlr_fused_launch(const void* x, const void* codes,
                                const void* scale, const void* l, const void* r,
                                void* y, void* part, void* xl_part, int M,
                                int K, int N, int rank, int x_bf16, int packed,
                                void* stream) {
  return dispatch<8, true>(x, codes, scale, l, nullptr, r, y, part, xl_part, M,
                           K, N, rank, x_bf16, packed, stream);
}

// K2: the same op with xl = x·L (M, rank) f32 precomputed by the caller.
extern "C" int qlr_launch(const void* x, const void* codes, const void* scale,
                          const void* xl, const void* r, void* y, void* part,
                          int M, int K, int N, int rank, int x_bf16, int packed,
                          void* stream) {
  return dispatch<16, false>(x, codes, scale, nullptr, xl, r, y, part, nullptr,
                             M, K, N, rank, x_bf16, packed, stream);
}

// K6: y (E, M, N) f32, y[e] = x[e]·dequant(codes[e], scale[e]) + xl[e]·R[e]
// over a stack of E int8 weights; x (E, M, K) f32/bf16, codes (E, K, N)
// int8, scale (E, K/32, N), xl = x·L (E, M, rank) f32 precomputed by the
// caller, r (E, rank, N). Workspace: part (E, splits, M, N) f32.
extern "C" int qlr_batched_launch(const void* x, const void* codes,
                                  const void* scale, const void* xl,
                                  const void* r, void* y, void* part, int E,
                                  int M, int K, int N, int rank, int x_bf16,
                                  void* stream) {
  if (M <= 8)   // constraints.QLR_BATCHED_SMALL_ROWS: the decode lanes
    return dispatch_stacked<8>(x, codes, scale, xl, r, y, part, E, M, K, N,
                               rank, x_bf16, stream);
  return dispatch_stacked<16>(x, codes, scale, xl, r, y, part, E, M, K, N,
                              rank, x_bf16, stream);
}
