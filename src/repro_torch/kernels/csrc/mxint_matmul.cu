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
// One tensor-core body, qlr_tc_body, one launch a call: K1 and K2 as
// qlr_tc_kernel, K6 as qlr_stacked_kernel (its own name, so a profile
// tells them apart).
//
// Why the tensor cores keep the 1e-4 gate. An MXINT weight is code·2^e: an
// int8 code (at most 8 significant bits) times a power of two, so it is
// exact in bf16 wherever the product is a bf16 normal (bf16 has f32's
// exponent range). An f32 x goes in as two bf16 terms, hi = bf16(x) and
// lo = bf16(x − hi), whose sum misses x by about 2^-17 of |x|; a bf16 x
// goes in once. Products run on mma.sync.m16n8k16 (bf16 in, f32
// accumulators). x·L (L f32) runs as x hi/lo × L hi/lo: three products.
// The scales must be powers of two, as MXIntQuantizer writes them; another
// scale would be rounded to bf16's 8 significant bits.
//
// What bounds each shape on an H100, and what the design does about it:
// - Decode (K1, M <= 8 lanes): bytes. A 3072×8192 int8 projection streams
//   25 MB of codes against 0.2 MB of activations (bound 0.0088 ms). The
//   tile computes yᵀ = Wᵀ·xᵀ: the dequantized weight is the A operand (16
//   output columns × 16 K rows, built in registers from code bytes) and
//   the lanes are the n = 8 side, so M = 8 fills an n-tile with no
//   padding. Codes stream through a 3-stage ring of 128-row stages in
//   shared memory filled by 16-byte cp.async (16 KB of codes a stage at
//   128 columns), so tens of KB per SM are in flight. Eight warps: two
//   column groups × four warps across K, each warp one 32-row MXINT block
//   of a stage, whose scales it reads once. A thread's A fragment rows are
//   chosen so that its code bytes are 2J neighbouring columns of a row (8
//   bytes at J = 4): fragment row g of m-tile j is column 2J·g + 2j, row
//   g + 8 is column 2J·g + 2j + 1. Below 4096 output columns the tile is
//   256 columns wide (J = 8), so each block's fixed cost covers more.
// - The router (N = 64, K = 2048): latency; 64-column tiles so no lane is
//   idle, and K split 8 ways.
// - Prefill (K2, and K1 at 8 < M <= 128): operations. The same kernel with
//   64 rows of x (8 n-tiles) against 128 columns, eight warps (four column
//   groups of 32 × two across K), 64-row stages: each code byte is read
//   ceil(M / 64) times (the SIMT kernel read it M / 16 times).
// - An f32 x tile is split into its bf16 pair once a stage, into shared
//   memory, rather than by every warp that reads it.
// - Split-K without a second launch: the K-splits of one output tile form a
//   thread-block cluster (at most 8 blocks, constraints.QLR_MAX_SPLITS).
//   Every block sums its warps' partial tiles (and partial x·L) in its own
//   shared memory; after a cluster barrier, block s sums slice s of the
//   tile over the splits in rank order through distributed shared memory
//   (deterministic, no atomics; each split's value is loaded before the
//   first add, so the remote loads overlap), adds (x·L)·R and writes y. No
//   workspace, no finishing kernel. Splits are chosen from (M, K, N) by the
//   wrapper (mxint_matmul.qlr_plan) to keep the grid within one wave;
//   the last split may be short. Decode tiles stage R's columns with the
//   first stage, so the epilogue waits on no device-memory load.
// - x·L (K1): L's rows ride in the same ring; with one n-tile of rows the
//   16-rank tiles rotate over the column warps from k-step to k-step, with
//   more rows rank tile lm stays with column group lm % WC — so no column
//   tile's blocks straggle; the block and then the cluster sum it.
// - Dequantization without the conversion pipe: a code's offset-binary
//   value (byte ^ 0x80, or nibble ^ 8) is dropped into the mantissa of
//   2^23 by one byte permute; subtracting the offset's 2^23 + 128 (or + 8)
//   and multiplying by 2^e give code·2^e exactly, and the bf16 is the top
//   16 bits (exact). packed4 codes (low nibble = row 2i, high nibble = row
//   2i+1, as repro.quant.mxint.unpack_codes_4bit) stream at half the int8
//   bytes and are never expanded in memory.
// - Copy loops run over each stage's chunk grid with compile-time widths
//   (shifts, not divisions) and mask a short last stage.
//
// Measured on the card (PERF.md §6): the decode tiles sit about 3.5×
// above their byte bound, and a block's loads and products barely
// overlap (a build that skips either keeps most of the time). That
// overlap is the next redesign's target (ROADMAP §2a).
//
// K6 is the same body over a stack (the STACKED instantiation, the only one
// that computes per-entry offsets: K1 ran 11 % slower on the card with them in
// every instantiation). grid.z walks (entry, row tile); x·L runs in the pass
// as in K1, so the caller computes no sliver, and the splits of a tile sum in
// their cluster, so there is no finishing kernel. An optional counts (E,)
// int32 says how many leading rows of each entry's capacity queue hold a token
// (the dispatch buffer is zero past them): a block whose rows all lie at or
// past the count loads nothing and writes zeros; a block that straddles it
// multiplies only the 8-row n-tiles that hold a token, masks x past the count
// and writes zeros there. At decode (8 lanes, top-6 of 64 experts) about 35 of
// the 64 experts hold a token, so about 45 % of the stack's code bytes are
// skipped. Its tiles (constraints.QLR_TILE_STACK_*) are 256 columns wide, so
// each block's share of L's bytes and of x·L is half a 128-column tile's, and
// hold two blocks an SM (at most 128 registers a thread; no R staged), so one
// block's loads overlap the other's products: with 64 experts × 6–8 column
// tiles there are blocks enough without splitting K. On the card (PERF.md §6)
// they beat, at 8 rows, K1's decode and wide tiles (one block an SM) and a
// 128-column two-block tile, and at 30 rows a 128 × 32 tile and the 64-row
// prefill tile with the n-tiles past the rows skipped.
//
// The limits below repeat src/repro_torch/kernels/constraints.py, whose
// wrapper checks raise before a launch the kernel cannot take.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMxBlock = 32;      // constraints.MXINT_BLOCK
constexpr int kMaxRank = 64;      // constraints.QLR_MAX_RANK

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------
constexpr int kMaxSplits = 8;     // constraints.QLR_MAX_SPLITS (cluster)

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? N : 0;    // 0: zero-fill, read nothing
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(N), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two values as one bf16x2 register: `lo` (the smaller k index) in the low
// half, as the mma fragments order them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The bf16 pair of two f32 values exact in bf16 (low 16 bits zero): their
// top halves, `lo` in the low half, by one byte permute.
__device__ __forceinline__ uint32_t top16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// The f32 2^23 + (byte q of w): the byte lands in the mantissa.
__device__ __forceinline__ float magic(uint32_t w, int q) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | q));
}
// hi = bf16(v), lo = bf16(v − hi), both packed as above.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// A tile shape (constraints.QLR_TILES; the .cu's launch_tile cases):
//   J  m-tiles (16 output columns each) a warp, WC warps across columns;
//   NT n-tiles (8 rows of x each) a warp;
//   SB 32-row MXINT blocks a stage, block b of a stage to warp b % WK of
//      the WK warps across K; ST stages in the cp.async ring;
//   MB blocks an SM the registers are held to (__launch_bounds__; K2's
//      and K6's instantiations: K1's keep x·L accumulators in up to 255).
template <int J_, int NT_, int WC_, int WK_, int SB_, int ST_, int MB_>
struct Tile {
  static constexpr int J = J_, NT = NT_, WC = WC_, WK = WK_, SB = SB_;
  static constexpr int ST = ST_, MB = MB_;
  static constexpr int kWarps = WC * WK;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBN = 16 * J * WC;          // output columns a tile
  static constexpr int kBM = 8 * NT;               // rows of x a tile
  static constexpr int kRows = kMxBlock * SB;      // K rows a stage
  // x·L's 16-rank tiles (at most 4): with one n-tile of rows they rotate
  // over the column warps from k-step to k-step (so each warp keeps all
  // four accumulators); with more, tile lm stays with column warp lm % WC
  static constexpr bool kLRot = NT == 1;
  // decode tiles (one n-tile of rows, one block an SM) also stage R's
  // columns of the tile in shared memory with the first stage, so that
  // the epilogue waits on no device-memory load (not K6's two-block tile,
  // whose shared memory would no longer fit twice)
  static constexpr bool kRPre = NT == 1 && MB == 1;
  static constexpr int kLI = kLRot ? 4 : (4 + WC - 1) / WC;
  static_assert(SB % WK == 0, "a stage's blocks deal evenly to the warps");
};
using TileDecode = Tile<4, 1, 2, 4, 4, 3, 1>;    // 128 columns × 8 rows
using TileRouter = Tile<2, 1, 2, 4, 4, 3, 1>;    //  64 columns × 8 rows
using TilePrefill = Tile<2, 8, 4, 2, 2, 3, 2>;   // 128 columns × 64 rows
using TileWide = Tile<8, 1, 2, 4, 4, 3, 1>;      // 256 columns × 8 rows
// K6's tiles (constraints.QLR_TILE_STACK_*), two blocks an SM: 64-row
// stages in a 4-deep ring at decode; at prefill eight column warps, each
// over all of a stage's K rows
using TileStackDecode = Tile<4, 1, 4, 2, 2, 4, 2>;   // 256 columns × 8 rows
using TileStackPrefill = Tile<2, 4, 8, 1, 2, 3, 2>;  // 256 columns × 32 rows

// Shared-memory layout of the ring, of the bf16 x pair converted once a
// stage (f32 x), and of the split-K reduction (which reuses the ring).
template <class T, bool PACKED, bool XBF>
struct Layout {
  static constexpr int kCodeRows = PACKED ? T::kRows / 2 : T::kRows;
  // Row strides padded so that a warp's fragment reads hit distinct banks.
  static constexpr int kCodeStride = T::kBN + (PACKED ? 32 : 16);  // bytes
  static constexpr int kXStride = XBF ? 2 * T::kRows + 16 : 4 * T::kRows + 32;
  static constexpr int kXcStride = 2 * T::kRows + 16;               // bytes
  static constexpr int kPStride = T::kBN + 4;                       // floats
  int lm, lstride;                 // L's 16-rank tiles; its row stride
  int code, scale, x, l, stage;    // byte offsets in a stage; stage bytes
  int xc, ring;                    // the converted x pair; ring bytes
  int p, xlp, xl, red;             // reduction: float offsets; bytes
  int rt, total;                   // R's staged columns; all bytes
  __host__ __device__ Layout(int rank, bool fused) {
    lm = (rank + 15) / 16;
    lstride = 16 * lm + 4;
    code = 0;
    scale = code + kCodeRows * kCodeStride;
    x = scale + 4 * T::SB * T::kBN;
    l = x + T::kBM * kXStride;
    stage = l + (fused ? 4 * T::kRows * lstride : 0);
    xc = T::ST * stage;
    ring = xc + (XBF ? 0 : 2 * T::kBM * kXcStride);
    p = 0;
    xlp = p + T::WK * T::kBM * kPStride;
    xl = xlp + T::kWarps * 16 * lm * T::kBM;
    red = 4 * (xl + T::kBM * rank);
    rt = ((ring > red ? ring : red) + 15) / 16 * 16;
    total = rt + (T::kRPre ? 4 * rank * T::kBN : 0);
  }
};

// 2J bytes from shared memory, as 32-bit words (2J >= 4).
template <int J>
__device__ __forceinline__ void read_row(const unsigned char* p,
                                         uint32_t (&w)[(2 * J + 3) / 4]) {
  if constexpr (J == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (J == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// One output tile's partial over one K split, then the cluster's sum.
//   x      (M, K) f32 or bf16, 16-byte aligned
//   codes  (K, N) int8, or (K/2, N) packed4 uint8
//   scale  (K/32, N) f32, powers of two
//   l      (K, rank) f32                          FUSED (K1, K6) only
//   xl     (M, rank) f32, x·L precomputed         !FUSED (K2) only
//   r      (rank, N) f32
//   y      (M, N) f32
// Grid (splits, ceil(N / BN), ceil(M / BM)); cluster (splits, 1, 1). Split
// s covers MXINT blocks [s·split_blocks, (s+1)·split_blocks) ∩ [0, K/32).
// STACKED (K6): every operand has a leading entry axis, grid.z is (entry,
// row tile) and counts (E,) int32, or null for all M, gives each entry's
// rows that hold a token; the rest of its rows are written as zeros.
template <class T, bool PACKED, bool FUSED, typename XT, bool STACKED>
__device__ __forceinline__ void qlr_tc_body(
    const XT* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scale, const float* __restrict__ l,
    const float* __restrict__ xl_in, const float* __restrict__ r,
    float* __restrict__ y, const int* __restrict__ counts, int M, int K,
    int N, int rank, int split_blocks, int codes_vec16, int l_vec16) {
  constexpr bool XBF = sizeof(XT) == 2;
  using Lay = Layout<T, PACKED, XBF>;
  constexpr int J = T::J, NT = T::NT, WC = T::WC, WK = T::WK, SB = T::SB;
  constexpr int ST = T::ST, BN = T::kBN, BM = T::kBM, kT = T::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const Lay lay(rank, FUSED);
  const int splits = gridDim.x;
  const int split = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int ncols = min(BN, N - n0);
  int m0 = blockIdx.z * BM;
  int m_end = M;          // rows of x from here on hold no token
  int nt_live = NT;       // n-tiles with a row below m_end
  if constexpr (STACKED) {
    const int row_tiles = (M + BM - 1) / BM;
    const int entry = blockIdx.z / row_tiles;
    m0 = (blockIdx.z - entry * row_tiles) * BM;
    const size_t e = entry;
    x += e * M * K;
    codes += e * K * N;
    scale += e * (K / kMxBlock) * N;
    l += e * K * rank;
    r += e * rank * N;
    y += e * M * N;
    if (counts != nullptr) m_end = min(max(counts[entry], 0), M);
    if (m_end <= m0) {
      // no token in the tile: every block of the cluster writes its
      // slice of zeros and leaves (before any cluster barrier, as all of
      // them do); y rows are 16-byte aligned as N % 4 == 0
      const int c4 = ncols / 4, total = min(BM, M - m0) * c4;
      const int per = (total + splits - 1) / splits;
      const int i_end = min(total, (split + 1) * per);
      for (int i = split * per + threadIdx.x; i < i_end; i += kT)
        *reinterpret_cast<float4*>(y + static_cast<size_t>(m0 + i / c4) * N
                                   + n0 + 4 * (i % c4)) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      return;
    }
    nt_live = min(NT, (m_end - m0 + 7) / 8);
  }
  const int b_begin = split * split_blocks;
  const int b_end = min(K / kMxBlock, b_begin + split_blocks);
  const int n_stages = b_end > b_begin ? (b_end - b_begin + SB - 1) / SB : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp % WC, wk = warp / WC;
  const int col0 = wc * 16 * J + 2 * J * g;   // this thread's first column

  // Every copy loop runs over the full stage's chunk grid, whose width is
  // a compile-time power of two (so row and column come from shifts, not
  // divisions), and masks what a short last stage or a narrow tile lacks.
  constexpr int kXe = 16 / static_cast<int>(sizeof(XT));   // x per chunk
  auto load = [&](int st) {
    unsigned char* base = smem + (st % ST) * lay.stage;
    const int b0 = b_begin + st * SB;
    const int nb = min(SB, b_end - b0);
    const int rows = nb * (PACKED ? kMxBlock / 2 : kMxBlock);
    const uint8_t* cg0 = codes + static_cast<size_t>(b0)
        * (PACKED ? kMxBlock / 2 : kMxBlock) * N + n0;
    if (codes_vec16) {
      constexpr int kC = BN / 16, kAll = Lay::kCodeRows * kC;
#pragma unroll
      for (int i0 = 0; i0 < kAll; i0 += kT) {
        const int i = i0 + threadIdx.x;
        const int rr = i / kC, cc = (i % kC) * 16;
        if ((kAll % kT == 0 || i < kAll) && rr < rows && cc < ncols)
          cp_async<16>(base + lay.code + rr * Lay::kCodeStride + cc,
                       cg0 + static_cast<size_t>(rr) * N + cc);
      }
    } else {
      constexpr int kC = BN / 4, kAll = Lay::kCodeRows * kC;
#pragma unroll 4
      for (int i0 = 0; i0 < kAll; i0 += kT) {
        const int i = i0 + threadIdx.x;
        const int rr = i / kC, cc = (i % kC) * 4;
        if ((kAll % kT == 0 || i < kAll) && rr < rows && cc < ncols)
          cp_async<4>(base + lay.code + rr * Lay::kCodeStride + cc,
                      cg0 + static_cast<size_t>(rr) * N + cc);
      }
    }
    {
      constexpr int kC = BN / 4, kAll = SB * kC;
#pragma unroll
      for (int i0 = 0; i0 < kAll; i0 += kT) {
        const int i = i0 + threadIdx.x;
        const int rr = i / kC, cc = (i % kC) * 4;
        if ((kAll % kT == 0 || i < kAll) && rr < nb && cc < ncols)
          cp_async<16>(base + lay.scale + 4 * (rr * BN + cc),
                       scale + static_cast<size_t>(b0 + rr) * N + n0 + cc);
      }
    }
    {
      constexpr int kC = T::kRows / kXe, kAll = BM * kC;
      const XT* xg0 = x + static_cast<size_t>(m0) * K + b0 * kMxBlock;
#pragma unroll
      for (int i0 = 0; i0 < kAll; i0 += kT) {
        const int i = i0 + threadIdx.x;
        const int rr = i / kC, cc = (i % kC) * kXe;
        if ((kAll % kT == 0 || i < kAll) && cc < nb * kMxBlock) {
          const bool ok = m0 + rr < m_end;        // rows past it are zero
          cp_async<16>(base + lay.x + rr * Lay::kXStride + cc * sizeof(XT),
                       ok ? xg0 + static_cast<size_t>(rr) * K + cc : x, ok);
        }
      }
    }
    if (FUSED && rank > 0) {
      const float* lg0 = l + static_cast<size_t>(b0) * kMxBlock * rank;
      float* ldst = reinterpret_cast<float*>(base + lay.l);
      const int lrows = nb * kMxBlock;
      if (l_vec16) {
        constexpr int kC = kMaxRank / 4, kAll = T::kRows * kC;
#pragma unroll 4
        for (int i0 = 0; i0 < kAll; i0 += kT) {
          const int i = i0 + threadIdx.x;
          const int rr = i / kC, cc = (i % kC) * 4;
          if (rr < lrows && cc < rank)
            cp_async<16>(ldst + rr * lay.lstride + cc,
                         lg0 + static_cast<size_t>(rr) * rank + cc);
        }
      } else {
        constexpr int kAll = T::kRows * kMaxRank;
#pragma unroll 4
        for (int i0 = 0; i0 < kAll; i0 += kT) {
          const int i = i0 + threadIdx.x;
          const int rr = i / kMaxRank, cc = i % kMaxRank;
          if (rr < lrows && cc < rank)
            cp_async<4>(ldst + rr * lay.lstride + cc,
                        lg0 + static_cast<size_t>(rr) * rank + cc);
        }
      }
    }
  };

  // f32 x: the stage's x tile split once into its bf16 pair (hi, lo), so
  // no warp splits it again
  auto convert = [&](int st) {
    const unsigned char* base = smem + (st % ST) * lay.stage;
    const int cols = min(SB, b_end - (b_begin + st * SB)) * kMxBlock;
    constexpr int kC = T::kRows / 2, kAll = BM * kC;
#pragma unroll
    for (int i0 = 0; i0 < kAll; i0 += kT) {
      const int i = i0 + threadIdx.x;
      const int rr = i / kC, cc = (i % kC) * 2;
      if ((kAll % kT == 0 || i < kAll) && cc < cols) {
        const float2 v = *reinterpret_cast<const float2*>(
            base + lay.x + rr * Lay::kXStride + 4 * cc);
        uint32_t hi, lo;
        split_bf16(v.x, v.y, hi, lo);
        unsigned char* d = smem + lay.xc + rr * Lay::kXcStride + 2 * cc;
        *reinterpret_cast<uint32_t*>(d) = hi;
        *reinterpret_cast<uint32_t*>(d + BM * Lay::kXcStride) = lo;
      }
    }
  };

  float acc[J][NT][4];
  float xacc[T::kLI][NT][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;
#pragma unroll
  for (int li = 0; li < T::kLI; ++li)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[li][nt][e] = 0.f;

  auto compute = [&](int st) {
    const unsigned char* base = smem + (st % ST) * lay.stage;
    const int nb = min(SB, b_end - (b_begin + st * SB));
    // x's bf16 rows: the pair converted above, or a bf16 x as loaded
    const unsigned char* xb = XBF ? base + lay.x : smem + lay.xc;
    constexpr int kXb = XBF ? Lay::kXStride : Lay::kXcStride;
#pragma unroll
    for (int bi = wk; bi < SB; bi += WK) {
      if (bi >= nb) break;                            // warp-uniform
      float sc[2 * J];
      const float* srow = reinterpret_cast<const float*>(base + lay.scale)
          + bi * BN + col0;
#pragma unroll
      for (int q = 0; q < 2 * J; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(srow + q);
        sc[q] = v.x; sc[q + 1] = v.y; sc[q + 2] = v.z; sc[q + 3] = v.w;
      }
      constexpr float kOff = PACKED ? 8388616.f : 8388736.f;  // 2^23 + offset
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {                // two k16 steps a block
        const int kr = bi * kMxBlock + kk * 16;       // first row, in the stage
        // A: the dequantized weight, 16 columns × 16 K rows per m-tile. A
        // code enters as the f32 2^23 + u, u its offset-binary value (c +
        // 128 for a byte, c + 8 for a nibble) dropped into the mantissa by
        // one byte permute; removing the offset and scaling by 2^e are
        // exact, and so is keeping the top 16 bits as the bf16 (at most 8
        // significant bits) — no int→float or float→bf16 conversion, which
        // run on the quarter-rate conversion pipe.
        uint32_t a[J][4];
        {
          constexpr int W = (2 * J + 3) / 4;
          uint32_t u0[W], u1[W], u2[W], u3[W];   // rows 2t, 2t+1, 2t+8, 2t+9
          const unsigned char* cbase = base + lay.code + col0;
          if constexpr (PACKED) {
            uint32_t p0[W], p1[W];
            read_row<J>(cbase + (kr / 2 + t) * Lay::kCodeStride, p0);
            read_row<J>(cbase + (kr / 2 + t + 4) * Lay::kCodeStride, p1);
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const uint32_t b0 = p0[i] ^ 0x88888888u, b1 = p1[i] ^ 0x88888888u;
              u0[i] = b0 & 0x0F0F0F0Fu;          // low nibble: row 2i
              u1[i] = (b0 >> 4) & 0x0F0F0F0Fu;   // high nibble: row 2i + 1
              u2[i] = b1 & 0x0F0F0F0Fu;
              u3[i] = (b1 >> 4) & 0x0F0F0F0Fu;
            }
          } else {
            read_row<J>(cbase + (kr + 2 * t) * Lay::kCodeStride, u0);
            read_row<J>(cbase + (kr + 2 * t + 1) * Lay::kCodeStride, u1);
            read_row<J>(cbase + (kr + 2 * t + 8) * Lay::kCodeStride, u2);
            read_row<J>(cbase + (kr + 2 * t + 9) * Lay::kCodeStride, u3);
#pragma unroll
            for (int i = 0; i < W; ++i) {
              u0[i] ^= 0x80808080u; u1[i] ^= 0x80808080u;
              u2[i] ^= 0x80808080u; u3[i] ^= 0x80808080u;
            }
          }
#pragma unroll
          for (int j = 0; j < J; ++j) {
            float v[4][2];   // [row 2t, 2t+1, 2t+8, 2t+9][column 2j, 2j+1]
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 2 * j + h;
              v[0][h] = (magic(u0[q / 4], q % 4) - kOff) * sc[q];
              v[1][h] = (magic(u1[q / 4], q % 4) - kOff) * sc[q];
              v[2][h] = (magic(u2[q / 4], q % 4) - kOff) * sc[q];
              v[3][h] = (magic(u3[q / 4], q % 4) - kOff) * sc[q];
            }
            a[j][0] = top16(v[0][0], v[1][0]);   // row g,   k 2t, 2t+1
            a[j][1] = top16(v[0][1], v[1][1]);   // row g+8, k 2t, 2t+1
            a[j][2] = top16(v[2][0], v[3][0]);   // row g,   k 2t+8, 2t+9
            a[j][3] = top16(v[2][1], v[3][1]);   // row g+8, k 2t+8, 2t+9
          }
        }
        // Lᵀ as the A operand of x·L (K1): 16 ranks × 16 K rows, split
        // hi/lo, for the rank tiles this warp owns at this k-step
        const int kstep = 2 * bi + kk;
        auto owns = [&](int li) {
          const int lm = T::kLRot ? li : li * WC + wc;
          return lm < lay.lm && (!T::kLRot || (lm + kstep) % WC == wc);
        };
        uint32_t lh[T::kLI][4], ll[T::kLI][4];
        if constexpr (FUSED) {
          const float* lk = reinterpret_cast<const float*>(base + lay.l)
              + (kr + 2 * t) * lay.lstride;
#pragma unroll
          for (int li = 0; li < T::kLI; ++li) {
            if (!owns(li)) continue;
            const int c = (T::kLRot ? li : li * WC + wc) * 16 + g;
            split_bf16(lk[c], lk[lay.lstride + c], lh[li][0], ll[li][0]);
            split_bf16(lk[c + 8], lk[lay.lstride + c + 8], lh[li][1],
                       ll[li][1]);
            split_bf16(lk[8 * lay.lstride + c], lk[9 * lay.lstride + c],
                       lh[li][2], ll[li][2]);
            split_bf16(lk[8 * lay.lstride + c + 8],
                       lk[9 * lay.lstride + c + 8], lh[li][3], ll[li][3]);
          }
        }
        // B: x's rows as the n side, as bf16 hi and lo (f32) or once
        // (bf16), one n-tile at a time
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (STACKED && nt >= nt_live) break;         // no token: skipped
          const unsigned char* xr = xb + (nt * 8 + g) * kXb + 2 * (kr + 2 * t);
          uint32_t bh[2], bl[2];
          bh[0] = *reinterpret_cast<const uint32_t*>(xr);
          bh[1] = *reinterpret_cast<const uint32_t*>(xr + 16);
          if constexpr (!XBF) {
            bl[0] = *reinterpret_cast<const uint32_t*>(xr + BM * kXb);
            bl[1] = *reinterpret_cast<const uint32_t*>(xr + BM * kXb + 16);
          }
#pragma unroll
          for (int j = 0; j < J; ++j) {
            mma_bf16(acc[j][nt], a[j], bh);
            if constexpr (!XBF) mma_bf16(acc[j][nt], a[j], bl);
          }
          if constexpr (FUSED) {
#pragma unroll
            for (int li = 0; li < T::kLI; ++li) {
              if (!owns(li)) continue;
              mma_bf16(xacc[li][nt], lh[li], bh);
              mma_bf16(xacc[li][nt], ll[li], bh);
              if constexpr (!XBF) mma_bf16(xacc[li][nt], lh[li], bl);
            }
          }
        }
      }
    }
  };

  if constexpr (T::kRPre) {         // R's columns, with the first stage
    float* rdst = reinterpret_cast<float*>(smem + lay.rt);
    constexpr int kC = BN / 4;
    for (int i = threadIdx.x; i < rank * kC; i += kT) {
      const int c = i / kC, cc = (i % kC) * 4;
      if (cc < ncols)
        cp_async<16>(rdst + c * BN + cc,
                     r + static_cast<size_t>(c) * N + n0 + cc);
    }
  }
  // the ring: ST - 1 stages in flight while one is multiplied; one
  // commit group a stage (empty past the end, so the count is uniform)
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < n_stages) load(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    // stage st has landed, and every warp is done with stage st - 1, whose
    // slot the next copy refills
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (st + ST - 1 < n_stages) load(st + ST - 1);
    cp_async_commit();
    if constexpr (!XBF) {
      convert(st);
      __syncthreads();
    }
    compute(st);
  }
  cp_async_wait<0>();
  __syncthreads();

  // this block's partials into its own shared memory (the ring is free):
  //   P[wk][m][n] of x·W (one per warp row across K), XLP[warp][rank][m]
  //   of x·L (every warp, zeros where it owned no rank tile)
  float* red = reinterpret_cast<float*>(smem);
  {
    float* pw = red + lay.p + wk * BM * Lay::kPStride;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = nt * 8 + 2 * t, n = col0 + 2 * j;
        *reinterpret_cast<float2*>(pw + m * Lay::kPStride + n) =
            make_float2(acc[j][nt][0], acc[j][nt][2]);
        *reinterpret_cast<float2*>(pw + (m + 1) * Lay::kPStride + n) =
            make_float2(acc[j][nt][1], acc[j][nt][3]);
      }
    if constexpr (FUSED) {
      float* xw = red + lay.xlp + warp * 16 * lay.lm * BM;
#pragma unroll
      for (int lm = 0; lm < 4; ++lm) {
        if (lm >= lay.lm) continue;
        const int li = T::kLRot ? lm : lm / WC;
        const bool mine = T::kLRot || lm % WC == wc;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int m = nt * 8 + 2 * t, c = lm * 16 + g;
          xw[c * BM + m] = mine ? xacc[li][nt][0] : 0.f;
          xw[c * BM + m + 1] = mine ? xacc[li][nt][1] : 0.f;
          xw[(c + 8) * BM + m] = mine ? xacc[li][nt][2] : 0.f;
          xw[(c + 8) * BM + m + 1] = mine ? xacc[li][nt][3] : 0.f;
        }
      }
    }
  }
  __syncthreads();
  // the block's own sums first, in warp order, into P[0] and XLP[0], so
  // that the cluster's sums read one value per split
  if constexpr (WK > 1) {
    for (int e = threadIdx.x; e < BM * BN; e += kT) {
      const int o = (e / BN) * Lay::kPStride + e % BN;
      float v = red[lay.p + o];
#pragma unroll
      for (int w = 1; w < WK; ++w) v += red[lay.p + w * BM * Lay::kPStride + o];
      red[lay.p + o] = v;
    }
  }
  if constexpr (FUSED) {
    const int n_xl = 16 * lay.lm * BM;
    for (int e = threadIdx.x; e < n_xl; e += kT) {
      float v = red[lay.xlp + e];
#pragma unroll
      for (int w = 1; w < T::kWarps; ++w) v += red[lay.xlp + w * n_xl + e];
      red[lay.xlp + e] = v;
    }
  }
  cluster.sync();

  // x·L of the tile's rows: the splits' sums added in rank order (every
  // split's value loaded before the first add), or the caller's sliver
  float* xl_s = red + lay.xl;                       // [BM][rank]
  for (int i = threadIdx.x; i < BM * rank; i += kT) {
    const int m = i / rank, c = i % rank;
    float s = 0.f;
    if constexpr (FUSED) {
      float part[kMaxSplits];
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        part[sp] = sp < splits
            ? cluster.map_shared_rank(red + lay.xlp, sp)[c * BM + m] : 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp) s += part[sp];
    } else {
      if (m0 + m < M) s = xl_in[static_cast<size_t>(m0 + m) * rank + c];
    }
    xl_s[i] = s;
  }
  __syncthreads();

  // slice `split` of the tile: Σ over splits in rank order, + (x·L)·R
  const int per = (BM * BN + splits - 1) / splits;
  const int e_end = min(BM * BN, (split + 1) * per);
  for (int e = split * per + threadIdx.x; e < e_end; e += kT) {
    const int m = e / BN, n = e % BN;
    if (m0 + m >= M || n >= ncols) continue;
    float v = 0.f;                                  // a row with no token
    if (!STACKED || m0 + m < m_end) {
      const int o = m * Lay::kPStride + n;
      float part[kMaxSplits];
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        part[sp] = sp < splits ? cluster.map_shared_rank(red + lay.p, sp)[o]
                               : 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp) v += part[sp];
      if constexpr (T::kRPre) {
        const float* rc = reinterpret_cast<const float*>(smem + lay.rt) + n;
        for (int c = 0; c < rank; ++c)
          v = fmaf(xl_s[m * rank + c], rc[c * BN], v);
      } else {
        const float* rc = r + n0 + n;
#pragma unroll 16
        for (int c = 0; c < rank; ++c)
          v = fmaf(xl_s[m * rank + c], rc[static_cast<size_t>(c) * N], v);
      }
    }
    y[static_cast<size_t>(m0 + m) * N + n0 + n] = v;
  }
  cluster.sync();     // no block leaves while another reads its partials
}

// K1 (FUSED) and K2 (!FUSED).
template <class T, bool PACKED, bool FUSED, typename XT>
__global__ void __launch_bounds__(T::kThreads, FUSED ? 1 : T::MB)
qlr_tc_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
              const float* __restrict__ scale, const float* __restrict__ l,
              const float* __restrict__ xl_in, const float* __restrict__ r,
              float* __restrict__ y, int M, int K, int N, int rank,
              int split_blocks, int codes_vec16, int l_vec16) {
  qlr_tc_body<T, PACKED, FUSED, XT, false>(x, codes, scale, l, xl_in, r, y,
                                           nullptr, M, K, N, rank,
                                           split_blocks, codes_vec16, l_vec16);
}

// K6: int8 codes, x·L in the pass, over a stack of E entries.
template <class T, typename XT>
__global__ void __launch_bounds__(T::kThreads, T::MB)
qlr_stacked_kernel(const XT* __restrict__ x,
                   const uint8_t* __restrict__ codes,
                   const float* __restrict__ scale,
                   const float* __restrict__ l, const float* __restrict__ r,
                   float* __restrict__ y, const int* __restrict__ counts,
                   int M, int K, int N, int rank, int split_blocks,
                   int codes_vec16, int l_vec16) {
  qlr_tc_body<T, false, true, XT, true>(x, codes, scale, l, nullptr, r, y,
                                        counts, M, K, N, rank, split_blocks,
                                        codes_vec16, l_vec16);
}

// Opt a kernel in to `smem` bytes of dynamic shared memory (once per
// instantiation and size) and launch it on a (splits, 1, 1) cluster.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int& opted, int smem,
                   dim3 grid, int threads, int splits, cudaStream_t stream,
                   Args... args) {
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K1/K2 (E = 1, counts null) or K6 (STACKED: int8, FUSED).
template <class T, bool PACKED, bool FUSED, typename XT, bool STACKED = false>
int launch_tc(const void* x, const void* codes, const void* scale,
              const void* l, const void* xl, const void* r, void* y,
              const int* counts, int E, int M, int K, int N, int rank,
              int splits, int split_blocks, cudaStream_t stream) {
  using Lay = Layout<T, PACKED, sizeof(XT) == 2>;
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const int smem = Lay(rank, FUSED).total;
  static int opted = 0;           // per instantiation
  const dim3 grid(splits, (N + T::kBN - 1) / T::kBN,
                  E * ((M + T::kBM - 1) / T::kBM));
  const int codes_vec16 =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const int l_vec16 = rank % 4 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0;
  const auto* xt = static_cast<const XT*>(x);
  const auto* ct = static_cast<const uint8_t*>(codes);
  const auto* st = static_cast<const float*>(scale);
  const auto* lt = static_cast<const float*>(l);
  const auto* rt = static_cast<const float*>(r);
  auto* yt = static_cast<float*>(y);
  if constexpr (STACKED)
    return launch_cluster(qlr_stacked_kernel<T, XT>, opted, smem, grid,
                          T::kThreads, splits, stream, xt, ct, st, lt, rt, yt,
                          counts, M, K, N, rank, split_blocks, codes_vec16,
                          l_vec16);
  else
    return launch_cluster(qlr_tc_kernel<T, PACKED, FUSED, XT>, opted, smem,
                          grid, T::kThreads, splits, stream, xt, ct, st, lt,
                          static_cast<const float*>(xl), rt, yt, M, K, N, rank,
                          split_blocks, codes_vec16, l_vec16);
}

// The tile shapes by constraints.QLR_TILE_* (the wrapper's qlr_plan picks).
// K2 (rows > 128) only ever takes the prefill tile, so the decode tiles
// are built for K1 alone.
template <bool PACKED, bool FUSED, typename XT>
int launch_tile(int tile, const void* x, const void* codes, const void* scale,
                const void* l, const void* xl, const void* r, void* y, int M,
                int K, int N, int rank, int splits, int split_blocks,
                cudaStream_t s) {
  if (tile == 2)
    return launch_tc<TilePrefill, PACKED, FUSED, XT>(
        x, codes, scale, l, xl, r, y, nullptr, 1, M, K, N, rank, splits,
        split_blocks, s);
  if constexpr (FUSED) {
    switch (tile) {
      case 0:
        return launch_tc<TileDecode, PACKED, FUSED, XT>(
            x, codes, scale, l, xl, r, y, nullptr, 1, M, K, N, rank, splits,
            split_blocks, s);
      case 1:
        return launch_tc<TileRouter, PACKED, FUSED, XT>(
            x, codes, scale, l, xl, r, y, nullptr, 1, M, K, N, rank, splits,
            split_blocks, s);
      case 3:
        return launch_tc<TileWide, PACKED, FUSED, XT>(
            x, codes, scale, l, xl, r, y, nullptr, 1, M, K, N, rank, splits,
            split_blocks, s);
    }
  }
  return cudaErrorInvalidValue;
}

template <bool FUSED>
int dispatch_tc(int tile, const void* x, const void* codes, const void* scale,
                const void* l, const void* xl, const void* r, void* y, int M,
                int K, int N, int rank, int splits, int split_blocks,
                int x_bf16, int packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return packed
        ? launch_tile<true, FUSED, __nv_bfloat16>(tile, x, codes, scale, l, xl,
                                                  r, y, M, K, N, rank, splits,
                                                  split_blocks, s)
        : launch_tile<false, FUSED, __nv_bfloat16>(tile, x, codes, scale, l,
                                                   xl, r, y, M, K, N, rank,
                                                   splits, split_blocks, s);
  return packed
      ? launch_tile<true, FUSED, float>(tile, x, codes, scale, l, xl, r, y, M,
                                        K, N, rank, splits, split_blocks, s)
      : launch_tile<false, FUSED, float>(tile, x, codes, scale, l, xl, r, y, M,
                                         K, N, rank, splits, split_blocks, s);
}

// K6's tiles by constraints.QLR_TILE_STACK_* (the wrapper's
// qlr_stacked_plan picks).
template <typename XT>
int launch_stacked_tile(int tile, const void* x, const void* codes,
                        const void* scale, const void* l, const void* r,
                        void* y, const int* counts, int E, int M, int K, int N,
                        int rank, int splits, int split_blocks,
                        cudaStream_t s) {
  if (tile == 4)      // QLR_TILE_STACK_DECODE
    return launch_tc<TileStackDecode, false, true, XT, true>(
        x, codes, scale, l, nullptr, r, y, counts, E, M, K, N, rank, splits,
        split_blocks, s);
  if (tile == 5)      // QLR_TILE_STACK_PREFILL
    return launch_tc<TileStackPrefill, false, true, XT, true>(
        x, codes, scale, l, nullptr, r, y, counts, E, M, K, N, rank, splits,
        split_blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1: y (M, N) f32 = x·dequant(codes, scale) + (x·L)·R, x·L in the pass.
// `tile`, `splits` and `split_blocks` come from the wrapper's qlr_plan.
extern "C" int qlr_fused_launch(const void* x, const void* codes,
                                const void* scale, const void* l, const void* r,
                                void* y, int M, int K, int N, int rank,
                                int tile, int splits, int split_blocks,
                                int x_bf16, int packed, void* stream) {
  return dispatch_tc<true>(tile, x, codes, scale, l, nullptr, r, y, M, K, N,
                           rank, splits, split_blocks, x_bf16, packed, stream);
}

// K2: the same op with xl = x·L (M, rank) f32 precomputed by the caller.
extern "C" int qlr_launch(const void* x, const void* codes, const void* scale,
                          const void* xl, const void* r, void* y, int M, int K,
                          int N, int rank, int tile, int splits,
                          int split_blocks, int x_bf16, int packed,
                          void* stream) {
  return dispatch_tc<false>(tile, x, codes, scale, nullptr, xl, r, y, M, K, N,
                            rank, splits, split_blocks, x_bf16, packed, stream);
}

// K6: y (E, M, N) f32, y[e] = x[e]·dequant(codes[e], scale[e]) +
// (x[e]·L[e])·R[e] over a stack of E int8 weights, x·L in the pass; x (E,
// M, K) f32/bf16, codes (E, K, N) int8, scale (E, K/32, N), l (E, K,
// rank), r (E, rank, N); counts (E,) int32 or null: rows of entry e at or
// past counts[e] (clamped to [0, M]) are written as zeros and not
// computed. `tile`, `splits` and `split_blocks` come from the wrapper's
// qlr_stacked_plan.
extern "C" int qlr_stacked_launch(const void* x, const void* codes,
                                  const void* scale, const void* l,
                                  const void* r, void* y, const void* counts,
                                  int E, int M, int K, int N, int rank,
                                  int tile, int splits, int split_blocks,
                                  int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  return x_bf16
      ? launch_stacked_tile<__nv_bfloat16>(tile, x, codes, scale, l, r, y, c,
                                           E, M, K, N, rank, splits,
                                           split_blocks, s)
      : launch_stacked_tile<float>(tile, x, codes, scale, l, r, y, c, E, M, K,
                                   N, rank, splits, split_blocks, s);
}
