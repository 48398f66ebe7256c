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
// slot outputs zeros, as the TPU kernel does.
//
// What bounds it on an H100: bytes. A decode step reads each row's live
// cache once (bf16 B=8, KV=32, S=512, hd=96: 50 MB for K and V if every
// slot is valid) for 2·G·hd FLOPs per slot, far below the card's
// ops-per-byte balance. The lever is to read fewer bytes and to keep
// enough loads in flight, not the tensor cores.
//
// Design (flash-decoding):
// - The slot axis is split across blocks: grid (KV · group blocks, B,
//   splits), 128 threads a block, each split a run of whole 32-slot tiles
//   (at most 16). A block holds accumulators for at most kBlockG = 8 query
//   heads, so a KV head whose group is wider (chatglm3-6b: G = 16) takes
//   ceil(G / 8) blocks, each over its own heads and reading the head's K/V
//   again (the second read of a decode-size cache comes from L2); G <= 8
//   takes one. The host picks the split count from B·KV·ceil(G / 8), S and
//   the SM count for about four blocks per SM
//   (kernels/decode_attention.py:decode_splits): at phi3's decode (B·KV =
//   256, S = 512) 3 splits of 6 tiles, 768 blocks, 5.8 per SM of 132; at
//   deepseek-moe-16b's (B·KV = 128) 4 splits of 4 tiles, 512 blocks, 3.9
//   per SM; at chatglm3-6b's (B·KV = 16, G = 16: 32 rows) 16 splits of
//   one tile, 512 blocks. A split writes f32 partials (m, l,
//   acc[G, hd]) to scratch that the wrapper allocates; a second kernel,
//   decode_combine_kernel, merges the splits of each (b, h, g) in split order
//   (deterministic, no atomics). With one split the kernel normalizes and
//   writes the output itself, and no combine runs.
// - Dead work is skipped from the positions. A first pass reads the
//   split's k_pos and keeps one valid-slot bit mask per tile and, for the
//   valid slots only, the slot's row in the pool (K5 looks up the block
//   table there, so only for slots it reads). A split with no valid slot
//   loads nothing and writes its empty partial (m = sentinel, l = 0); a
//   tile with no valid slot issues no loads; inside a tile only valid rows
//   are loaded, and rows not loaded are never read. The combine outputs
//   zeros when every split of a row is empty.
// - Inside a block each warp is an independent flash-decode over 8 slots
//   of every tile, with its own running max, sum and accumulators, and
//   no block barrier until the four warps merge in order at the end.
//   Its slots' K and V rows stay in their storage type in shared memory
//   (f32, bf16, int8 codes, packed4 bytes; rows padded by 16 bytes) and
//   are converted at use; K and V have separate buffers, double-buffered
//   and filled by cp.async, so the next live tile arrives while this one
//   is computed (a third stage was no faster on the card: it costs
//   resident blocks). int8/int4 scales fold into the score and
//   probability columns: the dequantized cache exists nowhere.
// - Every lane works at G = 1: the scores run a quad of lanes per slot,
//   each lane a quarter of the head-dim vectors, summed with two
//   shuffles; P·V gives each lane the columns lane, lane + 32, ..., so
//   hd = 96 keeps all 32 lanes busy, with each slot's probability
//   broadcast from its quad by a shuffle.
// - Accumulators are sized by a template bound on a block's heads: MHA
//   models (G = 1, phi3, deepseek-moe-16b and qwen1.5-32b) take 56–64
//   registers, up to 8 heads a block 93–114, none spilling but the
//   8-head instances over an f32 cache (44 bytes), per `nvcc -Xptxas -v`
//   (CUDA 12.8); static shared memory 2,144 / 2,368 bytes;
//   dynamic 27 KB for bf16 at hd 96 (seven blocks per SM), 35 KB at hd
//   128; the combine 32 registers. Doubling the bound to 16 heads would
//   double a lane's accumulators (4 × 16 floats) and the merge buffer for
//   every G > 1, at the risk of spills under __launch_bounds__; splitting
//   the group across blocks keeps the bound at 8.
//
// The latent instance (LAT): MLA's absorbed decode (deepseek-v2-lite-16b)
// scores one query a head against the latent cache, KV = 1, G = H = 16,
// at head dim kv_lora_rank + rope_head_dim = 576, with the caller's score
// scale (1/sqrt(192)), and V is the first dv = 512 columns of the same
// rows (the repo's JAX package pads the latent to 576 and passes it as a
// second tensor). A head wider than kMaxHd takes it; f32/bf16 caches
// only, unpaged. What changes against the instances above:
// - V is read from K's tile: one buffer of tiles instead of K and V's
//   two, so a bf16 block takes 82 KB of shared memory (kStages = 2 tiles
//   of 36.5 KB, 9 KB of q). An f32 tile is 73 KB: two stages would take
//   157 KB and leave one block an SM, so the f32 instance keeps one
//   stage (82 KB; a warp's next tile is copied after its current one is
//   done, and the SM's other block covers the wait).
// - A stored row is 72 (bf16) or 144 (f32) 16-byte chunks, more than a
//   warp's 32 lanes: each lane copies chunks lane, lane + 32, ... of
//   every valid row of its warp.
// - A lane owns P·V columns lane, lane + 32, ... < dv: 16 a head. A block
//   holds kLatentBlockG = 4 heads (64 accumulator floats a lane), so the
//   group of 16 takes 4 blocks, each reading the rows again (from L2:
//   the whole cache is 4.7 MB at B = 8, S = 512 in bf16).
// - Each slot's value column is read from shared memory once and applied
//   to the block's 4 heads (probabilities of every head first, then P·V).
// - The host aims at 2 blocks per SM (kernels/decode_attention.py:
//   decode_splits), since a third does not fit beside two in shared
//   memory: at B = 8, S = 512, 8 splits of 2 tiles, 256 blocks, and a
//   combine over 8 partials of 512 columns a head.
//
// The wide instance (WIDE): GQA at a head dim past kMaxHd, up to kWideHd =
// 256 (recurrentgemma-9b's local layers: KV = 1, G = 16, hd 256, a window
// of 2048 over a ring of slots), f32/bf16/int8/packed4, unpaged, V in its
// own tensor as wide as K. What changes against the narrow instances:
// - A lane owns P·V columns lane, lane + 32, ...: 8 a head at hd 256. A
//   block keeps kBlockG = 8 heads, 64 accumulator floats a lane (the
//   latent instance's pressure: 4 heads × 16), so the group of 16 takes 2
//   blocks, each reading the head's K/V once. The other choice, the latent
//   instance's 4 heads a block with a V pointer and scales of its own,
//   would take 4 blocks re-reading K/V; 8 heads halve that, and the
//   instance is a template parameter of the same body.
// - P·V is the latent instance's shared loop (every head's probability
//   of a slot first, then each value column read from shared memory once
//   for the block's heads; the int8/int4 v_scale folds into the
//   probability), not the per-head loop, which would read each column 8
//   times.
// - A tile of 32 rows is 33 KB of K or V in f32 (a 1 KB row is 64 chunks
//   of 16 bytes, more than a warp's lanes: each lane copies chunks lane,
//   lane + 32, ... of every valid row, as in the latent instance), 17 KB
//   in bf16: two stages of K and V take 133 KB in f32 (one block an SM)
//   and 68 KB in bf16 (two), and the host aims at 2 blocks an SM
//   (kernels/decode_attention.py:blocks_per_sm). At B = 8, S = 512: 16
//   rows of blocks, 16 splits of one tile, 256 blocks.
// - A wrapped ring's valid slots are not in position order: the mask
//   reads each slot's k_pos, so nothing here depends on the order.
//
// The limits below repeat src/repro_torch/kernels/constraints.py.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileS = 32;          // constraints.DECODE_TILE_SLOTS
constexpr int kMaxSplitTiles = 16;  // constraints.DECODE_MAX_SPLIT_TILES
constexpr int kMaxHd = 128;         // constraints.ATTN_MAX_HEAD_DIM
constexpr int kWideHd = 256;        // constraints.ATTN_WIDE_HEAD_DIM
constexpr int kMaxLatentHd = 576;   // constraints.DECODE_MAX_HEAD_DIM
constexpr int kMaxLatentDv = 512;   // constraints.DECODE_LATENT_MAX_DV
constexpr int kLatentBlockG = 4;    // constraints.DECODE_LATENT_BLOCK_GROUP
constexpr int kMaxG = 16;           // constraints.DECODE_MAX_GROUP
constexpr int kBlockG = 8;          // constraints.DECODE_BLOCK_GROUP
constexpr int kRowPad = 16;         // bytes after each stored row in a tile
constexpr int kStages = 2;          // tiles in flight: this one and the next
constexpr int kSubS = kTileS / kWarps;   // slots of a tile one warp owns
constexpr int kSmemMax = 232448;    // shared memory a block may opt in to
constexpr float kNegInf = -0.7f * FLT_MAX;

enum KvKind { kF32 = 0, kBF16 = 1, kInt8 = 2, kPacked4 = 3 };

// Storage of one kind: element bytes, cp.async chunk bytes, columns a
// score read covers, slots a stored row holds (packed4: a byte pair).
template <int KV> struct Kind;
template <> struct Kind<kF32> {
  static constexpr int kElt = 4, kCp = 16, kVec = 4, kSlots = 1;
};
template <> struct Kind<kBF16> {
  static constexpr int kElt = 2, kCp = 16, kVec = 8, kSlots = 1;
};
template <> struct Kind<kInt8> {
  static constexpr int kElt = 1, kCp = 8, kVec = 8, kSlots = 1;
};
template <> struct Kind<kPacked4> {
  static constexpr int kElt = 1, kCp = 8, kVec = 8, kSlots = 2;
};

// Tiles in flight a warp: kStages, one in the f32 latent instance (above).
template <int KV, bool LAT>
__host__ __device__ constexpr int stages() {
  return LAT && KV == kF32 ? 1 : kStages;
}

template <int KV>
__host__ __device__ inline int tile_stride(int hd) {
  return hd * Kind<KV>::kElt + kRowPad;
}
template <int KV>
__host__ __device__ inline int tile_bytes(int hd) {
  return kTileS / Kind<KV>::kSlots * tile_stride<KV>(hd);
}
// Dynamic shared memory: the K and V tiles [stages][tile] each (LAT: the
// K tiles alone; a warp owns kSubS slots of each tile; the area is reused
// by the final merge of the warps, [kWarps][G][dv] f32), then q [G][hd] in
// f32; G is the most query heads a block holds, min(group, kBlockG) (LAT:
// kLatentBlockG); dv is hd but in the latent instance.
template <int KV, bool LAT = false>
__host__ __device__ inline int tiles_bytes(int hd, int G, int dv) {
  const int tiles = (LAT ? 1 : 2) * stages<KV, LAT>() * tile_bytes<KV>(hd);
  const int red = kWarps * G * (LAT ? dv : hd) * 4;
  return tiles > red ? tiles : red;
}
template <int KV, bool LAT>
inline size_t smem_bytes(int hd, int G, int dv) {
  return tiles_bytes<KV, LAT>(hd, G, dv)
      + static_cast<size_t>(G) * hd * sizeof(float);
}

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


template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Columns kVec·w .. kVec·w + kVec − 1 of slot j's stored row, widened to
// f32: one 16- or 8-byte shared-memory read, split in registers. packed4
// takes slot j's nibble with the shift-based sign extension of
// unpack_codes_4bit (low nibble: the even slot).
template <int KV>
__device__ __forceinline__ void read_cols(const unsigned char* tile,
                                          int stride, int j, int w,
                                          float (&x)[Kind<KV>::kVec]) {
  using K = Kind<KV>;
  constexpr int kWords = K::kVec * K::kElt / 4;
  const unsigned char* row = tile + (j / K::kSlots) * stride
      + w * K::kVec * K::kElt;
  uint32_t u[kWords];
  if constexpr (kWords == 4) {
    const uint4 a = *reinterpret_cast<const uint4*>(row);
    u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(row);
    u[0] = a.x; u[1] = a.y;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (KV == kF32) {
      x[i] = __uint_as_float(u[i]);
    } else if constexpr (KV == kBF16) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sh = KV == kInt8 ? 24 - 8 * e
                                   : ((j & 1) ? 24 : 28) - 8 * e;
        x[4 * i + e] = static_cast<float>(
            static_cast<int>(u[i] << sh) >> (KV == kInt8 ? 24 : 28));
      }
    }
  }
}

// Column c of slot j's stored row (packed4: slot j's nibble of byte row
// j / 2), widened to f32.
template <int KV>
__device__ __forceinline__ float read_col(const unsigned char* tile,
                                          int stride, int j, int c) {
  const unsigned char* row = tile + (j / Kind<KV>::kSlots) * stride;
  if constexpr (KV == kF32) {
    return reinterpret_cast<const float*>(row)[c];
  } else if constexpr (KV == kBF16) {
    return to_f32(reinterpret_cast<const __nv_bfloat16*>(row)[c]);
  } else if constexpr (KV == kInt8) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(row)[c]);
  } else {
    const int byte = row[c];
    return static_cast<float>((j & 1) ? (byte << 24) >> 28
                                      : (byte << 28) >> 28);
  }
}

// S counts a row's logical slots (nb * page when PAGED). Unpaged, slot j of
// (b, h) is flat slot bh * S + j; paged, it is (pg * KVH + h) * page +
// j % page with pg = block_table[b * nb + j / page].
// MG: the query heads a block's accumulators are sized for (1 for G = 1,
// else kBlockG; kLatentBlockG in the latent instance): MHA models keep 4
// registers of accumulators a lane instead of 32. blockIdx.x = h ·
// ceil(G / MG) + c: block c of KV head h takes query heads c·MG ..
// min(G, c·MG + MG) − 1 of the group. LAT: the latent instance (header);
// dv < hd columns of V, read from K's rows, and out (B, KVH, G, dv).
// WIDE: the wide GQA instance (header), hd up to kWideHd.
template <typename QT, int KV, bool PAGED, int MG, bool LAT, bool WIDE>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos,
                    const int* __restrict__ block_table, QT* __restrict__ out,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int KVH, int G, int S,
                    int nb, int page, int hd, int window, int split_tiles,
                    float scale, int dv) {
  using K = Kind<KV>;
  static_assert(!LAT || (K::kSlots == 1 && !PAGED),
                "the latent instance reads float rows, unpaged");
  static_assert(!(LAT && WIDE) && !(WIDE && PAGED),
                "the wide instance is GQA over the unpaged cache");
  constexpr int kSubRows = kSubS / K::kSlots;   // stored rows a warp owns
  // P·V columns a lane owns
  constexpr int kCols = (LAT ? kMaxLatentDv : WIDE ? kWideHd : kMaxHd) / 32;
  // P·V with every head's probabilities first, each value column once
  constexpr bool kSharedPV = LAT || WIDE;
  // a stored row is more chunks than a warp has lanes (f32 past 128, and
  // the latent rows): each lane copies chunks lane, lane + 32, ...
  constexpr bool kLaneChunks = LAT || (WIDE && K::kSlots == 1);
  const int DV = LAT ? dv : hd;                 // V columns (LAT: K's first)
  constexpr int NS = stages<KV, LAT>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float wm_s[kWarps][MG], wl_s[kWarps][MG];
  __shared__ unsigned ok_s[kMaxSplitTiles];       // valid-slot mask per tile
  __shared__ int row_s[kMaxSplitTiles * kTileS];  // flat slot of valid slots

  // MG = 1 is launched only for G = 1: one block a KV head, all of its
  // heads (the expressions below reduce to G and 0 there)
  const int gblocks = MG == 1 ? 1 : (G + MG - 1) / MG;
  const int h = blockIdx.x / gblocks;
  const int g0 = (blockIdx.x % gblocks) * MG;     // this block's first head
  const int GS = MG == 1 ? G : min(G, MG);        // heads of the smem layout
  const int GB = MG == 1 ? G : min(GS, G - g0);   // heads of this block
  const int b = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const size_t bh = static_cast<size_t>(b) * KVH + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool quantized = k_scale != nullptr;
  const int qp = q_pos[b];
  const int s0 = split * split_tiles * kTileS;
  const int n_tiles = min(split_tiles, (S - s0 + kTileS - 1) / kTileS);
  const int stride = tile_stride<KV>(hd);
  const int sub_bytes = kSubRows * stride;      // a warp's share of a tile
  float* qs = reinterpret_cast<float*>(smem + tiles_bytes<KV, LAT>(hd, GS,
                                                                   dv));

  for (int t = warp; t < n_tiles; t += kWarps) {
    const int j = s0 + t * kTileS + lane;
    bool ok = false;
    if (j < S) {
      const int kp = k_pos[static_cast<size_t>(b) * S + j];
      ok = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
    }
    if (ok) {
      long long row;
      if (PAGED) {
        const int pg = block_table[static_cast<size_t>(b) * nb + j / page];
        row = (static_cast<long long>(pg) * KVH + h) * page + j % page;
      } else {
        row = static_cast<long long>(bh) * S + j;
      }
      row_s[t * kTileS + lane] = static_cast<int>(row);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) ok_s[t] = mask;
  }
  for (int i = threadIdx.x; i < GB * hd; i += kThreads)
    qs[i] = to_f32(q[(bh * G + g0) * hd + i]);
  __syncthreads();

  // From here each warp is an independent flash-decode over its kSubS
  // slots of every tile, with its own running max/sum and accumulators:
  // no block barrier until the warps merge.
  auto wmask = [&](int t) {
    return (ok_s[t] >> (warp * kSubS)) & ((1u << kSubS) - 1u);
  };
  auto next_live = [&](int t) {
    while (t < n_tiles && wmask(t) == 0u) ++t;
    return t;
  };
  unsigned char* kw = smem + warp * sub_bytes;                   // stage 0
  unsigned char* vw = LAT ? kw   // V: the first DV columns of K's rows
      : smem + kStages * kWarps * sub_bytes + warp * sub_bytes;
  // this warp's valid rows of tile t into stage st (packed4: the byte
  // rows of the pairs with a valid slot)
  // a lane copies chunk lc of stored rows lr, lr + rows_per_pass, ...
  // (no division in the loop; per_row <= 32: a row is at most 512 bytes,
  // or kLaneChunks)
  const int per_row = hd * K::kElt / K::kCp;
  const int rows_per_pass = 32 / per_row;
  const int lr = lane / per_row, lc = lane % per_row;
  const char* kg = static_cast<const char*>(k);
  const char* vg = static_cast<const char*>(v);
  auto load = [&](int t, int st) {
    const unsigned mask = wmask(t);
    if constexpr (kLaneChunks) {
      // every lane copies chunks lane, lane + 32, ... of each valid row
      // (the mask is the warp's own; LAT: K's rows alone)
      for (int r = 0; r < kSubRows; ++r) {
        if (!((mask >> r) & 1u)) continue;
        const size_t off = static_cast<size_t>(
            row_s[t * kTileS + warp * kSubS + r]) * hd * K::kElt;
        const int so = st * kWarps * sub_bytes + r * stride;
        for (int c = lane; c < per_row; c += 32) {
          cp_async<K::kCp>(kw + so + c * K::kCp, kg + off + c * K::kCp);
          if constexpr (!LAT)
            cp_async<K::kCp>(vw + so + c * K::kCp, vg + off + c * K::kCp);
        }
      }
      return;
    }
    for (int r = lr; r < kSubRows && lr < rows_per_pass; r += rows_per_pass) {
      const unsigned bits =
          (mask >> (r * K::kSlots)) & (K::kSlots == 2 ? 3u : 1u);
      if (!bits) continue;
      const int slot = t * kTileS + warp * kSubS + r * K::kSlots
          + ((bits & 1u) ? 0 : 1);
      const size_t off = static_cast<size_t>(row_s[slot] / K::kSlots) * hd
          * K::kElt + lc * K::kCp;
      const int so = st * kWarps * sub_bytes + r * stride + lc * K::kCp;
      cp_async<K::kCp>(kw + so, kg + off);
      cp_async<K::kCp>(vw + so, vg + off);
    }
  };

  const int sl = lane / 4, qd = lane % 4;   // scores: slot, head-dim quarter
  float m[MG], l[MG], acc[MG][kCols];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[g][i] = 0.f;
  }

  int t = next_live(0);
  if (t < n_tiles) {
    // NS - 1 live tiles ahead; one cp.async group per tile (empty past
    // the last), so "all but the newest NS - 1 groups" is the tile about
    // to be computed
    int ahead = t;
    for (int st = 0; st < NS - 1; ++st) {
      if (ahead < n_tiles) {
        load(ahead, st);
        ahead = next_live(ahead + 1);
      }
      cp_async_commit();
    }
    int st = 0;
    while (t < n_tiles) {
      if (ahead < n_tiles) {   // into the stage the last tile used
        load(ahead, (st + NS - 1) % NS);
        ahead = next_live(ahead + 1);
      }
      cp_async_commit();
      cp_async_wait<NS - 1>();
      __syncwarp();
      const unsigned mask = wmask(t);
      const unsigned char* kt = kw + st * kWarps * sub_bytes;
      const unsigned char* vt = vw + st * kWarps * sub_bytes;
      const bool ok = (mask >> sl) & 1u;
      const int row = row_s[t * kTileS + warp * kSubS + sl];

      // scores: a quad of lanes per slot, each a quarter of the vectors
      float s[MG];
#pragma unroll
      for (int g = 0; g < MG; ++g) s[g] = 0.f;
      if (ok) {
        for (int w = qd; w < hd / K::kVec; w += 4) {
          float x[K::kVec];
          read_cols<KV>(kt, stride, sl, w, x);
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            if (g < GB) {
              const float4* q4 =
                  reinterpret_cast<const float4*>(qs + g * hd + w * K::kVec);
#pragma unroll
              for (int e = 0; e < K::kVec / 4; ++e) {
                const float4 qv = q4[e];
                s[g] = fmaf(qv.x, x[4 * e], s[g]);
                s[g] = fmaf(qv.y, x[4 * e + 1], s[g]);
                s[g] = fmaf(qv.z, x[4 * e + 2], s[g]);
                s[g] = fmaf(qv.w, x[4 * e + 3], s[g]);
              }
            }
          }
        }
      }
      const float ksc = ok && quantized ? k_scale[row] * scale : scale;
      const float vsc = ok && quantized ? v_scale[row] : 1.f;

      // online softmax over the warp's slots, P·V with p from the slot's
      // quad; lanes own columns lane, lane + 32, ...
      if constexpr (kSharedPV) {
        // every head's probabilities first, then each value column read
        // once for the block's heads
        float pg[MG];
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          pg[g] = 0.f;
          if (g < GB) {
            float sg = s[g];
            sg += __shfl_xor_sync(0xffffffffu, sg, 1);
            sg += __shfl_xor_sync(0xffffffffu, sg, 2);
            sg = ok ? sg * ksc : kNegInf;
            float mx = sg;
            for (int o = 4; o < 32; o <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[g], mx);   // real: a slot is valid
            const float p = ok ? expf(sg - m_new) : 0.f;
            float sum = p;
            for (int o = 4; o < 32; o <<= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, o);
            const float corr = expf(m[g] - m_new);
            m[g] = m_new;
            l[g] = l[g] * corr + sum;
            pg[g] = LAT ? p : p * vsc;   // LAT: no scales
#pragma unroll
            for (int i = 0; i < kCols; ++i) acc[g][i] *= corr;
          }
        }
#pragma unroll
        for (int j = 0; j < kSubS; ++j) {
          if ((mask >> j) & 1u) {                 // the same for the warp
            float pj[MG];
#pragma unroll
            for (int g = 0; g < MG; ++g)
              pj[g] = __shfl_sync(0xffffffffu, pg[g], 4 * j);
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              const int c = lane + 32 * i;
              if (c < DV) {
                const float vv = read_col<KV>(vt, stride, j, c);
#pragma unroll
                for (int g = 0; g < MG; ++g)
                  if (g < GB) acc[g][i] = fmaf(pj[g], vv, acc[g][i]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (!kSharedPV && g < GB) {
          float sg = s[g];
          sg += __shfl_xor_sync(0xffffffffu, sg, 1);
          sg += __shfl_xor_sync(0xffffffffu, sg, 2);
          sg = ok ? sg * ksc : kNegInf;
          float mx = sg;
          for (int o = 4; o < 32; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[g], mx);   // real: a slot is valid
          float p = ok ? expf(sg - m_new) : 0.f;
          float sum = p;
          for (int o = 4; o < 32; o <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          const float corr = expf(m[g] - m_new);
          m[g] = m_new;
          l[g] = l[g] * corr + sum;
          p *= vsc;
#pragma unroll
          for (int i = 0; i < kCols; ++i) acc[g][i] *= corr;
#pragma unroll
          for (int j = 0; j < kSubS; ++j) {
            const float pj = __shfl_sync(0xffffffffu, p, 4 * j);
            if ((mask >> j) & 1u) {
#pragma unroll
              for (int i = 0; i < kCols; ++i) {
                const int c = lane + 32 * i;
                if (c < DV)
                  acc[g][i] = fmaf(pj, read_col<KV>(vt, stride, j, c),
                                   acc[g][i]);
              }
            }
          }
        }
      }
      __syncwarp();   // the next iteration refills this stage
      st = (st + 1) % NS;
      t = next_live(t + 1);
    }
  }

  // merge the warps in order (through the now idle tile buffers), then
  // write the output (one split) or this split's partial
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [kWarps][GS][DV]
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g < GB) {
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (lane + 32 * i < DV)
          red[(warp * GS + g) * DV + lane + 32 * i] = acc[g][i];
      if (lane == 0) {
        wm_s[warp][g] = m[g];
        wl_s[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  const size_t pidx = bh * splits + split;
  for (int i = threadIdx.x; i < GB * DV; i += kThreads) {
    const int g = i / DV, d = i % DV;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm_s[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm_s[w][g] - mx);   // an empty warp has l = 0
      lsum += wl_s[w][g] * c;
      a += red[(w * GS + g) * DV + d] * c;
    }
    const int gq = g0 + g;                       // the head in the group
    if (splits == 1) {
      out[(bh * G + gq) * DV + d] = from_f32<QT>(lsum > 0.f ? a / lsum : 0.f);
    } else {
      acc_part[(pidx * G + gq) * DV + d] = a;
      if (d == 0) {
        m_part[pidx * G + gq] = mx;
        l_part[pidx * G + gq] = lsum;
      }
    }
  }
}

// Merge the splits of each (b, h, g): out = Σ_s acc_s·e^(m_s − M) /
// Σ_s l_s·e^(m_s − M), in split order; zeros when every split is empty.
// Grid (B·KVH, G), a thread a head-dim column: a wide group (chatglm3-6b:
// 16 heads over 16 splits) spreads over G times more blocks than a block
// a KV head would give it.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part, QT* __restrict__ out,
                      int G, int hd, int splits) {
  const size_t bh = blockIdx.x;
  const int g = blockIdx.y;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, m_part[(bh * splits + s) * G + g]);
    float l = 0.f, a = 0.f;
    if (mx > 0.5f * kNegInf) {
      for (int s = 0; s < splits; ++s) {
        const size_t p = (bh * splits + s) * G + g;
        const float w = expf(m_part[p] - mx);
        l += l_part[p] * w;
        a += acc_part[p * hd + d] * w;
      }
    }
    out[(bh * G + g) * hd + d] = from_f32<QT>(l > 0.f ? a / l : 0.f);
  }
}

template <typename QT, int KV, bool PAGED, int MG, bool LAT = false,
          bool WIDE = false>
int launch_groups(const QT* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* qp, const int* kp, const int* bt,
                QT* out, float* m_part, float* l_part, float* acc_part, int B,
                int KVH, int G, int S, int nb, int page, int hd, int window,
                int splits, int split_tiles, float scale, int dv,
                cudaStream_t s) {
  const size_t smem = smem_bytes<KV, LAT>(hd, G < MG ? G : MG, dv);
  if (smem > static_cast<size_t>(kSmemMax) - 4 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t opted = 44 * 1024;   // under the default with the static part
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<QT, KV, PAGED, MG, LAT, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid(KVH * ((G + MG - 1) / MG), B, splits);
  flash_decode_kernel<QT, KV, PAGED, MG, LAT, WIDE>
      <<<grid, kThreads, smem, s>>>(
      q, k, v, ks, vs, qp, kp, bt, out, m_part, l_part, acc_part, KVH, G, S,
      nb, page, hd, window, split_tiles, scale, dv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  decode_combine_kernel<QT><<<dim3(B * KVH, G), kThreads, 0, s>>>(
      m_part, l_part, acc_part, out, G, LAT ? dv : hd, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, int KV, bool PAGED>
int launch_kind(const QT* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* qp, const int* kp, const int* bt,
                QT* out, float* m_part, float* l_part, float* acc_part, int B,
                int KVH, int G, int S, int nb, int page, int hd, int window,
                int splits, int split_tiles, float scale, int dv, bool latent,
                cudaStream_t s) {
  if (latent) {                  // the latent instance (checked in launch_q)
    if constexpr ((KV == kF32 || KV == kBF16) && !PAGED)
      return launch_groups<QT, KV, false, kLatentBlockG, true>(
          q, k, v, ks, vs, qp, kp, bt, out, m_part, l_part, acc_part, B, KVH,
          G, S, nb, page, hd, window, splits, split_tiles, scale, dv, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd > kMaxHd) {             // the wide instance, unpaged
    if constexpr (!PAGED)
      return launch_groups<QT, KV, false, kBlockG, false, true>(
          q, k, v, ks, vs, qp, kp, bt, out, m_part, l_part, acc_part, B, KVH,
          G, S, nb, page, hd, window, splits, split_tiles, scale, hd, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return G == 1
      ? launch_groups<QT, KV, PAGED, 1>(q, k, v, ks, vs, qp, kp, bt, out,
                                        m_part, l_part, acc_part, B, KVH, G,
                                        S, nb, page, hd, window, splits,
                                        split_tiles, scale, hd, s)
      : launch_groups<QT, KV, PAGED, kBlockG>(q, k, v, ks, vs, qp, kp, bt,
                                              out, m_part, l_part, acc_part, B,
                                              KVH, G, S, nb, page, hd, window,
                                              splits, split_tiles, scale, hd,
                                              s);
}

template <typename QT, bool PAGED>
int launch_q(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* q_pos, const void* k_pos,
             const void* block_table, void* out, void* m_part, void* l_part,
             void* acc_part, int B, int KVH, int G, int S, int nb, int ps,
             int hd, int dv, bool latent, int window, int splits,
             int split_tiles, float scale, int kv_kind, cudaStream_t stream) {
  if (split_tiles < 1 || split_tiles > kMaxSplitTiles || splits < 1
      || (splits - 1) * split_tiles * kTileS >= S || G > kMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  // GQA: V as wide as K, hd <= kMaxHd, or kWideHd unpaged; latent: V K's
  // first dv <= kMaxLatentDv columns, float kinds, unpaged
  if (hd > kMaxLatentHd || dv < 1
      || (latent ? dv > kMaxLatentDv || dv > hd || PAGED
                       || (kv_kind != kF32 && kv_kind != kBF16)
                 : dv != hd || hd > (PAGED ? kMaxHd : kWideHd)))
    return static_cast<int>(cudaErrorInvalidValue);
  const QT* qq = static_cast<const QT*>(q);
  QT* oo = static_cast<QT*>(out);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const int* bt = static_cast<const int*>(block_table);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
#define REPRO_DECODE_CASE(KIND)                                              \
  case KIND:                                                                 \
    return launch_kind<QT, KIND, PAGED>(qq, k, v, kss, vss, qp, kp, bt, oo,  \
                                        mp, lp, ap, B, KVH, G, S, nb, ps, hd, \
                                        window, splits, split_tiles, scale,  \
                                        dv, latent, stream);
  switch (kv_kind) {
    REPRO_DECODE_CASE(kF32)
    REPRO_DECODE_CASE(kBF16)
    REPRO_DECODE_CASE(kInt8)
    REPRO_DECODE_CASE(kPacked4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_CASE
}

}  // namespace

// q (B, KVH, G, hd), out (B, KVH, G, dv) f32/bf16 (q_bf16); k, v per
// kv_kind (0 f32, 1 bf16, 2 int8, 3 packed4 (B, KVH, S/2, hd) uint8);
// k_scale, v_scale (B, KVH, S) f32 or null; q_pos (B,) and k_pos (B, S)
// int32. S counts logical slots. latent = 0: dv = hd <= 256, v its own
// tensor; latent != 0 (the latent instance: f32/bf16): dv <= 512 and v = k
// (its rows' first dv columns).
// The slot axis runs in `splits` blocks of `split_tiles` 32-slot tiles;
// with splits > 1, m_part, l_part (B, KVH, splits, G) and acc_part
// (B, KVH, splits, G, dv) f32 are scratch for the combine (null otherwise).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* q_pos, const void* k_pos,
                                   void* out, void* m_part, void* l_part,
                                   void* acc_part, int B, int KVH, int G,
                                   int S, int hd, int dv, int latent,
                                   int window, int kv_kind, int q_bf16,
                                   int splits, int split_tiles, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16
      ? launch_q<__nv_bfloat16, false>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                                       nullptr, out, m_part, l_part, acc_part,
                                       B, KVH, G, S, 0, 1, hd, dv, latent != 0,
                                       window, splits, split_tiles, scale,
                                       kv_kind, s)
      : launch_q<float, false>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                               nullptr, out, m_part, l_part, acc_part, B, KVH,
                               G, S, 0, 1, hd, dv, latent != 0, window, splits,
                               split_tiles, scale, kv_kind, s);
}

// K5. q, out, scratch as above; k, v the page pools (P, KVH, ps, hd) per
// kv_kind (packed4: (P, KVH, ps/2, hd) uint8); k_scale, v_scale (P, KVH, ps)
// f32 or null; block_table (B, nb) int32, every entry a valid page; q_pos
// (B,) and k_pos (B, nb * ps) int32. ps is even.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* q_pos, const void* k_pos,
    const void* block_table, void* out, void* m_part, void* l_part,
    void* acc_part, int B, int KVH, int G, int nb, int ps, int hd, int window,
    int kv_kind, int q_bf16, int splits, int split_tiles, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16
      ? launch_q<__nv_bfloat16, true>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                                      block_table, out, m_part, l_part,
                                      acc_part, B, KVH, G, nb * ps, nb, ps, hd,
                                      hd, false, window, splits, split_tiles,
                                      scale, kv_kind, s)
      : launch_q<float, true>(q, k, v, k_scale, v_scale, q_pos, k_pos,
                              block_table, out, m_part, l_part, acc_part, B,
                              KVH, G, nb * ps, nb, ps, hd, hd, false, window,
                              splits, split_tiles, scale, kv_kind, s);
}
