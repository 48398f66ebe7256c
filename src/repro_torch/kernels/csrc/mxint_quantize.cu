// K7: MXINT block quantization, w (M, N) f32 → codes int8 (M, N) and
// exponents int8 (M/32, N).
//
// Replaces the Pallas TPU kernel mxint_quantize_2d (body _kernel) in
// src/repro/kernels/mxint_quantize.py. Per 32-row block of a column:
//   amax = max |w|;  e = clip(ceil(log2(max(amax, 1·[amax == 0]) / qmax)),
//   -127, 127);  code = clip(rint(w · 2^-e), -qmax-1, qmax), 0 for an
//   all-zero block.
//
// What bounds it on an H100: bytes. Each weight is read once (4 B) and
// written once as a code (1 B), plus one exponent byte per 32 weights —
// about 5.03 B a weight. The SRR pass calls it on 14.5 MB (2048×1408) at a
// time, so a few microseconds of ramp and tail are a large share of a call,
// and the arithmetic must stay a few instructions a weight or too few warps
// cannot hide it: one fma, two clamps and a byte permute a weight (below).
//
// Design (the register path, mxint_quantize_kernel): a persistent grid
// (kernels/mxint_quantize.py mxint_quantize_plan: 64-thread blocks, at most
// four an SM, as many as the work needs) walks items of one 32-row block ×
// four columns, item it + k·(grid threads) for thread it. A thread loads
// its item's 32 rows as 16-byte float4s, all in flight at once (512 B a
// thread), takes the four columns' abs-max in registers, and stores each
// row's four codes as one 4-byte store (a warp writes 128 contiguous bytes
// of a row) and the four exponents as one. The same launch takes the
// scalar path where w's address is not 16-byte aligned or N is not a
// multiple of 4, and where there are too few quads to give every SM a
// block (N = 64): one thread per (32-row block, column), 32 scalar loads
// and 1-byte stores, over the same grid-stride walk.
//
// A bulk-copy design (a producer warp feeding a shared-memory ring through
// cp.async.bulk under mbarriers) was probed against this one on an H100
// and was no faster, with ~2 µs more a launch (PERF.md §6).
//
// Exactness — the exponent must equal the plain version bit for bit:
//   * ceil(log2(q)) comes from frexpf on the correctly rounded f32
//     quotient q = amax / qmax (__fdiv_rn): q = m·2^x with m in [0.5, 1),
//     so ceil(log2 q) = x - 1 when m == 0.5 (q a power of two) and x
//     otherwise. log2f is not used: even a correctly rounded log2 of a q
//     just above a power of two rounds to the integer below, and the
//     ceiling then loses one;
//   * the code is one fma: w · 2^-e + 1.5·2^23 rounded once, to nearest
//     even (kRound below), is kRound + rintf(ldexpf(w, -e)), because the
//     product by the power of two 2^-e (ldexpf(1, -e), exact, a subnormal at
//     e = 127) is exact wherever it is at least 2^-126, and below that both
//     give 0; the clamp to [-qmax-1, qmax] is taken on that sum, whose low
//     byte is then the code. Ties go to even, as torch.round's do;
//   * the build has no --use_fast_math, so the division is IEEE and
//     subnormals are kept.
// The limits below repeat src/repro_torch/kernels/constraints.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMxBlock = 32;      // constraints.MXINT_BLOCK
constexpr int kMaxExp = 127;      // int8 exponent range, as the reference
constexpr int kVec = 4;           // constraints.MXINT_VEC
constexpr int kThreads = 64;      // constraints.MXINT_THREADS
// constraints.MXINT_PATH_*
constexpr int kPathScalar = 0, kPathRegisters = 1;

// ---------------------------------------------------------------------------
// arithmetic shared by the two paths
// ---------------------------------------------------------------------------
// 1.5·2^23. For |x| < 2^22 the f32 sum x + kRound has an ulp of 1, so it is
// x rounded to an integer k, ties to even (kRound is even), and its bits
// are bits(kRound) + k: the low byte is k as an int8.
constexpr float kRound = 12582912.f;

__device__ __forceinline__ int block_exponent(float amax, int qmax) {
  const float q = __fdiv_rn(amax > 0.f ? amax : 1.f, static_cast<float>(qmax));
  int x;
  const float mant = frexpf(q, &x);
  return min(max(mant == 0.5f ? x - 1 : x, -kMaxExp), kMaxExp);
}

// One column's 32-row block: 2^-e (exact, a subnormal at e = 127) and the
// clamp [-qmax-1, qmax] shifted by kRound.
struct ColumnScale {
  float s, lo, hi;
  __device__ __forceinline__ ColumnScale(int e, int qmax)
      : s(ldexpf(1.f, -e)), lo(kRound - static_cast<float>(qmax + 1)),
        hi(kRound + static_cast<float>(qmax)) {}
  // kRound + the code of v: rint(v·2^-e) clamped. v·2^-e is exact (a
  // product by a power of two) wherever |v·2^-e| ≥ 2^-126, so the single
  // rounding of the fma is rintf(ldexpf(v, -e)); below that both give 0.
  // |v·2^-e| ≤ max(qmax, 2) here, far inside kRound's exact range.
  __device__ __forceinline__ float code(float v) const {
    return fminf(fmaxf(fmaf(v, s, kRound), lo), hi);
  }
};

// The low bytes of four 32-bit values, the first at the lowest address.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ void col_max(float (&a)[kVec], float4 v) {
  a[0] = fmaxf(a[0], fabsf(v.x));
  a[1] = fmaxf(a[1], fabsf(v.y));
  a[2] = fmaxf(a[2], fabsf(v.z));
  a[3] = fmaxf(a[3], fabsf(v.w));
}

// One 32-row block of four columns, row r's four values in v[r]: writes
// the 32 code rows (4 bytes each, row stride N) at `out` and the four
// exponents at `exp_out`.
__device__ __forceinline__ void quantize_quad(const float4 (&v)[kMxBlock],
                                              int8_t* out, int8_t* exp_out,
                                              int N, int qmax) {
  float a[kVec] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < kMxBlock; ++r) col_max(a, v[r]);
  const int e0 = block_exponent(a[0], qmax), e1 = block_exponent(a[1], qmax),
            e2 = block_exponent(a[2], qmax), e3 = block_exponent(a[3], qmax);
  const ColumnScale c0(e0, qmax), c1(e1, qmax), c2(e2, qmax), c3(e3, qmax);
#pragma unroll
  for (int r = 0; r < kMxBlock; ++r) {
    const float4 x = v[r];
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r) * N) =
        pack4(__float_as_uint(c0.code(x.x)), __float_as_uint(c1.code(x.y)),
              __float_as_uint(c2.code(x.z)), __float_as_uint(c3.code(x.w)));
  }
  *reinterpret_cast<uint32_t*>(exp_out) = pack4(e0, e1, e2, e3);
}

// ---------------------------------------------------------------------------
// the kernel: the register path, or the scalar path
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
mxint_quantize_kernel(const float* __restrict__ w, int8_t* __restrict__ codes,
                      int8_t* __restrict__ exps, int nb, int N, int qmax,
                      int path) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (path == kPathScalar) {          // one (32-row block, column) an item
    const long long items = static_cast<long long>(nb) * N;
    for (long long it = first; it < items; it += stride) {
      const size_t rb = static_cast<size_t>(it / N);
      const int n = static_cast<int>(it % N);
      const float* col = w + rb * kMxBlock * N + n;
      float v[kMxBlock];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kMxBlock; ++i) {
        v[i] = col[static_cast<size_t>(i) * N];
        amax = fmaxf(amax, fabsf(v[i]));
      }
      const int e = block_exponent(amax, qmax);
      exps[rb * N + n] = static_cast<int8_t>(e);
      const ColumnScale c(e, qmax);
      int8_t* out = codes + rb * kMxBlock * N + n;
#pragma unroll
      for (int i = 0; i < kMxBlock; ++i)
        out[static_cast<size_t>(i) * N] =
            static_cast<int8_t>(__float_as_uint(c.code(v[i])));
    }
    return;
  }
  const int quads = N / kVec;         // one (32-row block, 4 columns) an item
  const long long items = static_cast<long long>(nb) * quads;
  for (long long it = first; it < items; it += stride) {
    const size_t rb = static_cast<size_t>(it / quads);
    const int n = static_cast<int>(it % quads) * kVec;
    const float4* src =
        reinterpret_cast<const float4*>(w + rb * kMxBlock * N + n);
    float4 v[kMxBlock];
#pragma unroll
    for (int r = 0; r < kMxBlock; ++r)
      v[r] = __ldg(src + static_cast<size_t>(r) * quads);
    quantize_quad(v, codes + rb * kMxBlock * N + n, exps + rb * N + n, N,
                  qmax);
  }
}

}  // namespace

// w (M, N) f32 contiguous, M % 32 == 0; codes (M, N) int8; exps (M/32, N)
// int8; qmax = 2^(bits-1) - 1. The plan (kernels/mxint_quantize.py
// mxint_quantize_plan): `path` (0 scalar, 1 register) and the persistent
// `grid` of 64-thread blocks. The register path needs w 16-byte aligned
// and N % 4 == 0, which the plan checks.
extern "C" int mxint_quantize_launch(const void* w, void* codes, void* exps,
                                     int M, int N, int qmax, int path,
                                     int grid, void* stream) {
  if ((path != kPathScalar && path != kPathRegisters) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  mxint_quantize_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<int8_t*>(codes),
      static_cast<int8_t*>(exps), M / kMxBlock, N, qmax, path);
  return static_cast<int>(cudaGetLastError());
}
