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
// about 5.03 B a weight against ~70 integer/float operations, far below
// the card's ops-per-byte balance.
//
// Design: one thread per column walks one 32-row block (grid.y), holding
// the block's 32 values in registers between the abs-max pass and the
// rounding pass, so w is read from device memory once. Neighbouring
// threads take neighbouring columns: every row of the block is one
// coalesced read of 4 B a thread and one coalesced write of 1 B a thread.
//
// Exactness — the exponent must equal the plain version bit for bit:
//   * ceil(log2(q)) comes from frexpf on the correctly rounded f32
//     quotient q = amax / qmax: q = m·2^x with m in [0.5, 1), so
//     ceil(log2 q) = x - 1 when m == 0.5 (q a power of two) and x
//     otherwise. log2f is not used: even a correctly rounded log2 of a q
//     just above a power of two rounds to the integer below, and the
//     ceiling then loses one;
//   * w · 2^-e is ldexpf, exact wherever the code can be non-zero;
//   * rintf rounds half to even, as torch.round does;
//   * the build has no --use_fast_math, so the division is IEEE and
//     subnormals are kept.
// The limits below repeat src/repro_torch/kernels/constraints.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMxBlock = 32;      // constraints.MXINT_BLOCK
constexpr int kThreads = 256;
constexpr int kMaxExp = 127;      // int8 exponent range, as the reference

__global__ void __launch_bounds__(kThreads)
mxint_quantize_kernel(const float* __restrict__ w, int8_t* __restrict__ codes,
                      int8_t* __restrict__ exps, int N, int qmax) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * kMxBlock;
  const float* col = w + row0 * N + n;
  float v[kMxBlock];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMxBlock; ++i) {
    v[i] = col[static_cast<size_t>(i) * N];
    amax = fmaxf(amax, fabsf(v[i]));
  }
  const float q = __fdiv_rn(amax > 0.f ? amax : 1.f, static_cast<float>(qmax));
  int x;
  const float mant = frexpf(q, &x);
  const int e = min(max(mant == 0.5f ? x - 1 : x, -kMaxExp), kMaxExp);
  exps[static_cast<size_t>(blockIdx.y) * N + n] = static_cast<int8_t>(e);
  int8_t* out = codes + row0 * N + n;
  const float lo = static_cast<float>(-qmax - 1), hi = static_cast<float>(qmax);
#pragma unroll
  for (int i = 0; i < kMxBlock; ++i) {
    const float c = amax > 0.f ? fminf(fmaxf(rintf(ldexpf(v[i], -e)), lo), hi)
                               : 0.f;
    out[static_cast<size_t>(i) * N] = static_cast<int8_t>(c);
  }
}

}  // namespace

// w (M, N) f32 contiguous, M % 32 == 0; codes (M, N) int8; exps (M/32, N)
// int8. qmax = 2^(bits-1) - 1.
extern "C" int mxint_quantize_launch(const void* w, void* codes, void* exps,
                                     int M, int N, int qmax, void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, M / kMxBlock);
  mxint_quantize_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<int8_t*>(codes),
      static_cast<int8_t*>(exps), N, qmax);
  return static_cast<int>(cudaGetLastError());
}
