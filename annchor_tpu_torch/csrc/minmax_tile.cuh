// The tile of K4 (tropical_tighten.cu) and K9a (band_linf.cu): a 64 x 64
// block of outputs out[i][j] = reduce over k of f(A[k][i], B[k][j]), the
// shape of a float32 matrix product without the tensor cores (max and min
// have no wgmma path).  Both operands are read transposed, k-major, so a
// slab of KS rows of k is a run of contiguous floats per k: coalesced
// loads and bank-conflict-free shared-memory stores.
//
// 256 threads, 16 x 16; thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and
// columns 4 tx .. 4 tx + 3 of the tile, so each k costs it two 16-byte
// shared-memory loads for 16 outputs.  Entries outside the operand
// (k >= K, a row or column past the end) are staged as NaN: fmaxf and
// fminf return their other argument for a NaN, so a NaN step leaves every
// accumulator as it was.
#pragma once

#include <cuda_runtime.h>

namespace annchor_tile {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMicro = 4;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// dst[k][c] = src[(k0 + k) * ld + c0 + c] for k < KS, c < kTile, NaN
// outside k0 + k < K and c0 + c < n.
template <int KS>
__device__ __forceinline__ void load_slab(float (*dst)[kTile], const float* __restrict__ src,
                                          long long ld, int k0, int K, int c0, int n) {
#pragma unroll
  for (int s = 0; s < KS * kTile / kThreads; ++s) {
    const int idx = threadIdx.x + s * kThreads;
    const int k = idx / kTile;
    const int c = idx % kTile;
    const bool in = k0 + k < K && c0 + c < n;
    dst[k][c] = in ? __ldg(src + (k0 + k) * ld + c0 + c) : nan_f();
  }
}

// The 4 values of a thread's rows (or columns) at slab row k.
__device__ __forceinline__ float4 quad(const float (*s)[kTile], int k, int t) {
  return *reinterpret_cast<const float4*>(&s[k][t * kMicro]);
}

__device__ __forceinline__ float lane(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

}  // namespace annchor_tile
