// K4: the dense tropical tighten, the self-product of the computed-distance
// matrix in both tropical semirings at once:
//
//     LB[i][j] = max over y of |E[i][y] - E[j][y]|   (both entries present)
//     UB[i][j] = min over y of  E[i][y] + E[j][y]    (both entries present)
//
// over the columns y0 .. y1 the wrapper hands over, starting from 0 and
// +inf.  Replaces the XLA program `_tighten_full` of
// annchor_tpu/ops/device_pipeline.py (a blocked broadcast that XLA fuses
// into its max/min reductions), not a Pallas kernel.  Its plain PyTorch
// version is `tropical_product_plain` in
// annchor_tpu_torch/ops/device_pipeline.py, which writes an (nx, nx, 16)
// temporary per 16 columns; the wrapper is ops/tropical_cuda.py.
//
// The mask costs nothing: the wrapper stores an absent entry as NaN
// (ET[y][i] = E[i][y0 + y] where present, NaN where not), and
// fmaxf(acc, |NaN - x|) and fminf(acc, NaN + x) both return acc.  So the
// result is the plain version's bit for bit, which takes 0 where a pair
// of entries is not both present and +inf where one is absent: max and
// min are order-free and every value is one float32 subtraction or
// addition of the same two entries, with no contraction and no flush to
// zero.  That needs finite distances, which the fit checks.
//
// What bounds it on the H100: for each (i, j, y) two FADD and two FMNMX;
// the FMNMX at 64 lanes a clock per SM, 132 x 64 x 1.98e9 = 1.67e13 a
// second.  LB and UB are symmetric (|a - b| = |b - a| and a + b = b + a
// exactly), so only the tiles on and above the diagonal are computed, and
// each off-diagonal tile is also written mirrored, through shared memory
// so the stores stay coalesced: nx (nx + 1) / 2 x (y1 - y0) steps, 2
// FMNMX each.  At nx 1,600 over every column that is 0.245 ms; the
// inputs and outputs (ny x nx + 2 nx^2 floats, 31 MB) take 9 us at 3.35
// TB/s.  The design: the (minmax_tile.cuh) tile of a float32 matrix
// product, 64 x 64 outputs a block, 16 a thread, both semirings in one
// pass over a 16-row slab of y in shared memory, the operand read once
// per slab for 64 x 2 x 16 x 16 FP operations of the thread block.

#include <cuda_runtime.h>

#include "minmax_tile.cuh"

namespace {

using namespace annchor_tile;

constexpr int kSlab = 16;

__global__ void __launch_bounds__(kThreads)
k4_tropical(const float* __restrict__ ET, int ny, int nx, float* __restrict__ LB,
            float* __restrict__ UB) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  if (ti > tj) return;  // the mirror of tile (tj, ti)
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  __shared__ __align__(16) float As[kSlab][kTile];
  __shared__ __align__(16) float Bs[kSlab][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float lb[kMicro][kMicro];
  float ub[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      lb[r][c] = 0.0f;
      ub[r][c] = __int_as_float(0x7f800000);  // +inf
    }

  for (int k0 = 0; k0 < ny; k0 += kSlab) {
    load_slab<kSlab>(As, ET, nx, k0, ny, i0, nx);
    load_slab<kSlab>(Bs, ET, nx, k0, ny, j0, nx);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlab; ++k) {
      const float4 a = quad(As, k, ty);
      const float4 b = quad(Bs, k, tx);
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const float x = lane(a, r);
          const float y = lane(b, c);
          lb[r][c] = fmaxf(lb[r][c], fabsf(x - y));
          ub[r][c] = fminf(ub[r][c], x + y);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = i0 + ty * kMicro + r;
    if (i >= nx) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = j0 + tx * kMicro + c;
      if (j < nx) {
        LB[static_cast<long long>(i) * nx + j] = lb[r][c];
        UB[static_cast<long long>(i) * nx + j] = ub[r][c];
      }
    }
  }
  if (ti == tj) return;

  // the mirrored tile: out[j][i], staged so that consecutive threads
  // store consecutive i
  __shared__ float T[kTile][kTile + 1];
  for (int which = 0; which < 2; ++which) {
    float* out = which ? UB : LB;
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int c = 0; c < kMicro; ++c)
        T[ty * kMicro + r][tx * kMicro + c] = which ? ub[r][c] : lb[r][c];
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int jj = idx / kTile;
      const int ii = idx % kTile;
      if (j0 + jj < nx && i0 + ii < nx)
        out[static_cast<long long>(j0 + jj) * nx + i0 + ii] = T[ii][jj];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// ET: (ny, nx) float32, row-major, NaN where absent; LB, UB: (nx, nx).
int annchor_k4_tropical(const float* ET, int ny, int nx, float* LB, float* UB, void* stream) {
  if (nx <= 0) return 0;
  const int tiles = (nx + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  k4_tropical<<<dim3(tiles, tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ET, ny, nx, LB, UB);
  return static_cast<int>(cudaGetLastError());
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
