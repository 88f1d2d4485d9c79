// K9a: the budgeted band build's linf score, fused with the candidate
// filter and the pass's epilogue.  For a row band b and a block of
// columns c of the anchor-distance matrix D (na anchors):
//
//     score[i][j] = max over k < na of |Db[i][k] - Dc[j][k]|
//
// (the triangle lower bound of d(i, j) from the anchors), and the pair is
// admitted when the points share at least min(eff_i, eff_j) of their
// near anchors, the column is a real point (col < nx) and, in pass 1, not
// the row itself (in pass 2, above it).  Pass 1 ("hist") counts each
// admitted pair's int bin, (int)(score * inv_bin) clamped to
// [0, nbins - 1], into its row's histogram, (B, nbins) int32, from which
// `_band_thr_from_hist` takes each row's threshold in one pass; pass 2
// ("keep") writes whether an admitted pair's score is at most
// max(thr_i, thr_j).
//
// Replaces the "linf" branch of the XLA program `_band_score` of
// annchor_tpu/ops/locality.py inside `_band_bins_sym` (whose bins the JAX
// package then bisects in `_band_thr_from_bins`) and `_band_keep2_dense`
// (a (B, C, na) broadcast that XLA fuses into its max reduction), not a
// Pallas kernel.  Its plain PyTorch versions are `_band_hist_sym_plain`
// (the plain bins, counted per row) and `_band_keep2_plain` in
// annchor_tpu_torch/ops/locality.py; the wrapper is ops/band_linf_cuda.py.
//
// Bit for bit the plain version's: the score is a max of float32
// differences (order-free; k past na is staged as NaN, which fmaxf
// skips), the shared-anchor count is exact in both (the plain version's
// float32 product of 0/1 matrices, here a popcount of the near-anchor
// bits, ceil(na / 32) words a point), the bin is one rounded float32
// product truncated toward zero, the histogram's integer adds do not
// depend on their order, and the compares are the same float32 compares.
//
// What bounds it on the H100: for each (i, j, k) of an admitted pair, one
// FADD and one FMNMX, the FMNMX at 64 lanes a clock per SM, 132 x 64 x
// 1.98e9 = 1.67e13 a second; the bytes are the operands once and the
// output once (1 KB a row of histogram, 1 B a pair of keep mask).  Only
// 1-4 % of the 100k build's pairs are admitted, and they cluster: the
// design is the minmax_tile.cuh tile (64 x 64 pairs a block, 16 a thread,
// 32-row slabs of k in shared memory) behind an admit test.  Each thread
// first evaluates the admission of its 16 pairs (the masks, then a
// popcount of W words a pair), and a block none of whose pairs is
// admitted (__syncthreads_or) skips the 96-step score: pass 1 then writes
// nothing, pass 2 its zeros.  Pass 1's epilogue adds one to H[i][bin]
// with a global atomic for each admitted pair; pass 2 stores 4 adjacent
// outputs of a thread as one 4-byte word where the row allows.

#include <cstdint>
#include <cuda_runtime.h>

#include "minmax_tile.cuh"

namespace {

using namespace annchor_tile;

constexpr int kSlab = 32;
constexpr int kWords = 4;  // near-anchor words a point held in registers

struct Args {
  const float* DbT;  // (na, ldb): the rows' anchor distances, transposed
  const float* DcT;  // (na, ldc): the columns'
  const uint32_t* Pb;  // (B, W) near-anchor bits of the rows
  const uint32_t* Pc;  // (C, W) of the columns
  const float* eb;  // (B,) effective thresholds of the rows
  const float* ec;  // (C,)
  const float* tb;  // (B,) keep: score thresholds of the rows
  const float* tc;  // (C,)
  const float* inv_bin;  // hist: 0-d, on the card
  void* out;  // (B, nbins) int32 histogram (zeroed by the caller) or (B, C) bool keep
  long long ldb, ldc;
  int na, W, B, C, row_off, nx, nbins;
};

// Three blocks an SM: 80 registers, no spills, and the many tiles that
// admit nothing pass through faster than at two (at four it spills;
// PERF.md, PR 13).
constexpr int kMinBlocks = 3;

template <bool HIST>
__global__ void __launch_bounds__(kThreads, kMinBlocks) k9a_band(const Args a) {
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  __shared__ __align__(16) float As[kSlab][kTile];
  __shared__ __align__(16) float Bs[kSlab][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int jb = j0 + tx * kMicro;

  // The admission of the thread's 16 pairs, bit kMicro r + c, before any
  // score: a real column, off the diagonal (pass 2: above it), and
  // enough shared near anchors.  Up to kWords words a point (128
  // anchors) the 4 rows' and 4 columns' bits are read once into
  // registers; above, each pair reads its words.
  float ecol[kMicro];
#pragma unroll
  for (int c = 0; c < kMicro; ++c) ecol[c] = jb + c < a.C ? __ldg(a.ec + jb + c) : 0.0f;
  const bool fast = a.W <= kWords;
  uint32_t rbits[kMicro][kWords], cbits[kMicro][kWords];
#pragma unroll
  for (int q = 0; q < kMicro; ++q) {
    const int i = i0 + ty * kMicro + q;
    const int j = jb + q;
    const uint32_t* pb = a.Pb + static_cast<long long>(i) * a.W;
    const uint32_t* pc = a.Pc + static_cast<long long>(j) * a.W;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      rbits[q][w] = fast && w < a.W && i < a.B ? __ldg(pb + w) : 0u;
      cbits[q][w] = fast && w < a.W && j < a.C ? __ldg(pc + w) : 0u;
    }
  }
  unsigned adm = 0;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = i0 + ty * kMicro + r;
    if (i >= a.B) continue;
    const int row = a.row_off + i;
    const float erow = __ldg(a.eb + i);
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = jb + c;
      if (j >= a.C || j >= a.nx || (HIST ? j == row : j <= row)) continue;
      int shared = 0;
      if (fast) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) shared += __popc(rbits[r][w] & cbits[c][w]);
      } else {
        const uint32_t* pb = a.Pb + static_cast<long long>(i) * a.W;
        const uint32_t* pc = a.Pc + static_cast<long long>(j) * a.W;
        for (int w = 0; w < a.W; ++w) shared += __popc(__ldg(pb + w) & __ldg(pc + w));
      }
      if (static_cast<float>(shared) >= fminf(erow, ecol[c])) adm |= 1u << (kMicro * r + c);
    }
  }
  // a tile none of whose pairs is admitted skips the score
  const bool any = __syncthreads_or(adm != 0);

  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.0f;
  for (int k0 = 0; any && k0 < a.na; k0 += kSlab) {
    load_slab<kSlab>(As, a.DbT, a.ldb, k0, a.na, i0, a.B);
    load_slab<kSlab>(Bs, a.DcT, a.ldc, k0, a.na, j0, a.C);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlab; ++k) {
      const float4 x = quad(As, k, ty);
      const float4 y = quad(Bs, k, tx);
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c)
          acc[r][c] = fmaxf(acc[r][c], fabsf(lane(x, r) - lane(y, c)));
    }
    __syncthreads();
  }

  if constexpr (HIST) {
    // one count for each admitted pair in its row's histogram
    if (adm == 0) return;
    const float inv = __ldg(a.inv_bin);
    int* H = static_cast<int*>(a.out);
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        if (!(adm >> (kMicro * r + c) & 1u)) continue;
        int b = __float2int_rz(__fmul_rn(acc[r][c], inv));
        b = min(max(b, 0), a.nbins - 1);
        atomicAdd(H + static_cast<long long>(i0 + ty * kMicro + r) * a.nbins + b, 1);
      }
  } else {
    float tcol[kMicro];
#pragma unroll
    for (int c = 0; c < kMicro; ++c) tcol[c] = jb + c < a.C ? __ldg(a.tc + jb + c) : 0.0f;
    const bool packed = (a.C % kMicro) == 0 && jb + kMicro <= a.C;
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      const int i = i0 + ty * kMicro + r;
      if (i >= a.B) continue;
      const float trow = __ldg(a.tb + i);
      uint8_t v[kMicro];
#pragma unroll
      for (int c = 0; c < kMicro; ++c)
        v[c] = (adm >> (kMicro * r + c) & 1u) && acc[r][c] <= fmaxf(trow, tcol[c]);
      uint8_t* out = static_cast<uint8_t*>(a.out) + static_cast<long long>(i) * a.C + jb;
      if (packed) {
        *reinterpret_cast<uchar4*>(out) = make_uchar4(v[0], v[1], v[2], v[3]);
      } else {
        for (int c = 0; c < kMicro && jb + c < a.C; ++c) out[c] = v[c];
      }
    }
  }
}

int launch(bool hist, const Args& a, void* stream) {
  if (a.B <= 0 || a.C <= 0) return 0;
  const long long by = (a.B + kTile - 1) / kTile;
  const long long bx = (static_cast<long long>(a.C) + kTile - 1) / kTile;
  if (by > 65535 || bx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hist)
    k9a_band<true><<<grid, kThreads, 0, s>>>(a);
  else
    k9a_band<false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The shared arguments: the rows' and columns' transposed distances and
// their leading dimensions, na, the bits and their words a point W, the
// effective thresholds, B, C, the first row's point id (column j is point
// j), nx.
#define ANNCHOR_K9A_ARGS                                                              \
  const float *DbT, long long ldb, const float *DcT, long long ldc, int na,           \
      const uint32_t *Pb, const uint32_t *Pc, int W, const float *eb, const float *ec, \
      int B, int C, int row_off, int nx

// H: (B, nbins) int32, zero on entry
int annchor_k9a_hist(ANNCHOR_K9A_ARGS, const float* inv_bin, int nbins, int* H,
                     void* stream) {
  const Args a{DbT, DcT, Pb, Pc, eb, ec, nullptr, nullptr, inv_bin, H,
               ldb, ldc, na, W, B, C, row_off, nx, nbins};
  return launch(true, a, stream);
}

int annchor_k9a_keep(ANNCHOR_K9A_ARGS, const float* tb, const float* tc, uint8_t* out,
                     void* stream) {
  const Args a{DbT, DcT, Pb, Pc, eb, ec, tb, tc, nullptr, out,
               ldb, ldc, na, W, B, C, row_off, nx, 0};
  return launch(false, a, stream);
}

#undef ANNCHOR_K9A_ARGS

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
