// K9a: the budgeted band build's linf score, fused with the candidate
// filter and the pass's epilogue.  For a row band b and a block of
// columns c of the anchor-distance matrix D (na anchors):
//
//     score[i][j] = max over k < na of |Db[i][k] - Dc[j][k]|
//
// (the triangle lower bound of d(i, j) from the anchors), and the pair is
// admitted when the points share at least min(eff_i, eff_j) of their
// near anchors, the column is a real point (col < nx) and, in pass 1, not
// the row itself (in pass 2, above it).  Pass 1 ("bins") writes the
// score's int16 bin, (int)(score * inv_bin) clamped to [0, nbins - 1], or
// nbins for a pair not admitted; pass 2 ("keep") writes whether an
// admitted pair's score is at most max(thr_i, thr_j).
//
// Replaces the "linf" branch of the XLA program `_band_score` of
// annchor_tpu/ops/locality.py inside `_band_bins_sym` and
// `_band_keep2_dense` (a (B, C, na) broadcast that XLA fuses into its max
// reduction), not a Pallas kernel.  Its plain PyTorch versions are
// `_band_bins_sym_plain` and `_band_keep2_plain` in
// annchor_tpu_torch/ops/locality.py; the wrapper is ops/band_linf_cuda.py.
//
// Bit for bit the plain version's: the score is a max of float32
// differences (order-free; k past na is staged as NaN, which fmaxf
// skips), the shared-anchor count is exact in both (the plain version's
// float32 product of 0/1 matrices, here a popcount of the near-anchor
// bits, ceil(na / 32) words a point), the bin is one rounded float32
// product truncated toward zero, and the compares are the same float32
// compares.
//
// What bounds it on the H100: for each (i, j, k) a pass needs, one FADD
// and one FMNMX, the FMNMX at 64 lanes a clock per SM, 132 x 64 x 1.98e9
// = 1.67e13 a second.  Pass 1 needs every pair with j < nx, j != row
// (0.048 ms for a (4096, 2048, 96) chunk); pass 2 only those above the
// diagonal, j > row, so over a build it needs half of pass 1's steps.
// Its bytes (the operands once, 2 B of bins a pair) take 6 us a chunk.
// The epilogue, a popcount of 3 words, two compares and one store a pair,
// is small beside 96 steps.  The design: the minmax_tile.cuh tile (64 x
// 64 pairs a block, 16 a thread, 32-row slabs of k in shared memory); a
// tile that holds no pair the pass can admit (padding columns, and in
// pass 2 a tile wholly on or below the diagonal) skips the score and only
// stores; the epilogue from registers, its popcount only for pairs the
// masks leave; and 4 adjacent outputs of a thread stored as one 8-byte
// (bins) or 4-byte (keep) word where the row allows.

#include <cstdint>
#include <cuda_runtime.h>

#include "minmax_tile.cuh"

namespace {

using namespace annchor_tile;

constexpr int kSlab = 32;

struct Args {
  const float* DbT;  // (na, ldb): the rows' anchor distances, transposed
  const float* DcT;  // (na, ldc): the columns'
  const uint32_t* Pb;  // (B, W) near-anchor bits of the rows
  const uint32_t* Pc;  // (C, W) of the columns
  const float* eb;  // (B,) effective thresholds of the rows
  const float* ec;  // (C,)
  const float* tb;  // (B,) keep: score thresholds of the rows
  const float* tc;  // (C,)
  const float* inv_bin;  // bins: 0-d, on the card
  void* out;  // (B, C) int16 bins or bool keep
  long long ldb, ldc;
  int na, W, B, C, row_off, nx, nbins;
};

template <bool BINS>
__global__ void __launch_bounds__(kThreads) k9a_band(const Args a) {
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  __shared__ __align__(16) float As[kSlab][kTile];
  __shared__ __align__(16) float Bs[kSlab][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.0f;

  // A tile with no pair the pass can admit skips the score: every
  // column a padding point (j >= nx), or in keep mode every column at or
  // left of the diagonal (its last column <= its first row).  Its
  // accumulators stay 0 and the epilogue writes nbins or false.
  const bool skip = j0 >= a.nx || (!BINS && j0 + kTile - 1 <= a.row_off + i0);
  for (int k0 = 0; !skip && k0 < a.na; k0 += kSlab) {
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

  // the columns' side of the epilogue, shared by the thread's 4 rows
  const int jb = j0 + tx * kMicro;
  float ecol[kMicro], tcol[kMicro];
#pragma unroll
  for (int c = 0; c < kMicro; ++c) {
    const bool in = jb + c < a.C;
    ecol[c] = in ? __ldg(a.ec + jb + c) : 0.0f;
    tcol[c] = (!BINS && in) ? __ldg(a.tc + jb + c) : 0.0f;
  }
  const float inv = BINS ? __ldg(a.inv_bin) : 0.0f;
  const bool packed = (a.C % kMicro) == 0 && jb + kMicro <= a.C;

#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = i0 + ty * kMicro + r;
    if (i >= a.B) continue;
    const int row = a.row_off + i;
    const float erow = __ldg(a.eb + i);
    const float trow = BINS ? 0.0f : __ldg(a.tb + i);
    const uint32_t* pb = a.Pb + static_cast<long long>(i) * a.W;
    int v[kMicro];
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = jb + c;
      v[c] = 0;
      if (j >= a.C) continue;
      bool adm = !skip && (BINS ? j != row : j > row) && j < a.nx;
      if (adm) {
        const uint32_t* pc = a.Pc + static_cast<long long>(j) * a.W;
        int shared = 0;
        for (int w = 0; w < a.W; ++w) shared += __popc(__ldg(pb + w) & __ldg(pc + w));
        adm = static_cast<float>(shared) >= fminf(erow, ecol[c]);
      }
      if (BINS) {
        int b = __float2int_rz(__fmul_rn(acc[r][c], inv));
        b = min(max(b, 0), a.nbins - 1);
        v[c] = adm ? b : a.nbins;
      } else {
        v[c] = adm && acc[r][c] <= fmaxf(trow, tcol[c]);
      }
    }
    const long long at = static_cast<long long>(i) * a.C + jb;
    if (BINS) {
      int16_t* out = static_cast<int16_t*>(a.out) + at;
      if (packed) {
        *reinterpret_cast<short4*>(out) =
            make_short4(static_cast<short>(v[0]), static_cast<short>(v[1]),
                        static_cast<short>(v[2]), static_cast<short>(v[3]));
      } else {
        for (int c = 0; c < kMicro && jb + c < a.C; ++c) out[c] = static_cast<int16_t>(v[c]);
      }
    } else {
      uint8_t* out = static_cast<uint8_t*>(a.out) + at;
      if (packed) {
        *reinterpret_cast<uchar4*>(out) =
            make_uchar4(static_cast<uint8_t>(v[0]), static_cast<uint8_t>(v[1]),
                        static_cast<uint8_t>(v[2]), static_cast<uint8_t>(v[3]));
      } else {
        for (int c = 0; c < kMicro && jb + c < a.C; ++c) out[c] = static_cast<uint8_t>(v[c]);
      }
    }
  }
}

int launch(bool bins, const Args& a, void* stream) {
  if (a.B <= 0 || a.C <= 0) return 0;
  const long long by = (a.B + kTile - 1) / kTile;
  const long long bx = (static_cast<long long>(a.C) + kTile - 1) / kTile;
  if (by > 65535 || bx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bins)
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

int annchor_k9a_bins(ANNCHOR_K9A_ARGS, const float* inv_bin, int nbins, int16_t* out,
                     void* stream) {
  const Args a{DbT, DcT, Pb, Pc, eb, ec, nullptr, nullptr, inv_bin, out,
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
