// K10: edit distance by the row dynamic programme, for alphabets of more
// than 192 symbols, where the bit-parallel kernel (K1) would need a Peq
// table per string too large to keep.
//
// Replaces the XLA program `_lev_batch` of annchor_tpu/ops/levenshtein.py
// (reached from `levenshtein_pairs` whenever `MyersEncoding.from_codes`
// finds too many symbols), not a Pallas kernel.  Its plain PyTorch version
// is `lev_pairs_plain` in annchor_tpu_torch/ops/levenshtein.py, the same
// recurrence with `torch.cummin` over a whole row.
//
// What it computes.  For pair k = (I[k], J[k]) of codepoint strings (ids,
// -1 past each string's end) let r be the shorter string (nr characters)
// and c the longer one (nc); then out[k] = D(nr, nc) of
//
//     D(i, 0) = i,  D(0, j) = j,
//     D(i, j) = min(D(i-1, j) + 1, D(i, j-1) + 1, D(i-1, j-1) + [r_i != c_j]).
//
// One thread owns one pair (grid-stride over the batch).  It walks the
// longer string in strips of S = 16 columns: the strip's 16 characters of
// c and the 16 values of the row above sit in registers, and the rows of
// r run down the strip, each row computing its 16 cells from the cell on
// its left, the cell above and the diagonal.  Between two strips only the
// column at the strip's right edge is kept, D(i, j0 + S) for every row i,
// in the thread's own slice of `col` (nr + 1 ints, interleaved across the
// threads so that a warp's loads and stores of row i are coalesced).  So
// per 16 cells a thread moves one character of r (from L1/L2) and one
// load and one store of `col`: about half a byte a cell.
//
// What bounds it on the H100.  A cell is about five INT32 operations:
// up + 1, the compare of the two characters folded into diagonal + cost,
// their min, left + 1 and the last min (the dependency chain along a row
// is only left + 1 and the min).  The card issues 132 SMs x 64 INT32
// lanes x 1.98 GHz = 1.67e13 of them a second, so the bound is
// cells * 5 / 1.67e13 s, cells = nr * nc summed over the pairs.  At half
// a byte a cell the bytes are far below that.  What holds the kernel
// under its bound: a warp runs as long as its longest pair (its 32 pairs
// are not sorted by length), and the strip tail past nc is computed and
// thrown away.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStrip = 16;

__device__ __forceinline__ long long load_index(const void* ix, long long k,
                                                int stride, int idx64) {
  const long long at = k * stride;
  return idx64 ? static_cast<const int64_t*>(ix)[at]
               : static_cast<long long>(static_cast<const int*>(ix)[at]);
}

__global__ void __launch_bounds__(kThreads)
    k10_rowdp(const int* __restrict__ ids, const int* __restrict__ lengths,
              const void* __restrict__ I, const void* __restrict__ J,
              int* __restrict__ out, int* __restrict__ col, int count, int L,
              int si, int sj, int idx64) {
  const long long T = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int* mine = col + tid;  // element i of this thread's column: mine[i * T]
  for (long long k = tid; k < count; k += T) {
    const long long p = load_index(I, k, si, idx64);
    const long long q = load_index(J, k, sj, idx64);
    const int lp = lengths[p];
    const int lq = lengths[q];
    if (p == q) {
      out[k] = 0;
      continue;
    }
    const bool swap = lp > lq;
    const int* r = ids + (swap ? q : p) * static_cast<long long>(L);
    const int* c = ids + (swap ? p : q) * static_cast<long long>(L);
    const int nr = swap ? lq : lp;
    const int nc = swap ? lp : lq;
    if (nr == 0) {
      out[k] = nc;
      continue;
    }
    for (int i = 0; i <= nr; ++i) mine[i * T] = i;  // D(i, 0)
    int result = 0;
    for (int j0 = 0; j0 < nc; j0 += kStrip) {
      int ch[kStrip];
      int up[kStrip];
#pragma unroll
      for (int s = 0; s < kStrip; ++s) {
        ch[s] = j0 + s < nc ? c[j0 + s] : -2;  // -2 matches no character
        up[s] = j0 + s + 1;                    // D(0, j0 + s + 1)
      }
      const bool last = j0 + kStrip >= nc;
      int diag_edge = j0;  // D(i - 1, j0)
      for (int i = 1; i <= nr; ++i) {
        const int ri = r[i - 1];
        const int edge = mine[i * T];  // D(i, j0), left of the strip
        int left = edge;
        int diag = diag_edge;
#pragma unroll
        for (int s = 0; s < kStrip; ++s) {
          const int above = up[s];
          const int t = min(above + 1, diag + (ch[s] != ri ? 1 : 0));
          const int v = min(t, left + 1);
          diag = above;
          up[s] = v;
          left = v;
        }
        if (!last) mine[i * T] = up[kStrip - 1];  // D(i, j0 + S)
        diag_edge = edge;
      }
      if (last) {
        const int at = nc - 1 - j0;
#pragma unroll
        for (int s = 0; s < kStrip; ++s)
          if (s == at) result = up[s];
      }
    }
    out[k] = result;
  }
}

}  // namespace

extern "C" {

// Edit distances of `count` pairs: ids int32 (n, L) codepoints with -1
// past each string's end, lengths int32 (n,), pair ids int32 or int64 (by
// idx64) read at I[k * si], J[k * sj], out int32 (count,).  `col` holds
// blocks * 128 * (the longest string + 1) ints.  Returns the launch's
// cudaError_t.
int annchor_k10_rowdp(const int* ids, const int* lengths, const void* I,
                      const void* J, int* out, int* col, int count, int L,
                      int si, int sj, int idx64, int blocks, void* stream) {
  if (blocks <= 0 || count <= 0) return 0;
  k10_rowdp<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, lengths, I, J, out, col, count, L, si, sj, idx64);
  return static_cast<int>(cudaGetLastError());
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
