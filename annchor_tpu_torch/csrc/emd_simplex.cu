// K12: exact 1-Wasserstein (EMD) of a batch of histogram pairs on the card,
// one warp a pair, by the host solver's own transportation network simplex
// (csrc/emd_native.cpp, NetSimplex::solve), step for step in its node
// numbering and order of operations, so each distance is the host's float64
// bit for bit.
//
// It replaces no kernel of the JAX package: there, as in the port's
// native.py, exact EMD is host C++ striped over the host's cores.  It was
// added because the hybrid's certify and query solve 10^4-10^5 independent
// pairs a call, and pivoting is sequential within a pair but not across
// pairs.  Its plain version is `emd_simplex_plain` in
// annchor_tpu_torch/ops/emd_cuda.py, the wrapper `emd_simplex_cuda` there.
//
// A pair, in the host's order:
//   * x and y are normalised by their serial sums (x / sx, IEEE division),
//     and their zero bins dropped, keeping bin order (a ballot a 32 bins);
//     a zero total mass gives 0, one bin on a side the one-node sum;
//   * the least-cost initial basis on perturbed supplies: the block's
//     shared cell order (the full cost matrix's cells stable by distinct-
//     cost rank, then (i, j), built once by the wrapper) is scanned 32
//     cells at a time; a ballot marks the cells on the pair's support whose
//     row and column are both live, lane 0 allocates the lowest, and the
//     warp ballots again past it, which is the host's sequential scan;
//   * Dantzig pricing: lane l prices source rows l and l + 32, each row's
//     first minimal column of C[i][j] - v[j] (strict <), then rmin - u[i];
//     a butterfly argmin over (value, row) gives the host's first strict
//     minimum of both loops;
//   * the pivot, the kid-list surgery, the subtree update and the flows
//     re-derived in reverse BFS order with the unperturbed supplies run in
//     lane 0 on the warp's state in shared memory.
//
// Floating point: nvcc contracts a * b + c into an FMA wherever it can, and
// the host's g++ -O3 -march=native does at some sites only.  So every
// product here is an explicit fma() where the host's object code has one
// (sb[m-1] += n * eps, the tolerance, the flow peel, the one-node sum's
// last term when its count is odd) and __dmul_rn / __dadd_rn elsewhere; the
// sums and differences are single IEEE operations either way.  Each fma()
// is marked "FMA site: <name>", as in the host solver and the plain
// version: ops/emd_cuda.py FMA_SITES is their one list, and
// tests/test_torch_emd_simplex.py holds the three files to it, so an edit
// of one site changes all three.
//
// What bounds it on the H100: the serial tree work, not the arithmetic.  A
// digits pair (about 33 x 33 support) takes about 26 pivots of a pricing
// pass (about 1,070 FP64 subtractions and compares, 33 a lane) and about
// 50 dependent shared-memory steps in lane 0.  The FP64 pricing over a
// 121 k-pair batch is about 10 G operations, 0.6 ms at 64 FP64 lanes x 132
// SMs x 1.98 GHz; the serial chain is latency, hidden only by the warps
// resident: a block is 16 warps with the cost matrix (float64, rows of
// stride nbins + 1 so the lanes' rows fall in different banks) and the
// cell order once, and each warp's tree in its own 9,856 bytes (199 KB a
// block at 64 bins, one block an SM).  The warps stride over the batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 64;
constexpr int kMaxN = 2 * kMaxBins;  // nodes: sources, then sinks
constexpr unsigned kFull = 0xffffffffu;
constexpr double kInf = 1e300;  // the host's kInf and row-minimum start
constexpr size_t kSmemMax = 232448;

// One warp's solver state, in shared memory; sized for kMaxBins bins
// (ops/emd_cuda.py WARP_BYTES).  arcf first holds the pair's raw x and y.
struct __align__(16) WarpState {
  double u[kMaxN], flow[kMaxN], sa[kMaxN], arcf[kMaxN];
  double sb[kMaxBins], a[kMaxBins], b[kMaxBins];
  short parent[kMaxN], depth[kMaxN], khead[kMaxN], knext[kMaxN], kprev[kMaxN];
  short order[kMaxN], stack[kMaxN], adjh[kMaxN];
  short adjn[2 * kMaxN], adjv[2 * kMaxN];
  short arca[kMaxN], arcb[kMaxN];
  short ia[kMaxBins], ib[kMaxBins], rmap[kMaxBins], cmap[kMaxBins];
  unsigned char seen[kMaxN];
};
static_assert(sizeof(WarpState) == 9856, "ops/emd_cuda.py WARP_BYTES");

__host__ __device__ constexpr size_t fixed_bytes(int nb) {
  return (8 * static_cast<size_t>(nb) * (nb + 1) + 2 * static_cast<size_t>(nb) * nb + 15) /
         16 * 16;
}

// The host's tree routines, run by lane 0 on one warp's state.
struct Tree {
  WarpState& s;
  const double* C;  // the block's cost matrix, rows of stride cs
  int cs, n, m, N;

  __device__ __forceinline__ double cost(int src, int snk) const {
    return C[s.ia[src] * cs + s.ib[snk]];
  }
  // the cost of the arc between node v and its parent p
  __device__ __forceinline__ double arc_cost(int v, int p) const {
    return v < n ? cost(v, p - n) : cost(p, v - n);
  }

  __device__ __forceinline__ void attach(int c, int p) {
    const int h = s.khead[p];
    s.knext[c] = h;
    s.kprev[c] = -1;
    if (h >= 0) s.kprev[h] = c;
    s.khead[p] = c;
  }

  __device__ __forceinline__ void detach(int c) {
    const int p = s.parent[c];
    const int prv = s.kprev[c], nxt = s.knext[c];
    if (prv >= 0) s.knext[prv] = nxt; else s.khead[p] = nxt;
    if (nxt >= 0) s.kprev[nxt] = prv;
  }

  // parent/depth/flow rooted at node 0 from the basis's narc arcs
  __device__ void build_tree(int narc) {
    int fill = 0;
    for (int v = 0; v < N; ++v) s.adjh[v] = -1;
    for (int k = 0; k < narc; ++k) {
      const int x = s.arca[k], y = n + s.arcb[k];
      s.adjv[fill] = y; s.adjn[fill] = s.adjh[x]; s.adjh[x] = fill++;
      s.adjv[fill] = x; s.adjn[fill] = s.adjh[y]; s.adjh[y] = fill++;
    }
    for (int v = 0; v < N; ++v) s.seen[v] = 0;
    int top = 0;
    s.stack[top++] = 0;
    s.seen[0] = 1;
    s.parent[0] = -1;
    s.depth[0] = 0;
    while (top > 0) {
      const int v = s.stack[--top];
      for (int e = s.adjh[v]; e >= 0; e = s.adjn[e]) {
        const int w = s.adjv[e];
        if (s.seen[w]) continue;
        s.seen[w] = 1;
        s.parent[w] = v;
        s.depth[w] = s.depth[v] + 1;
        s.stack[top++] = w;
      }
    }
    for (int v = 0; v < N; ++v) s.flow[v] = 0.0;
    for (int k = 0; k < narc; ++k) {
      const int x = s.arca[k], y = n + s.arcb[k];
      s.flow[s.parent[x] == y ? x : y] = s.arcf[k];
    }
  }

  // BFS order from the kid lists; false if it does not reach every node
  __device__ bool rebuild_order() {
    s.order[0] = 0;
    int tail = 1;
    for (int h = 0; h < tail; ++h)
      for (int c = s.khead[s.order[h]]; c >= 0; c = s.knext[c]) {
        if (tail >= N) return false;
        s.order[tail++] = c;
      }
    return tail == N;
  }

  // kid lists, BFS order, depths and potentials from the parent pointers
  __device__ bool refresh() {
    for (int v = 0; v < N; ++v) s.khead[v] = -1;
    for (int v = 0; v < N; ++v)
      if (s.parent[v] >= 0) attach(v, s.parent[v]);
    if (!rebuild_order()) return false;
    s.depth[0] = 0;
    s.u[0] = 0.0;
    for (int h = 1; h < N; ++h) {
      const int c = s.order[h];
      const int v = s.parent[c];
      s.depth[c] = s.depth[v] + 1;
      s.u[c] = __dsub_rn(arc_cost(c, v), s.u[v]);
    }
    return true;
  }

  // depths and potentials below root (its parent's are valid)
  __device__ bool update_subtree(int root) {
    int top = 0;
    s.stack[top++] = root;
    while (top > 0) {
      const int v = s.stack[--top];
      const int p = s.parent[v];
      s.depth[v] = s.depth[p] + 1;
      s.u[v] = __dsub_rn(arc_cost(v, p), s.u[p]);
      for (int c = s.khead[v]; c >= 0; c = s.knext[c]) {
        if (top >= N) return false;
        s.stack[top++] = c;
      }
    }
    return true;
  }

  // entering arc i (source) -- jn (sink node); returns the root of the
  // re-hung subtree, or -1 if the walk leaves the tree
  __device__ int pivot(int i, int jn) {
    double delta = kInf;
    int leave = -1;
    int lx = i, ly = jn;
    for (int guard = 2 * N; lx != ly; --guard) {
      if (guard <= 0 || lx < 0 || ly < 0) return -1;
      if (s.depth[lx] >= s.depth[ly]) {
        if (lx < n && s.flow[lx] <= delta) { delta = s.flow[lx]; leave = lx; }
        lx = s.parent[lx];
      } else {
        if (ly >= n && s.flow[ly] <= delta) { delta = s.flow[ly]; leave = ly; }
        ly = s.parent[ly];
      }
    }
    for (int v = i; v != lx; v = s.parent[v])
      s.flow[v] = __dadd_rn(s.flow[v], v < n ? -delta : delta);
    for (int v = jn; v != lx; v = s.parent[v])
      s.flow[v] = __dadd_rn(s.flow[v], v >= n ? -delta : delta);
    bool on_path = false;
    for (int v = i; v >= 0; v = s.parent[v])
      if (v == leave) { on_path = true; break; }
    const int end = on_path ? i : jn;
    int prev = on_path ? jn : i;
    double carry = delta;
    int cur = end;
    while (prev != -1 && cur != -1) {
      const int nxt = s.parent[cur];
      const double nxtflow = s.flow[cur];
      detach(cur);
      s.parent[cur] = prev;
      attach(cur, prev);
      s.flow[cur] = carry;
      if (cur == leave) break;
      prev = cur;
      cur = nxt;
      carry = nxtflow;
    }
    return end;
  }

  // the exact flows of the final tree with the unperturbed supplies,
  // leaves first; each arc's cost counted once
  __device__ double peel() {
    double* bal = s.sa;
    for (int i = 0; i < n; ++i) bal[i] = s.a[i];
    for (int j = 0; j < m; ++j) bal[n + j] = -s.b[j];
    double total = 0.0;
    for (int k = N - 1; k > 0; --k) {
      const int v = s.order[k];
      const int p = s.parent[v];
      // FMA site: peel
      total = fma(fabs(bal[v]), arc_cost(v, p), total);
      bal[p] = __dadd_rn(bal[p], bal[v]);
    }
    return total;
  }
};

// The exact EMD of one pair, by the whole warp; lane 0's value is the
// result.  Every branch below is uniform across the warp.
__device__ double solve_pair(WarpState& s, const double* C, int cs, const short* order,
                             int nb, const double* x, const double* y, int lane) {
  double* xs = s.arcf;
  double* ys = s.arcf + kMaxBins;
  for (int k = lane; k < nb; k += 32) {
    xs[k] = x[k];
    ys[k] = y[k];
  }
  __syncwarp();
  double sx = 0.0, sy = 0.0;
  if (lane == 0)
    for (int k = 0; k < nb; ++k) {
      sx = __dadd_rn(sx, xs[k]);
      sy = __dadd_rn(sy, ys[k]);
    }
  sx = __shfl_sync(kFull, sx, 0);
  sy = __shfl_sync(kFull, sy, 0);
  if (sx <= 0.0 || sy <= 0.0) return 0.0;

  // the supports, in bin order
  int n = 0, m = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int k0 = 0; k0 < nb; k0 += 32) {
    const int k = k0 + lane;
    const bool px = k < nb && xs[k] > 0.0;
    const bool py = k < nb && ys[k] > 0.0;
    const unsigned bx = __ballot_sync(kFull, px), by = __ballot_sync(kFull, py);
    if (k < nb) {
      const int i = n + __popc(bx & below), j = m + __popc(by & below);
      s.rmap[k] = px ? i : -1;
      s.cmap[k] = py ? j : -1;
      if (px) { s.ia[i] = k; s.a[i] = __ddiv_rn(xs[k], sx); }
      if (py) { s.ib[j] = k; s.b[j] = __ddiv_rn(ys[k], sy); }
    }
    n += __popc(bx);
    m += __popc(by);
  }
  __syncwarp();
  Tree t{s, C, cs, n, m, n + m};
  const int N = n + m;

  if (n == 1 || m == 1) {  // all mass through the one node
    double total = 0.0;
    if (lane == 0) {
      const int cnt = n == 1 ? m : n;
      const double* w = n == 1 ? s.b : s.a;
      for (int k = 0; k < cnt; ++k) {
        const double c = n == 1 ? t.cost(0, k) : t.cost(k, 0);
        // FMA site: one-node
        total = (k == cnt - 1 && (cnt & 1)) ? fma(w[k], c, total)
                                            : __dadd_rn(total, __dmul_rn(w[k], c));
      }
    }
    return total;
  }

  // perturbed supplies
  double eps = 0.0;
  if (lane == 0) {
    double total = 0.0;
    for (int i = 0; i < n; ++i) total = __dadd_rn(total, s.a[i]);
    eps = __dmul_rn(total, 1e-11);
  }
  eps = __shfl_sync(kFull, eps, 0);
  for (int i = lane; i < n; i += 32) s.sa[i] = __dadd_rn(s.a[i], eps);
  for (int j = lane; j < m; j += 32) s.sb[j] = s.b[j];
  for (int v = lane; v < N; v += 32) {
    s.seen[v] = 0;
    s.parent[v] = -1;
    s.depth[v] = 0;
    s.u[v] = 0.0;
    s.order[v] = 0;
    s.knext[v] = -1;
    s.kprev[v] = -1;
  }
  __syncwarp();
  // FMA site: supply
  if (lane == 0) s.sb[m - 1] = fma(static_cast<double>(n), eps, s.sb[m - 1]);
  __syncwarp();

  // least-cost initial basis from the shared cell order
  int live = N, narc = 0;
  const int ncell = nb * nb;
  for (int k0 = 0; k0 < ncell && live > 1; k0 += 32) {
    const int k = k0 + lane;
    int ci = -1, cj = -1;
    if (k < ncell) {
      const int cell = order[k];
      ci = s.rmap[cell >> 8];
      cj = s.cmap[cell & 0xff];
    }
    const bool on = ci >= 0 && cj >= 0;
    int last = -1;
    while (live > 1) {
      const bool pred = on && lane > last && !s.seen[ci] && !s.seen[n + cj];
      const unsigned mask = __ballot_sync(kFull, pred);
      if (mask == 0u) break;
      last = __ffs(mask) - 1;
      const int i = __shfl_sync(kFull, ci, last);
      const int j = __shfl_sync(kFull, cj, last);
      if (lane == 0) {
        const double f = s.sb[j] < s.sa[i] ? s.sb[j] : s.sa[i];
        s.arca[narc] = i;
        s.arcb[narc] = j;
        s.arcf[narc] = f;
        ++narc;
        s.sa[i] = __dsub_rn(s.sa[i], f);
        s.sb[j] = __dsub_rn(s.sb[j], f);
        if (live > 2) {
          if (s.sa[i] <= 0.0) s.seen[i] = 1; else s.seen[n + j] = 1;
          --live;
        } else {
          live = 1;  // the last cell closes both sides
        }
      }
      live = __shfl_sync(kFull, live, 0);
      __syncwarp();
    }
  }

  int ok = 1;
  if (lane == 0) {
    t.build_tree(narc);
    ok = t.refresh();
  }
  // the tolerance: the largest cost on the support (the host's max from 0)
  double mx = 0.0;
  for (int r = lane; r < n; r += 32) {
    const double* Cr = C + s.ia[r] * cs;
    for (int j = 0; j < m; ++j) {
      const double c = Cr[s.ib[j]];
      mx = mx < c ? c : mx;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(kFull, mx, off);
    mx = mx < o ? o : mx;
  }
  // FMA site: tol
  const double tol = fma(mx, 1e-12, 1e-15);
  ok = __shfl_sync(kFull, ok, 0);
  __syncwarp();

  const int max_pivots = 64 * N + 256;
  for (int it = 0; ok && it < max_pivots; ++it) {
    // Dantzig pricing: each lane's rows, then the warp's argmin
    const double* v = s.u + n;
    double bv = __longlong_as_double(0x7ff0000000000000LL);  // +inf
    int br = kMaxN, bc = -1;
    for (int r = lane; r < n; r += 32) {
      const double* Cr = C + s.ia[r] * cs;
      double rmin = kInf;
      int jm = -1;
      for (int j = 0; j < m; ++j) {
        const double c = __dsub_rn(Cr[s.ib[j]], v[j]);
        if (c < rmin) { rmin = c; jm = j; }
      }
      const double val = __dsub_rn(rmin, s.u[r]);
      if (val < bv) { bv = val; br = r; bc = jm; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_xor_sync(kFull, bv, off);
      const int orow = __shfl_xor_sync(kFull, br, off);
      const int ocol = __shfl_xor_sync(kFull, bc, off);
      if (ov < bv || (ov == bv && orow < br)) { bv = ov; br = orow; bc = ocol; }
    }
    if (!(bv < -tol)) break;  // optimal
    if (lane == 0) {
      const int end = t.pivot(br, n + bc);
      ok = end >= 0 && t.update_subtree(end);
    }
    ok = __shfl_sync(kFull, ok, 0);
    __syncwarp();
  }

  double total = 0.0;
  if (lane == 0) {
    ok = ok && t.rebuild_order();
    // a basis that is not a spanning tree has no host value to match
    total = ok ? t.peel() : __longlong_as_double(0x7ff8000000000000LL);
  }
  return total;
}

__global__ void __launch_bounds__(512, 1)
k12_emd(const double* __restrict__ X, const double* __restrict__ Z,
        const long long* __restrict__ I, const long long* __restrict__ J, int P, int nb,
        const double* __restrict__ Cg, const short* __restrict__ order_g,
        double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = nb + 1;
  double* C = reinterpret_cast<double*>(smem);
  short* order = reinterpret_cast<short*>(smem + 8 * nb * cs);
  for (int k = threadIdx.x; k < nb * nb; k += blockDim.x) {
    C[(k / nb) * cs + k % nb] = Cg[k];
    order[k] = order_g[k];
  }
  __syncthreads();
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  WarpState& s = reinterpret_cast<WarpState*>(smem + fixed_bytes(nb))[warp];
  for (long long p = static_cast<long long>(blockIdx.x) * warps + warp; p < P;
       p += static_cast<long long>(gridDim.x) * warps) {
    const double d = solve_pair(s, C, cs, order, nb, X + I[p] * nb, Z + J[p] * nb, lane);
    if (lane == 0) out[p] = d;
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// K12: out[p] = EMD(X[I[p]], Z[J[p]]) for p < P.  X, Z: float64 rows of nb
// bins; I, J: int64 ids in range; C: (nb, nb) float64 cost; order: the
// nb^2 cells, int16 (i << 8) | j, in the host's basis order; out: float64
// (P,).  blocks x warps warps, smem bytes of dynamic shared memory (at
// least fixed_bytes(nb) + warps x sizeof(WarpState)), from
// ops/emd_cuda.plan.  Returns a cudaError_t.
int annchor_k12_emd(const double* X, const double* Z, const long long* I, const long long* J,
                    int P, int nb, const double* C, const short* order, double* out,
                    int blocks, int warps, int smem, void* stream) {
  if (P <= 0) return 0;
  const size_t need = fixed_bytes(nb) + static_cast<size_t>(warps) * sizeof(WarpState);
  if (nb < 1 || nb > kMaxBins || blocks < 1 || warps < 1 || warps > 16 || smem < 0 ||
      static_cast<size_t>(smem) < need || static_cast<size_t>(smem) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t code = cudaFuncSetAttribute(k12_emd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem);
  if (code != cudaSuccess) return static_cast<int>(code);
  k12_emd<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(X, Z, I, J, P, nb, C,
                                                                          order, out);
  return static_cast<int>(cudaGetLastError());
}

const char* annchor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
