// Exact 1-Wasserstein (Kantorovich) distance on the host, for the
// wasserstein metric of annchor_tpu_torch.
//
// A copy of the EMD solver of the JAX package's host library
// (annchor_tpu/native/annchor_native.cpp): the transportation network
// simplex with a least-cost initial basis, the successive-shortest-path
// solver that cross-checks it, the per-cost-matrix rank table, and a
// thread stripe over the batch.  The port solves the same network simplex
// on the card too, a warp a pair (K12, csrc/emd_simplex.cu), for a card
// engine and histograms of at most 64 bins; this solver serves the CPU,
// wider histograms and the scalar metric.
//
// Built with g++ -O3 -march=native -ffp-contract=off -std=c++17 -shared
// -fPIC -pthread at first use (annchor_tpu_torch/native.py).  The
// compiler fuses no multiply-add here: every FMA is written out
// (std::fma), exactly where GCC 12 contracts the JAX package's copy,
// built without -ffp-contract=off.  So the arithmetic is the source's on
// every compiler: K12 and its plain version (ops/emd_cuda.py) repeat it
// bit for bit, and where g++ contracts as GCC 12 does, the JAX package's
// library gives the same float64 results; under another contraction the
// two may differ by an ulp.  Each std::fma is marked "FMA site: <name>";
// the network simplex's sites are ops/emd_cuda.py FMA_SITES, the list that
// K12 and the plain version share (tests/test_torch_emd_simplex.py holds
// the three files to it), and the SSP's two are this file's alone.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = 1e300;
constexpr double kFlowTol = 1e-14;

// Exact transportation problem:
//   minimise sum_ij f_ij C_ij  s.t.  sum_j f_ij = a_i, sum_i f_ij = b_j
// a and b must each sum to ~1 (caller normalises).
// Successive shortest paths with Johnson potentials; Dijkstra with
// linear-scan extraction (node count n+m <= a few hundred).
double emd_ssp(const double* a_in, const double* b_in, int n, int m,
               const double* C) {
  std::vector<double> ra(a_in, a_in + n);
  std::vector<double> rb(b_in, b_in + m);
  std::vector<double> f(static_cast<size_t>(n) * m, 0.0);
  std::vector<double> pi(n + m, 0.0);

  std::vector<double> dist(n + m);
  std::vector<int> parent(n + m);
  std::vector<char> done(n + m);

  double remaining = 0.0;
  for (int i = 0; i < n; ++i) remaining += ra[i];
  // FMA site: ssp-tol (host only)
  const double tol = std::fma(remaining, 1e-12, 1e-14);

  int max_rounds = 16 * (n + m) + 64;
  while (remaining > tol && max_rounds-- > 0) {
    // --- Dijkstra over the residual graph with reduced costs.
    std::fill(dist.begin(), dist.end(), kInf);
    std::fill(parent.begin(), parent.end(), -1);
    std::fill(done.begin(), done.end(), 0);
    for (int i = 0; i < n; ++i)
      if (ra[i] > kFlowTol) dist[i] = 0.0;

    int t = -1;
    for (int iter = 0; iter < n + m; ++iter) {
      int u = -1;
      double best = kInf;
      for (int v = 0; v < n + m; ++v)
        if (!done[v] && dist[v] < best) { best = dist[v]; u = v; }
      if (u < 0) break;
      done[u] = 1;
      if (u >= n && rb[u - n] > kFlowTol) {
        // first settled sink with remaining demand is the nearest one
        t = u;
        break;
      }
      if (u < n) {
        // source u -> every sink j (uncapacitated forward arc)
        const double base = dist[u] + pi[u];
        const double* Cu = C + static_cast<size_t>(u) * m;
        for (int j = 0; j < m; ++j) {
          // Never re-relax a settled node: with tied costs the reduced
          // cost can be -1e-16 in floating point, and re-parenting a
          // done node creates parent-pointer cycles.
          if (done[n + j]) continue;
          const double nd = base + Cu[j] - pi[n + j];
          if (nd < dist[n + j]) { dist[n + j] = nd; parent[n + j] = u; }
        }
      } else {
        // sink (u-n) -> source i exists iff flow f[i][u-n] > 0
        const int j = u - n;
        const double base = dist[u] + pi[u];
        for (int i = 0; i < n; ++i) {
          if (done[i]) continue;
          if (f[static_cast<size_t>(i) * m + j] > kFlowTol) {
            const double nd = base - C[static_cast<size_t>(i) * m + j] - pi[i];
            if (nd < dist[i]) { dist[i] = nd; parent[i] = u; }
          }
        }
      }
    }

    if (t < 0) break;  // infeasible / numerically drained
    const double bestd = dist[t];

    // --- update potentials
    for (int v = 0; v < n + m; ++v)
      pi[v] += (dist[v] < kInf ? std::min(dist[v], bestd) : bestd);

    // --- bottleneck along the path (path length bounded by node count)
    double delta = rb[t - n];
    int v = t;
    int guard = n + m + 2;
    while (guard-- > 0) {
      const int p = parent[v];
      if (v >= n) {  // arrived via forward arc p -> v
        if (parent[p] == -1 && p < n) { delta = std::min(delta, ra[p]); break; }
      } else {       // arrived via backward arc p(sink) -> v(source)
        delta = std::min(delta, f[static_cast<size_t>(v) * m + (p - n)]);
      }
      v = p;
    }

    // --- augment
    v = t;
    guard = n + m + 2;
    while (guard-- > 0) {
      const int p = parent[v];
      if (v >= n) {
        f[static_cast<size_t>(p) * m + (v - n)] += delta;
        if (parent[p] == -1 && p < n) { ra[p] -= delta; break; }
      } else {
        f[static_cast<size_t>(v) * m + (p - n)] -= delta;
      }
      v = p;
    }
    rb[t - n] -= delta;
    remaining -= delta;
  }

  double total = 0.0;
  for (int i = 0; i < n; ++i) {
    const double* fi = f.data() + static_cast<size_t>(i) * m;
    const double* Ci = C + static_cast<size_t>(i) * m;
    // FMA site: ssp-cost (host only)
    for (int j = 0; j < m; ++j) total = std::fma(fi[j], Ci[j], total);
  }
  return total;
}

// ---------------------------------------------------------------------------
// Transportation network simplex.
//
// The SSP solver above is exact but pays a full Dijkstra per
// augmentation (~80 augmentations on digit-sized instances).  The
// simplex maintains a spanning-tree basis instead: each pivot is a
// full pricing pass (n*m reduced costs) plus an O(n+m) cycle/update,
// and typical pivot counts are ~(n+m).  On 8x8-image histograms this
// is ~5x faster per call, matching the class of solver the reference
// relies on (pynndescent's numba network simplex kantorovich,
// reference annchor/utils.py:82-86).
//
// Implementation notes:
//  * nodes 0..n-1 = sources, n..n+m-1 = sinks; the basis is a spanning
//    tree of basic arcs (i, j) held as parent pointers with depths.
//  * anti-cycling by supply perturbation (makes the problem generic),
//    then flows are re-derived EXACTLY from the final basis tree with
//    the unperturbed supplies (tree flows are uniquely determined), so
//    the returned cost has no perturbation error.
//  * Dantzig pricing (most negative reduced cost).
class NetSimplex {
 public:
  // C: compressed (n, m) cost submatrix.  cells: the n*m compressed
  // cell ids ((i << 16) | j) in ascending cost order.  The caller
  // derives that order by counting-sorting on distinct-cost ranks
  // precomputed ONCE per cost matrix (emd_batch shares them across
  // the whole batch; the per-call std::sort of subset cells it
  // replaces measured 40 of the 117 us/call on digit histograms).
  double solve(const double* a, const double* b, int n, int m,
               const double* C, const int32_t* cells) {
    n_ = n; m_ = m; N_ = n + m; C_ = C;
    parent_.assign(N_, -1);
    depth_.assign(N_, 0);
    u_.assign(N_, 0.0);
    flow_.assign(N_, 0.0);   // flow on the arc to parent
    adj_head_.assign(N_, -1);
    adj_next_.assign(2 * N_, -1);
    adj_node_.assign(2 * N_, -1);
    order_.assign(N_, 0);
    kids_head_.assign(N_, -1);
    kids_next_.assign(N_, -1);
    kids_prev_.assign(N_, -1);

    // --- perturbed supplies for genericity (scratch vectors are
    // members so a reused solver instance allocates nothing per call —
    // at digit-sized instances malloc traffic was a large fraction of
    // the per-call cost)
    sa_.assign(a, a + n);
    sb_.assign(b, b + m);
    double total = 0.0;
    for (int i = 0; i < n; ++i) total += sa_[i];
    const double eps = total * 1e-11;
    for (int i = 0; i < n; ++i) sa_[i] += eps;
    // FMA site: supply
    sb_[m - 1] = std::fma(n, eps, sb_[m - 1]);

    // --- least-cost initial basic solution: allocate cells in
    // ascending cost order, skipping exhausted rows/columns.  Under
    // generic (perturbed) supplies each allocation exhausts exactly
    // one side, giving n+m-1 acyclic cells = a spanning tree, like the
    // northwest rule but cost-aware: it starts the simplex much closer
    // to optimal (~2x fewer pivots on image-histogram instances).
    // Cells come from the shared full-matrix order; off-support cells
    // (inv < 0) are skipped — a branchy scan over nbins^2 packed ints,
    // far cheaper than sorting the subset per call.
    {
      arc_a_.clear();
      arc_b_.clear();
      arc_f_.clear();
      seen_.assign(N_, 0);  // 1 = exhausted
      int live = n + m;
      const long ncells = static_cast<long>(n) * m;
      for (long k = 0; k < ncells && live > 1; ++k) {
        const int32_t cell = cells[k];
        const int i = cell >> 16, j = cell & 0xffff;
        if (seen_[i] || seen_[n + j]) continue;
        const double f = std::min(sa_[i], sb_[j]);
        arc_a_.push_back(i);
        arc_b_.push_back(j);
        arc_f_.push_back(f);
        sa_[i] -= f;
        sb_[j] -= f;
        if (live > 2) {
          if (sa_[i] <= 0.0) { seen_[i] = 1; --live; }
          else { seen_[n + j] = 1; --live; }
        } else {
          live = 1;  // last cell closes both sides
        }
      }
      build_tree_(arc_a_, arc_b_, arc_f_);
    }

    // FMA site: tol
    const double tol = std::fma(cost_scale_(), 1e-12, 1e-15);
    const int max_pivots = 64 * N_ + 256;
    refresh_();
    for (int it = 0; it < max_pivots; ++it) {
      // Dantzig pricing over all source->sink arcs.  Two passes keep
      // the hot loop branchless (vectorisable min) instead of an
      // argmin with a data-dependent branch per arc — pricing was
      // ~2/3 of the solve time in the naive form.
      double best = -tol;
      int bi = -1, bj = -1;
      const double* v = u_.data() + n_;
      for (int i = 0; i < n_; ++i) {
        const double* Ci = C_ + static_cast<size_t>(i) * m_;
        // four independent min chains so the reduction vectorises
        double r0 = 1e300, r1 = 1e300, r2 = 1e300, r3 = 1e300;
        int j = 0;
        for (; j + 4 <= m_; j += 4) {
          const double c0 = Ci[j] - v[j];
          const double c1 = Ci[j + 1] - v[j + 1];
          const double c2 = Ci[j + 2] - v[j + 2];
          const double c3 = Ci[j + 3] - v[j + 3];
          r0 = c0 < r0 ? c0 : r0;
          r1 = c1 < r1 ? c1 : r1;
          r2 = c2 < r2 ? c2 : r2;
          r3 = c3 < r3 ? c3 : r3;
        }
        for (; j < m_; ++j) {
          const double c = Ci[j] - v[j];
          r0 = c < r0 ? c : r0;
        }
        double rmin = std::min(std::min(r0, r1), std::min(r2, r3));
        rmin -= u_[i];
        if (rmin < best) { best = rmin; bi = i; }
      }
      if (bi < 0) break;  // optimal
      {
        const double* Ci = C_ + static_cast<size_t>(bi) * m_;
        const double target = best + u_[bi];
        double bb = target + 1.0;
        for (int j = 0; j < m_; ++j) {
          const double rc = Ci[j] - v[j];
          if (rc < bb) { bb = rc; bj = j; }
        }
      }
      pivot_(bi, n_ + bj);
      // incremental: only the re-hung subtree's depths/potentials
      // changed (everything outside kept its ancestor path); the full
      // per-pivot tree rebuild this replaces was ~half the solve time
      update_subtree_(end_);
    }
    rebuild_order_();  // flow derivation below wants a fresh BFS order

    // --- exact flows from the final basis with unperturbed supplies:
    // peel leaves; each leaf's parent-arc flow equals its residual
    // imbalance (supply positive, demand negative).
    sa_.assign(N_, 0.0);
    std::vector<double>& bal = sa_;
    for (int i = 0; i < n_; ++i) bal[i] = a[i];
    for (int j = 0; j < m_; ++j) bal[n_ + j] = -b[j];
    const std::vector<int>& bfs = order_;  // current BFS order
    double cost = 0.0;
    for (int k = static_cast<int>(bfs.size()) - 1; k > 0; --k) {
      const int v = bfs[k];
      const int p = parent_[v];
      // arc between v and p carries |bal[v]|; cost counts C once
      const int src = (v < n_) ? v : p;
      const int snk = (v < n_) ? p - n_ : v - n_;
      // FMA site: peel
      cost = std::fma(std::abs(bal[v]), C_[static_cast<size_t>(src) * m_ + snk], cost);
      bal[p] += bal[v];
    }
    return cost;
  }

 private:
  int n_ = 0, m_ = 0, N_ = 0;
  const double* C_ = nullptr;
  std::vector<int> parent_, depth_;
  std::vector<double> u_, flow_;
  std::vector<int> adj_head_, adj_next_, adj_node_;
  std::vector<int> order_, kids_head_, kids_next_, kids_prev_;
  int end_ = -1;  // root of the subtree re-hung by the last pivot
  std::vector<double> sa_, sb_, arc_f_;
  std::vector<int> arc_a_, arc_b_, stack_;
  std::vector<char> seen_;
  int adj_fill_ = 0;

  double cost_scale_() const {
    double mx = 0.0;
    for (size_t k = 0; k < static_cast<size_t>(n_) * m_; ++k)
      mx = std::max(mx, C_[k]);
    return mx;
  }

  void adj_add_(int a, int b) {
    adj_node_[adj_fill_] = b;
    adj_next_[adj_fill_] = adj_head_[a];
    adj_head_[a] = adj_fill_++;
  }

  // build parent/depth/flow (rooted at node 0) from a basic arc list
  // (source index, sink index, flow); flows live on the child end
  void build_tree_(const std::vector<int>& arc_a,
                   const std::vector<int>& arc_b,
                   const std::vector<double>& arc_f) {
    adj_fill_ = 0;
    std::fill(adj_head_.begin(), adj_head_.end(), -1);
    for (size_t k = 0; k < arc_a.size(); ++k) {
      adj_add_(arc_a[k], n_ + arc_b[k]);
      adj_add_(n_ + arc_b[k], arc_a[k]);
    }
    stack_.assign(1, 0);
    seen_.assign(N_, 0);
    seen_[0] = 1;
    parent_[0] = -1;
    depth_[0] = 0;
    while (!stack_.empty()) {
      const int v = stack_.back();
      stack_.pop_back();
      for (int e = adj_head_[v]; e >= 0; e = adj_next_[e]) {
        const int w = adj_node_[e];
        if (seen_[w]) continue;
        seen_[w] = 1;
        parent_[w] = v;
        depth_[w] = depth_[v] + 1;
        stack_.push_back(w);
      }
    }
    std::fill(flow_.begin(), flow_.end(), 0.0);
    for (size_t k = 0; k < arc_a.size(); ++k) {
      const int x = arc_a[k], y = n_ + arc_b[k];
      const int child = (parent_[x] == y) ? x : y;
      flow_[child] = arc_f[k];
    }
  }

  // full rebuild of kid lists, BFS order, depths and potentials
  // (u[src] + v[snk] = C on basic arcs) from the parent pointers —
  // called ONCE after the initial basis; pivots maintain everything
  // incrementally from then on
  void refresh_() {
    std::fill(kids_head_.begin(), kids_head_.end(), -1);
    for (int v = 0; v < N_; ++v)
      if (parent_[v] >= 0) attach_(v, parent_[v]);
    rebuild_order_();
    depth_[0] = 0;
    u_[0] = 0.0;
    for (int h = 1; h < N_; ++h) {
      const int c = order_[h];
      const int v = parent_[c];
      depth_[c] = depth_[v] + 1;
      const int src = (c < n_) ? c : v;
      const int snk = (c < n_) ? v - n_ : c - n_;
      u_[c] = C_[static_cast<size_t>(src) * m_ + snk] - u_[v];
    }
  }

  // O(1) doubly-linked kid-list surgery (pivots re-hang a short chain)
  void detach_(int c) {
    const int p = parent_[c];
    const int prv = kids_prev_[c], nxt = kids_next_[c];
    if (prv >= 0) kids_next_[prv] = nxt; else kids_head_[p] = nxt;
    if (nxt >= 0) kids_prev_[nxt] = prv;
  }

  void attach_(int c, int p) {
    const int h = kids_head_[p];
    kids_next_[c] = h;
    kids_prev_[c] = -1;
    if (h >= 0) kids_prev_[h] = c;
    kids_head_[p] = c;
  }

  // recompute depth/potential below `root` (its parent's values are
  // valid: the parent lies outside the re-hung subtree)
  void update_subtree_(int root) {
    stack_.assign(1, root);
    while (!stack_.empty()) {
      const int v = stack_.back();
      stack_.pop_back();
      const int p = parent_[v];
      depth_[v] = depth_[p] + 1;
      const int src = (v < n_) ? v : p;
      const int snk = (v < n_) ? p - n_ : v - n_;
      u_[v] = C_[static_cast<size_t>(src) * m_ + snk] - u_[p];
      for (int c = kids_head_[v]; c >= 0; c = kids_next_[c])
        stack_.push_back(c);
    }
  }

  void rebuild_order_() {
    order_[0] = 0;
    int tail = 1;
    for (int h = 0; h < tail; ++h)
      for (int c = kids_head_[order_[h]]; c >= 0; c = kids_next_[c])
        order_[tail++] = c;
  }

  void pivot_(int i, int jn) {
    // entering arc i (source) -- jn (sink node id). Walk both ends to
    // their LCA; min flow over the reverse-oriented cycle arcs leaves.
    int x = i, y = jn;
    // reverse arcs are those oriented against the entering direction:
    // traversing from source side up, an arc child->parent is reverse
    // iff it carries flow from sink to source orientation. For the
    // transportation cycle the arcs alternate; the classical rule:
    // going up from i, arcs where the child is a SOURCE are reverse;
    // going up from jn, arcs where the child is a SINK are reverse.
    double delta = kInf;
    int leave = -1;  // child id of the leaving arc
    int lx = x, ly = y;
    while (lx != ly) {
      if (depth_[lx] >= depth_[ly]) {
        if (lx < n_ && flow_[lx] <= delta) { delta = flow_[lx]; leave = lx; }
        lx = parent_[lx];
      } else {
        if (ly >= n_ && flow_[ly] <= delta) { delta = flow_[ly]; leave = ly; }
        ly = parent_[ly];
      }
    }
    // apply flow change around the cycle
    int v = x;
    while (v != lx) {
      flow_[v] += (v < n_) ? -delta : delta;
      v = parent_[v];
    }
    v = y;
    while (v != lx) {
      flow_[v] += (v >= n_) ? -delta : delta;
      v = parent_[v];
    }
    // re-hang: entering arc replaces the leaving arc. Reverse the
    // parent chain from the entering arc's sink-side endpoint up to
    // the leaving arc, then attach.
    // Choose the endpoint on the same side of the cut as `leave`.
    int end = on_path_(x, leave) ? x : y;
    int other = (end == x) ? y : x;
    // reverse chain end -> leave, mirroring each parent change into
    // the kid lists (the caller then refreshes only this subtree)
    int prev = other;             // new parent of `end` via entering arc
    double carry = delta;         // entering arc starts with flow delta
    int cur = end;
    while (prev != -1 && cur != -1) {
      const int nxt = parent_[cur];
      const double nxtflow = flow_[cur];
      detach_(cur);               // from its old parent (still set)
      parent_[cur] = prev;
      attach_(cur, prev);
      flow_[cur] = carry;
      if (cur == leave) break;
      prev = cur;
      cur = nxt;
      carry = nxtflow;
    }
    end_ = end;
    // depths/potentials of the re-hung subtree refreshed by the caller
  }

  bool on_path_(int start, int target) const {
    for (int v = start; v >= 0; v = parent_[v])
      if (v == target) return true;
    return false;
  }
};

double emd_netsimplex(const double* a, const double* b, int n, int m,
                      const double* C, const int32_t* cells) {
  if (n == 1 || m == 1) {  // trivial: all mass via the single node
    // the products rounded and summed in order, the last of an odd count
    // fused: what GCC 12 made of the plain sum (pairs and fours of
    // products, an odd last term alone), kept as the JAX package's copy
    const int cnt = (n == 1) ? m : n;
    const double* w = (n == 1) ? b : a;
    double cost = 0.0;
    for (int k = 0; k < cnt; ++k) {
      const double c = (n == 1) ? C[k] : C[static_cast<size_t>(k) * m];
      // FMA site: one-node
      cost = (k == cnt - 1 && (cnt & 1)) ? std::fma(w[k], c, cost) : cost + w[k] * c;
    }
    return cost;
  }
  // reuse one solver per thread: member scratch keeps its capacity so
  // warm calls perform no allocation at all
  static thread_local NetSimplex ns;
  return ns.solve(a, b, n, m, C, cells);
}

// Distinct-cost rank of every full-matrix cell, shared by every solve
// under one cost matrix.  Grid ground metrics have very few distinct
// values (~40 on an 8x8 grid), so a per-call counting sort on these
// ranks is O(n*m + ndv) where the subset std::sort it replaces was
// O(n*m log n*m) with cold comparator gathers.  Returns ndv.
int build_cost_ranks(const double* C, int nbins, std::vector<int32_t>& rank) {
  const long nb2 = static_cast<long>(nbins) * nbins;
  std::vector<double> vals(C, C + nb2);
  std::sort(vals.begin(), vals.end());
  vals.erase(std::unique(vals.begin(), vals.end()), vals.end());
  rank.resize(nb2);
  for (long k = 0; k < nb2; ++k)
    rank[k] = static_cast<int32_t>(
        std::lower_bound(vals.begin(), vals.end(), C[k]) - vals.begin());
  return static_cast<int>(vals.size());
}

// Normalise histograms to unit mass (matches pynndescent kantorovich
// semantics used by the reference, annchor/utils.py:82-86), compress
// away zero-mass bins (digit images are ~50% zeros, and the solver is
// quadratic in the support size), then solve.
double emd_normalised(const double* x, const double* y, int nbins,
                      const double* C, const int32_t* rank, int ndv,
                      int use_ssp = 0) {
  double sx = 0.0, sy = 0.0;
  for (int i = 0; i < nbins; ++i) { sx += x[i]; sy += y[i]; }
  if (sx <= 0.0 || sy <= 0.0) return 0.0;

  static thread_local std::vector<double> a, b, Csub;
  static thread_local std::vector<int> ia, ib, counts;
  static thread_local std::vector<int32_t> cranks, cells;
  a.clear(); b.clear(); ia.clear(); ib.clear();
  for (int i = 0; i < nbins; ++i)
    if (x[i] > 0.0) { a.push_back(x[i] / sx); ia.push_back(i); }
  for (int j = 0; j < nbins; ++j)
    if (y[j] > 0.0) { b.push_back(y[j] / sy); ib.push_back(j); }

  const int n = static_cast<int>(a.size());
  const int m = static_cast<int>(b.size());
  const long nm = static_cast<long>(n) * m;
  Csub.assign(nm, 0.0);
  if (use_ssp) {  // rank may be null on this path — no basis needed
    for (int i = 0; i < n; ++i) {
      const double* Ci = C + static_cast<size_t>(ia[i]) * nbins;
      for (int j = 0; j < m; ++j)
        Csub[static_cast<size_t>(i) * m + j] = Ci[ib[j]];
    }
    return emd_ssp(a.data(), b.data(), n, m, Csub.data());
  }
  cranks.resize(nm);
  for (int i = 0; i < n; ++i) {
    const double* Ci = C + static_cast<size_t>(ia[i]) * nbins;
    const int32_t* Ri = rank + static_cast<size_t>(ia[i]) * nbins;
    for (int j = 0; j < m; ++j) {
      Csub[static_cast<size_t>(i) * m + j] = Ci[ib[j]];
      cranks[static_cast<size_t>(i) * m + j] = Ri[ib[j]];
    }
  }

  // counting sort of the compressed cells by distinct-cost rank —
  // stable in (i, j) enumeration order, so ties break deterministically
  counts.assign(ndv + 1, 0);
  for (long k = 0; k < nm; ++k) ++counts[cranks[k] + 1];
  for (int r = 0; r < ndv; ++r) counts[r + 1] += counts[r];
  cells.resize(nm);
  {
    long k = 0;
    for (int32_t i = 0; i < n; ++i)
      for (int32_t j = 0; j < m; ++j, ++k)
        cells[counts[cranks[k]]++] = (i << 16) | j;
  }
  return emd_netsimplex(a.data(), b.data(), n, m, Csub.data(),
                        cells.data());
}

// Stripe a batch of m independent jobs over the host cores (the
// reference fans the same workloads over joblib worker processes,
// reference annchor/utils.py:152-177; threads avoid its serialisation
// overhead).  Degrades to the calling thread when only one core
// exists or the batch is small.
template <typename Fn>
void parallel_for(long m, Fn&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  long nthreads = std::min<long>(hw ? hw : 1, (m + 63) / 64);
  if (nthreads <= 1) {
    for (long k = 0; k < m; ++k) fn(k);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (long t = 0; t < nthreads; ++t) {
    pool.emplace_back([=]() {
      for (long k = t; k < m; k += nthreads) fn(k);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

double emd_single(const double* a, const double* b, long nbins,
                  const double* cost) {
  // per-call rank build: emd_single is the test/cross-check entry;
  // identical enumeration to the batch path keeps values bit-equal
  std::vector<int32_t> rank;
  const int ndv = build_cost_ranks(cost, static_cast<int>(nbins), rank);
  return emd_normalised(a, b, static_cast<int>(nbins), cost, rank.data(),
                        ndv);
}

// independent-solver cross check (successive shortest paths); used by
// the test-suite to validate the network simplex against a second
// exact algorithm
double emd_single_ssp(const double* a, const double* b, long nbins,
                      const double* cost) {
  return emd_normalised(a, b, static_cast<int>(nbins), cost, nullptr, 0, 1);
}

// Distances for pairs (I[k] into X, J[k] into Y).  X: (nx, nbins), Y:
// (ny, nbins), both row-major float64.  out: (m,).
int emd_batch(const double* X, long nx, const double* Y, long ny, long nbins,
              const double* cost, const long* I, const long* J, long m,
              double* out) {
  for (long k = 0; k < m; ++k)
    if (I[k] < 0 || I[k] >= nx || J[k] < 0 || J[k] >= ny) return -1;
  // one distinct-cost rank table for the whole batch, shared
  // read-only by the workers (it replaces a per-call subset sort that
  // was ~34% of the per-call time on digit histograms)
  std::vector<int32_t> rank;
  const int ndv = build_cost_ranks(cost, static_cast<int>(nbins), rank);
  const int32_t* rk = rank.data();
  parallel_for(m, [=](long k) {
    out[k] = emd_normalised(X + I[k] * nbins, Y + J[k] * nbins,
                            static_cast<int>(nbins), cost, rk, ndv);
  });
  return 0;
}

}  // extern "C"
