"""Benchmark datasets (reference annchor/datasets.py:7-183).

Copies of the JAX package's generators and loaders.  Each loader returns
{'X', 'y', 'neighbor_graph', ...}, the graph being the exact k-NN ground
truth, computed once with this package's own exact oracles and cached
under ``build/data/`` beside the package:

* strings: the synthetic 1600-string set (``make_strings``) in place of
  the reference's bundled strings, its graph from ``BruteForce``;
* digits: the 1,797 UCI test-split digits under the Wasserstein metric on
  the 8 x 8 grid (``grid_cost_matrix``).  The images are read from
  ``data/digits.npz`` (written from sklearn's bundled copy by
  ``tools/write_digits.py``), so nothing here needs sklearn; the graph
  comes from ``exact_knn`` and its cache is keyed on a hash of the
  images;
* digits-5620: the 1,797 digits and 3,823 seeded augmentations of them
  (``make_digits_large``), with the JAX package's exact graph, copied to
  ``data/digits_large_gt.npz`` and checked against a hash of the images;
* graph-sp: the seeded random clustered graph of ``make_graph`` under
  its shortest-path metric.  With the default arguments that graph has
  four isolated vertices besides its 796-vertex component, whose
  distances to the rest are inf; the ground truth keeps them.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from annchor_tpu_torch._backend import BUILD_ROOT

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_DIGITS = os.path.join(_DATA_DIR, "digits.npz")


def _cache_path(cache_dir, name):
    return os.path.join(cache_dir or os.path.join(BUILD_ROOT, "data"), name)


def _save_cache(path, **arrays):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".%d.tmp.npz" % os.getpid()
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def make_strings(
    n: int = 1600,
    n_clusters: int = 8,
    length: int = 500,
    mutation_rate: float = 0.25,
    alphabet: str = "ACGT",
    seed: int = 42,
    evolve: bool = False,
):
    """Synthetic clustered string set with the reference set's shape
    (1600 strings, ~500 chars, 8 clusters): random seed strings per
    cluster, members derived by substitutions/indels.

    evolve=False (default) mutates every member directly from the
    cluster seed — a star topology where all intra-cluster distances
    concentrate in one tight band.  evolve=True grows each cluster as
    a mutation *tree* (each new member mutates a uniformly chosen
    existing member by `mutation_rate`), which yields the graded
    phylogenetic distance structure of real string corpora."""
    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    X, y = [], []
    # distribute the remainder so exactly n strings come back
    sizes = np.full(n_clusters, n // n_clusters)
    sizes[: n % n_clusters] += 1

    def mutate(parent):
        s = parent.copy()
        nmut = rng.binomial(len(s), mutation_rate)
        pos = rng.integers(0, len(s), size=nmut)
        s[pos] = rng.choice(chars, size=nmut)
        ndel = rng.binomial(len(s), mutation_rate / 5)
        if ndel:
            keep = np.ones(len(s), dtype=bool)
            keep[rng.integers(0, len(s), size=ndel)] = False
            s = s[keep]
        return s

    for c in range(n_clusters):
        seed_len = int(length * rng.uniform(0.85, 1.15))
        seed_str = rng.choice(chars, size=seed_len)
        if evolve:
            members = [mutate(seed_str)]
            for _ in range(int(sizes[c]) - 1):
                parent = members[rng.integers(0, len(members))]
                members.append(mutate(parent))
        else:
            members = [mutate(seed_str) for _ in range(int(sizes[c]))]
        for s in members:
            X.append("".join(s))
            y.append(c)
    return np.array(X), np.array(y)


def load_strings(k: int = 100, device="cuda", cache_dir=None):
    """The synthetic 1600-string set with its exact k-NN graph.

    The graph is the port's ``BruteForce`` graph (1,279,200 edit
    distances), cached in ``cache_dir`` (default ``build/data``).
    Returns {'X', 'y', 'neighbor_graph'}."""
    from annchor_tpu_torch.annchor import BruteForce

    X, y = make_strings()
    cache = _cache_path(cache_dir, "strings_gt_synth.npz")
    if os.path.exists(cache):
        g = np.load(cache)
        ng = (g["ngi"][:, :k], g["ngd"][:, :k])
    else:
        bf = BruteForce(list(X), "levenshtein", device=device)
        bf.fit()
        ng = (bf.neighbor_graph[0][:, :100], bf.neighbor_graph[1][:, :100])
        _save_cache(cache, ngi=ng[0], ngd=ng[1])
        ng = (ng[0][:, :k], ng[1][:, :k])
    return {"X": X, "y": y, "neighbor_graph": ng}


def grid_cost_matrix(h: int = 8, w: int = 8) -> np.ndarray:
    """Euclidean ground metric between pixel positions of an h x w image
    grid: the Wasserstein cost matrix of the digit sets."""
    xy = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1).reshape(h * w, 2)
    return np.linalg.norm(xy[:, None, :] - xy[None, :, :], axis=-1).astype(np.float64)


def _digest(X: np.ndarray) -> str:
    """Content hash of a float array (keys cached ground truth to the
    data it was computed from)."""
    return hashlib.sha256(np.ascontiguousarray(X, dtype=np.float64).tobytes()).hexdigest()


def _knn_from_dense(D: np.ndarray, k: int = 100):
    idx = np.argsort(D, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(D, idx, axis=1)


def digit_images():
    """The 1,797 UCI test-split digits: (X float64 (1797, 64) of
    intensities 0-16, y int64 labels), as sklearn's ``load_digits``
    gives them."""
    with np.load(_DIGITS) as z:
        return z["images"].astype(np.float64), z["labels"].astype(np.int64)


def load_digits(k: int = 100, cache_dir=None):
    """The UCI OCR digits test set (1797 8x8 images) with the grid cost
    matrix and the exact Wasserstein k-NN graph (k <= 100), computed with
    ``exact_knn`` on the host's EMD solver at first use (3.2M solves) and
    cached under ``cache_dir`` (default ``build/data``)."""
    from annchor_tpu_torch.exact import exact_knn

    X, y = digit_images()
    M = grid_cost_matrix()
    xh = _digest(X)
    cache = _cache_path(cache_dir, "digits_gt.npz")
    ng = None
    if os.path.exists(cache):
        g = np.load(cache)
        if str(g["xhash"]) == xh:
            ng = (g["ngi"], g["ngd"])
    if ng is None:
        ng = exact_knn(X, "wasserstein", {"cost_matrix": M}, k=100)
        _save_cache(cache, ngi=ng[0], ngd=ng[1], xhash=xh)
    return {"X": X, "y": y, "neighbor_graph": (ng[0][:, :k], ng[1][:, :k]),
            "cost_matrix": M}


def make_digits_large(n: int = 5620, seed: int = 0):
    """Deterministic stand-in for the full UCI OCR digits set (reference
    datasets.py:49-119: 5620 8x8 images = 3823 train + 1797 test).  Only
    the 1797-image test split is redistributable; the extra images are
    label-preserving augmentations of it (sub-pixel shifts and small
    rotations resampled bilinearly on the 8x8 grid, re-quantised to the
    0..16 intensity range).  Seeded and reproducible; the JAX package's
    generator, image for image."""
    from scipy.ndimage import map_coordinates

    Xb, yb = digit_images()
    base = Xb.reshape(-1, 8, 8)
    nb = base.shape[0]
    if n <= nb:
        return Xb[:n], yb[:n]

    rng = np.random.default_rng(seed)
    extra = n - nb
    src = rng.integers(0, nb, size=extra)
    theta = rng.uniform(-0.15, 0.15, size=extra)  # about +-8.6 degrees
    dx = rng.uniform(-0.7, 0.7, size=extra)
    dy = rng.uniform(-0.7, 0.7, size=extra)
    gy, gx = np.mgrid[0:8, 0:8].astype(np.float64)
    cy = cx = 3.5
    out = np.empty((extra, 8, 8))
    for t in range(extra):
        c, s = np.cos(theta[t]), np.sin(theta[t])
        # inverse map: output pixel -> source coordinate
        sy = cy + c * (gy - cy) + s * (gx - cx) - dy[t]
        sx = cx - s * (gy - cy) + c * (gx - cx) - dx[t]
        out[t] = map_coordinates(base[src[t]], [sy, sx], order=1, mode="constant")
    out = np.clip(np.rint(out), 0, 16)
    X = np.concatenate([base.reshape(nb, 64), out.reshape(extra, 64)])
    y = np.concatenate([yb, yb[src]])
    return X, y


def load_digits_large(k: int = 100):
    """The 5620-image digits workload (``make_digits_large``) with its
    exact Wasserstein 100-NN graph, the JAX package's data set and
    ground truth: ``data/digits_large_gt.npz`` is a byte copy of the JAX
    package's file, computed once with the exact EMD (about 25 minutes of
    host solves).  Its ``xhash`` must match the digest of the images made
    here, else the images differ from the ones it was computed on (numpy
    does not promise its generators' streams across versions) and this
    raises.  Returns {"X", "y", "neighbor_graph" (ngi, ngd)[:, :k],
    "cost_matrix"}."""
    X, y = make_digits_large()
    g = np.load(os.path.join(_DATA_DIR, "digits_large_gt.npz"))
    if str(g["xhash"]) != _digest(X):
        raise ValueError(
            "data/digits_large_gt.npz was computed on other images than "
            "make_digits_large() gives here (image hash mismatch)"
        )
    return {"X": X, "y": y, "neighbor_graph": (g["ngi"][:, :k], g["ngd"][:, :k]),
            "cost_matrix": grid_cost_matrix()}


def make_graph(
    n_vertices: int = 800,
    n_clusters: int = 10,
    p_intra: float = 0.05,
    p_inter: float = 0.002,
    seed: int = 42,
):
    """Seeded random clustered weighted graph with the reference graph_sp
    set's shape (800 vertices, ~4700 edges, 10 clusters).  Returns (edges
    int64 (E, 2), weights (E,), cluster labels (n,))."""
    rng = np.random.default_rng(seed)
    y = np.repeat(np.arange(n_clusters), n_vertices // n_clusters)
    rows, cols, weights = [], [], []
    for i in range(n_vertices):
        same = y == y[i]
        p = np.where(same, p_intra, p_inter)
        p[: i + 1] = 0
        edges = np.nonzero(rng.random(n_vertices) < p)[0]
        for j in edges:
            rows.append(i)
            cols.append(j)
            weights.append(
                rng.uniform(0.1, 1.0) if y[i] == y[j] else rng.uniform(1.0, 3.0)
            )
    edges = np.stack([rows, cols], axis=1).astype(np.int64)
    return edges, np.array(weights), y


def graph_adjacency(n, edges, weights):
    """The undirected weighted graph as a scipy CSR adjacency (n, n)."""
    from scipy.sparse import coo_matrix

    return coo_matrix(
        (
            np.concatenate([weights, weights]),
            (
                np.concatenate([edges[:, 0], edges[:, 1]]),
                np.concatenate([edges[:, 1], edges[:, 0]]),
            ),
        ),
        shape=(n, n),
    ).tocsr()


def _sp_ground_truth(n, edges, weights, k=100):
    from scipy.sparse.csgraph import dijkstra

    A = graph_adjacency(n, edges, weights)
    return _knn_from_dense(dijkstra(A, directed=False), k), A


def load_graph_sp(k: int = 100):
    """Weighted-graph shortest-path set: X are vertex indices, the metric
    is dijkstra distance on the graph of ``make_graph()`` (reference
    datasets.py:122-183).  Returns the exact k-NN graph (inf past a
    vertex's component), a networkx graph 'G' (None without networkx),
    the scipy CSR adjacency 'A', the edges and weights."""
    edges, weights, y = make_graph()
    n = len(y)
    X = np.arange(n)
    ng, A = _sp_ground_truth(n, edges, weights, k)
    try:
        import networkx as nkx

        edge_list = ["%d %d %s" % (i, j, w) for (i, j), w in zip(edges, weights)]
        G = nkx.readwrite.edgelist.parse_edgelist(edge_list, nodetype=int,
                                                  data=(("w", float),))
    except ImportError:
        G = None
    return {"X": X, "y": y, "neighbor_graph": ng, "G": G, "A": A, "edges": edges,
            "weights": weights}
