"""The 1600-string Levenshtein benchmark set (reference
annchor/datasets.py:7-48).

``make_strings`` is copied from the JAX package's ``datasets.py``; the
synthetic set it builds replaces the reference's bundled strings.  Its
exact 100-NN ground truth is computed once with this package's own
``BruteForce`` and cached under ``build/data/`` beside the package.
"""

from __future__ import annotations

import os

import numpy as np

from annchor_tpu_torch._backend import BUILD_ROOT


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
    cache_dir = cache_dir or os.path.join(BUILD_ROOT, "data")
    cache = os.path.join(cache_dir, "strings_gt_synth.npz")
    if os.path.exists(cache):
        g = np.load(cache)
        ng = (g["ngi"][:, :k], g["ngd"][:, :k])
    else:
        bf = BruteForce(list(X), "levenshtein", device=device)
        bf.fit()
        ng = (bf.neighbor_graph[0][:, :100], bf.neighbor_graph[1][:, :100])
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache + ".%d.tmp.npz" % os.getpid()
        np.savez_compressed(tmp, ngi=ng[0], ngd=ng[1])
        os.replace(tmp, cache)
        ng = (ng[0][:, :k], ng[1][:, :k])
    return {"X": X, "y": y, "neighbor_graph": ng}
