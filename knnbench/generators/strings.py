"""Clustered strings: a frozen copy of the program's
``datasets.make_strings``, the shape of the upstream's bundled set.

Spec keys: ``n``, ``n_clusters``, ``length``, ``mutation_rate``,
``alphabet``, ``data_seed``, ``evolve``.  The set is a function of the
spec alone, so every seed of a run asks the same work.
"""

from __future__ import annotations

import numpy as np


def make_strings(n=1600, n_clusters=8, length=500, mutation_rate=0.25, alphabet="ACGT",
                 seed=42, evolve=False):
    """Clustered strings: a random seed string per cluster, members
    derived from it by substitutions and deletions (evolve=False: each
    member from the seed; evolve=True: from a uniformly chosen earlier
    member).  Returns (X, y) as numpy arrays."""
    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    X, y = [], []
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


def make(spec, root):
    """The configuration's strings, a list in the generator's order."""
    X = make_strings(spec["n"], spec["n_clusters"], spec["length"], spec["mutation_rate"],
                     spec["alphabet"], spec["data_seed"], spec.get("evolve", False))[0]
    return X.tolist()
