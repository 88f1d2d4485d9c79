"""Faults planted in the timed path, each of a kind the cells can have,
for the check that ``correct`` comes out false: the CPU tests
(``test_knnbench_faults.py``) and the readings on a card
(``readings.py --fault <name>``).  Each takes ``mp``, a ``pytest.MonkeyPatch``.
The exchange between cards has no fault here: every cell runs on one
card."""

from __future__ import annotations

import numpy as np


def unchanged_refine(mp):
    """A step that returns its state unchanged: the refinement does nothing."""
    from annchor_tpu_torch.annchor import Annchor

    mp.setattr(Annchor, "select_refine_candidate_pairs", lambda self, w=0.5, it=0: None)


def unchanged_certify(mp):
    """The hybrid's certify returns the scout's rows unchanged."""
    from annchor_tpu_torch.annchor import Annchor

    def certify(self, ngi, ngd):
        k = self.n_neighbors - 1
        return ngi[:, :k], ngd[:, :k]
    mp.setattr(Annchor, "_certify", certify)


def stale_query(mp):
    """A query call that returns the answers of the call before it."""
    from annchor_tpu_torch.annchor import Annchor

    real = Annchor.query
    last = {}

    def query(self, Q, *a, **kw):
        out = real(self, Q, *a, **kw)
        prev = last.get("out")
        last["out"] = out
        if prev is None:
            return out
        n = min(len(Q), prev[0].shape[0])
        ngi, ngd = out[0].copy(), out[1].copy()
        ngi[:n], ngd[:n] = prev[0][:n], prev[1][:n]
        return ngi, ngd
    mp.setattr(Annchor, "query", query)


def half_batch_query(mp):
    """Half of each query batch left out of the answer."""
    from annchor_tpu_torch.annchor import Annchor

    real = Annchor.query

    def query(self, Q, *a, **kw):
        ngi, ngd = real(self, Q, *a, **kw)
        h = (len(Q) + 1) // 2
        ngi, ngd = ngi.copy(), ngd.copy()
        ngi[h:], ngd[h:] = -1, np.inf
        return ngi, ngd
    mp.setattr(Annchor, "query", query)


def half_batch_fit(mp):
    """Half of the fit's rows left out of the graph."""
    from annchor_tpu_torch.annchor import Annchor

    real = Annchor.get_ann

    def get_ann(self):
        real(self)
        ngi, ngd = (x.copy() for x in self.neighbor_graph)
        ngi[::2, 1:], ngd[::2, 1:] = -1, np.inf
        self.neighbor_graph = (ngi, ngd)
    mp.setattr(Annchor, "get_ann", get_ann)


def altered_levenshtein(mp):
    """An edit distance altered where the engine produces it."""
    from annchor_tpu_torch import metrics

    real = metrics.myers_pairs

    def myers(enc, I, J):
        d = real(enc, I, J)
        return d + ((I + J) % 3 == 0).to(d.dtype)
    mp.setattr(metrics, "myers_pairs", myers)


def altered_emd(mp):
    """An exact EMD altered where the host solver produces it."""
    from annchor_tpu_torch import native

    real = native.emd_batch

    def emd_batch(*a, **kw):
        return real(*a, **kw) + 1e-6
    mp.setattr(native, "emd_batch", emd_batch)


# the faults each cell can have
BY_CELL = {
    "strings-1600.fit": [unchanged_refine, half_batch_fit, altered_levenshtein],
    "strings-1600.query": [stale_query, half_batch_query, altered_levenshtein],
    "digits-1797.fit": [unchanged_certify, half_batch_fit, altered_emd],
    "digits-1797.query": [stale_query, half_batch_query, altered_emd],
}
