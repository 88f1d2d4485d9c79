"""Annchor: approximate k-NN graphs for slow metrics, on PyTorch.

Port of the JAX package's ``annchor.py`` for the dense device pipeline
(nx <= 4096, the default strategy objects):

  anchors -> locality -> features -> [sample -> regress -> errors ->
  refine -> tighten]*niters -> graph

The orchestration is a staged host loop, as in the JAX package; the
per-pair state lives on one torch device (``ops/device_pipeline.py``)
and every metric evaluation is a batched engine call, which for the
Levenshtein metric on a CUDA device is the hand-written pair kernel.

Not ported yet (each raises NotImplementedError or is absent): the host
pipeline for custom strategy objects, the scale path (nx > 4096),
scout/certify hybrids, post-fit graph refinement, query, persistence,
``to_sparse_matrix`` and the nearest-enemy extras (ROADMAP Queue 1).
"""

from __future__ import annotations

import time

import numpy as np

from annchor_tpu_torch._backend import resolve_device, synchronize
from annchor_tpu_torch.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu_torch.metrics import (
    get_function_from_input,
    make_get_exact_ijs,
    make_get_exact_query_ijs,
    test_parallelisation,
)
from annchor_tpu_torch.ops.device_pipeline import DeviceFitState
from annchor_tpu_torch.ops.locality import DENSE_MAX_NX, candidate_pairs
from annchor_tpu_torch.pickers import MaxMinAnchorPicker
from annchor_tpu_torch.regressors import SimpleStratifiedLinearRegression
from annchor_tpu_torch.samplers import NothingToSample, SimpleStratifiedSampler

__all__ = ["Annchor", "BruteForce", "compare_neighbor_graphs"]

FEATURE_NAMES = [
    "lower bound",
    "upper bound",
    "double anchor distance",
    "is anchor",
]


class Annchor:
    """Quickly computes the approximate k-NN graph for slow metrics.

    Parameters mirror the JAX package's (reference annchor.py:26-90):

    X: list or array — the data set.
    func: "levenshtein" or a Metric.
    n_anchors, n_neighbors, n_samples, p_work: budget knobs; p_work is
        the fraction of brute-force metric calls the fit may spend.
    anchor_picker / sampler / regression / error_predictor: strategy
        objects.  Any anchor picker works; the other three must be the
        defaults (custom ones need the host pipeline, not ported yet).
    locality / loc_thresh / loc_min: candidate filter knobs.
    is_metric: False disables triangle-inequality clipping.
    get_exact_ijs: optional user pairwise evaluator
        get_exact_ijs(f, X, IJ) -> np.array([f(X[i], X[j]) ...]).
    device: torch device of the fit state and the metric engine
        ("cuda" by default; "cpu" runs the kernels' plain versions).
    uniforms: optional callable (random_seed, loop_num, m, device) ->
        (m,) float32 tensor in [0, 1), the sample draw's random numbers
        (default: ``ops.device_pipeline.default_uniforms``).
    """

    def __init__(
        self,
        X,
        func,
        func_kwargs=None,
        n_anchors=None,
        n_neighbors=15,
        n_samples=5000,
        p_work=0.1,
        anchor_picker=None,
        sampler=None,
        regression=None,
        error_predictor=None,
        random_seed=42,
        locality=None,
        loc_thresh=None,
        loc_min=None,
        verbose=False,
        is_metric=True,
        get_exact_ijs=None,
        niters=None,
        device="cuda",
        uniforms=None,
    ):
        self.X = X
        self.nx = len(X)
        self.N = (self.nx * (self.nx - 1)) // 2
        if self.nx > DENSE_MAX_NX:
            raise NotImplementedError(
                "nx = %d > %d runs the scale path (ROADMAP Queue 1 item "
                "13), not ported yet" % (self.nx, DENSE_MAX_NX)
            )
        self.device = resolve_device(device)
        self.uniforms = uniforms

        # the JAX package's defaults at nx <= 4096
        n_anchors = 20 if n_anchors is None else n_anchors
        locality = 5 if locality is None else locality
        loc_thresh = 1 if loc_thresh is None else loc_thresh
        niters = 2 if niters is None else niters

        self.metric = get_function_from_input(func, func_kwargs, self.device)
        self.f = self.metric.scalar
        self.evals = 0

        self.n_anchors = n_anchors
        # deduplicated anchor-pair count used in the work budget
        # (reference annchor.py:126)
        self.na = int(
            np.sum([self.nx - j for j in range(1, self.n_anchors + 1)])
        )
        self.n_neighbors = n_neighbors
        self.p_work = p_work
        self.n_samples = n_samples

        if self.p_work > 1:
            print("Warning: p_work should not exceed 1.  Setting it to 1.")
            self.p_work = 1.0
        min_p_work = (2 * (self.na + self.n_samples) + 1) / self.N
        min_p_work = 1 if min_p_work > 1 else min_p_work
        if self.p_work < min_p_work:
            print("Warning: Too many anchors/samples for specified p_work.")
            print("Increasing p_work to %5.3f." % min_p_work)
            self.p_work = min_p_work
        if self.p_work > 0.75:
            print("Warning: High Value of p_work.")
            print(
                "Think about decreasing n_anchors or n_samples,"
                + " or using BruteForce."
            )

        self.anchor_picker = anchor_picker or MaxMinAnchorPicker()
        self.sampler = sampler or SimpleStratifiedSampler()
        self.regression = regression or SimpleStratifiedLinearRegression()
        self.error_predictor = (
            error_predictor or SimpleStratifiedErrorRegression()
        )

        self.random_seed = random_seed
        self.verbose = verbose
        self.locality = locality
        self.loc_thresh = loc_thresh
        self.loc_min = 10 * self.n_neighbors if loc_min is None else loc_min
        self.loc_min = int(np.clip(self.loc_min, 0, self.nx - 1))
        self.is_metric = bool(is_metric) and self.metric.is_metric
        self.niters = niters

        self._features = None
        self._RefineApprox = None
        self._ncm = None
        self._dev = None  # device-resident state (ops.device_pipeline)
        self._dev_eval = None  # device-id metric eval (fused pipeline)
        self.neighbor_graph = None

        if get_exact_ijs is None:
            self.get_exact_ijs = make_get_exact_ijs(self.metric)
        else:
            self.get_exact_ijs = get_exact_ijs
        test_parallelisation(self.get_exact_ijs, self.f, self.X, self.nx, s=20)
        self.get_exact_query_ijs = None

    # -- device-resident state & lazy host mirrors -------------------------

    def _sync_from_device(self):
        if self._dev is not None:
            (
                self._features,
                self._RefineApprox,
                self._ncm,
            ) = self._dev.materialise()
            self._dev = None

    @property
    def features(self):
        self._sync_from_device()
        return self._features

    @property
    def RefineApprox(self):
        self._sync_from_device()
        return self._RefineApprox

    @property
    def not_computed_mask(self):
        if self._dev is not None:
            return self._dev.ncm_to_host()
        return self._ncm

    def _device_pipeline_ok(self):
        """The device pipeline bakes the default strategies' numeric
        contracts into its programs; custom strategy objects need the
        host pipeline."""
        dad = "double anchor distance"
        return (
            type(self.sampler) is SimpleStratifiedSampler
            and self.sampler.partition_feature_name == dad
            and type(self.regression) is SimpleStratifiedLinearRegression
            and self.regression.partition_feature_name == dad
            and list(self.regression.reg_feature_names)
            == ["lower bound", "upper bound", dad]
            and type(self.error_predictor)
            is SimpleStratifiedErrorRegression
            and self.error_predictor.partition_feature_name == dad
        )

    # -- helpers ----------------------------------------------------------

    def _get_exact_query_ijs_for(self, f):
        if self.get_exact_query_ijs is None:
            self.get_exact_query_ijs = make_get_exact_query_ijs(self.metric)
        return self.get_exact_query_ijs

    def _eval_pairs(self, IJ):
        """Evaluate pairs through the active evaluator, counting evals."""
        d = np.asarray(
            self.get_exact_ijs(self.f, self.X, np.asarray(IJ)),
            dtype=np.float64,
        )
        self.evals += d.shape[0]
        return d

    # -- pipeline stages ---------------------------------------------------

    def get_anchors(self):
        """Anchors + (nx, n_anchors) distance columns
        (reference annchor.py:191-206)."""
        self.A, self.D, evals = self.anchor_picker.get_anchors(self)
        self.evals += evals

    def get_locality(self):
        """Candidate pairs from shared near-anchor sets
        (reference annchor.py:208-256)."""
        self.IJs, self.sid, self.S, self.loc_eff = candidate_pairs(
            self.D, self.locality, self.loc_thresh, self.loc_min, self.device
        )
        self.P_cnt = (
            np.bincount(self.IJs[:, 0], minlength=self.nx)
            + np.bincount(self.IJs[:, 1], minlength=self.nx)
        ).astype(np.int32)
        if (self.P_cnt < self.n_neighbors).any():
            raise Exception(
                "Error: Not enough candidates in pool for all indices.\n"
                + "Try again with higher locality."
            )

    def get_features(self):
        self.feature_names = list(FEATURE_NAMES)
        self._dev = DeviceFitState(self)
        self._dev_eval = self._make_device_eval()

    def _make_device_eval(self):
        """Device-id metric eval for the fused pipeline, or None when the
        user supplied get_exact_ijs (whose call sequence is then part of
        the plug-in contract)."""
        if not getattr(self.get_exact_ijs, "_annchor_default", False):
            return None
        eng = self.metric.batch
        if eng is None or not hasattr(eng, "batch_dev"):
            return None
        if not eng.batch_dev_ready(self.X):
            return None
        X = self.X

        def run(I, J):
            return eng.batch_dev(X, I, J)

        return run

    def get_sample(self):
        """Stratified sample of pairs + their exact distances, drawn on
        the device (reference annchor.py:313-343)."""
        (
            self.sample_ixs,
            self.sample_bins,
            self.sample_features,
            self.sample_ijs,
            sample_y,
        ) = self._dev.draw_sample(
            self.sampler,
            self.n_samples,
            self.random_seed,
            batch_dev=self._dev_eval,
            uniforms=self.uniforms,
        )
        self.n_samples = self.sample_ixs.shape[0]
        if sample_y is not None:
            self.sample_y = sample_y
            self.evals += sample_y.shape[0]
        else:
            self.sample_y = self._eval_pairs(self.sample_ijs)

    def fit_predict_regression(self):
        """Fit the distance regression, predict and clip every pair on
        the device (reference annchor.py:345-380)."""
        self.regression.fit(
            self.sample_features,
            self.feature_names,
            self.sample_y,
            sample_bins=self.sample_bins,
        )
        self.sample_predict = self._dev.regress_update(
            self.regression,
            self.sample_ixs,
            self.sample_y,
            self.sample_features,
        )

    def fit_predict_errors(self):
        """Fit the empirical residual CDFs (reference annchor.py:382-393);
        per-pair bin labels are computed on the device."""
        self.error_predictor.fit(
            self.sample_features,
            self.feature_names,
            self.sample_y - self.sample_predict,
            sample_bins=self.sample_bins,
        )

    def select_refine_candidate_pairs(self, w=0.5, it=0):
        """Spend the refine budget on the pairs most likely to be true
        k-NN edges (reference annchor.py:395-473)."""
        nn = self.n_neighbors
        n_refine = max(
            int((self.p_work * self.N - self.na - self.n_samples) * w) + 1, 0
        )
        if self._dev_eval is not None:
            self.evals += self._dev.select_refine_fused(
                self.error_predictor, n_refine, nn, it == 0, 3 * nn // 2,
                self._dev_eval,
            )
            return
        candidates, cand_IJ = self._dev.select(
            self.error_predictor, n_refine, nn, it == 0, 3 * nn // 2
        )
        if candidates.shape[0]:
            self._dev.apply_exact(candidates, self._eval_pairs(cand_IJ))

    def update_anchor_points(self):
        """Bound tightening between iterations: every computed distance
        is a pseudo-anchor for the pending pairs (reference
        annchor.py:475-512), as one tropical self-product on the device."""
        self._dev.tighten()

    def finalise_bounds(self):
        """Post-refinement tightening and re-clip of the never-computed
        estimates (metric spaces only)."""
        if self.is_metric:
            self._dev.finalise()

    def get_ann(self):
        """Assemble the k-NN graph, self-prepended
        (reference annchor.py:514-530)."""
        ngi, ngd = self._dev.knn_graph(self.n_neighbors - 1)
        ng_exact = self._dev.ng_exact_mask
        self._ng_exact = np.concatenate(
            [np.ones((self.nx, 1), dtype=bool), ng_exact[:, : ngi.shape[1]]],
            axis=1,
        )
        self.neighbor_graph = (
            np.concatenate([np.arange(self.nx)[:, None], ngi], axis=1),
            np.concatenate([np.zeros((self.nx, 1)), ngd], axis=1),
        )

    def fit(self):
        """Computes the approximate nearest neighbour graph.

        With verbose=True prints the reference's stage-timer table
        (reference annchor.py:538-543) with the per-stage metric-call
        count; every stage ends in a device synchronisation, so the
        times are the device's."""
        if not self._device_pipeline_ok():
            raise NotImplementedError(
                "custom sampler/regression/error_predictor objects run the "
                "host pipeline, which is not ported yet (ROADMAP Queue 1 "
                "item 6)"
            )
        evals_seen = [self.evals]

        def timeit(item, origin, start):
            d_evals = self.evals - evals_seen[0]
            evals_seen[0] = self.evals
            now = time.time()
            print(
                "%40s: %6.3f | %7.3f | %7d evals"
                % (item, now - start, now - origin, d_evals)
            )

        def stage(name, fn, origin):
            start = time.time()
            fn()
            if self.verbose:
                synchronize(self.device)
                timeit(name, origin, start)

        origin = time.time()
        for name, fn in [
            ("get_anchors", self.get_anchors),
            ("get_locality", self.get_locality),
            ("get_features", self.get_features),
        ]:
            if self.verbose:
                print(f"computing {name}...")
            stage(name, fn, origin)

        niters = self.niters
        for it in range(niters):
            start = time.time()
            try:
                self.get_sample()
            except NothingToSample as err:
                if it == 0 and self._evaluate_remaining():
                    break
                if it == 0:
                    raise ValueError(
                        "Sampler raised NothingToSample on first iteration."
                    ) from err
                print(
                    "Warning: main loop terminated early with nothing "
                    + "left to sample."
                )
                break
            finally:
                if self.verbose:
                    synchronize(self.device)
                    timeit("get_sample", origin, start)

            stage("fit_predict_regression", self.fit_predict_regression, origin)
            stage("fit_predict_errors", self.fit_predict_errors, origin)
            stage(
                "select_refine_candidate_pairs",
                lambda: self.select_refine_candidate_pairs(w=1 / niters, it=it),
                origin,
            )
            if it < niters - 1:
                stage("update_anchor_points", self.update_anchor_points, origin)

        stage("finalise_bounds", self.finalise_bounds, origin)
        stage("get_ann", self.get_ann, origin)

    def _evaluate_remaining(self):
        """Tiny data sets: the stratified sampler cannot draw on the
        first iteration, but if the whole pool fits the eval budget it
        is evaluated outright (the reference raises here).  Returns
        whether it did so."""
        ncm = np.asarray(self.not_computed_mask)
        remaining = int(ncm.sum())
        budget = int(self.p_work * self.N - self.na)
        if remaining and remaining > budget:
            return False
        if remaining:
            ids = np.flatnonzero(ncm).astype(np.int64)
            self._dev.apply_exact(ids, self._eval_pairs(self._dev._pairs_at(ids)))
        # the regression predict never ran, so the device RA still holds
        # zeros for the anchor-exact pairs
        self._dev.seed_ra_from_store()
        print(
            "Warning: nothing to sample — evaluated the remaining %d "
            "candidate pairs exactly." % remaining
        )
        return True


class BruteForce:
    """Exact k-NN graph through the same metric backend
    (reference annchor.py:943-1023)."""

    def __init__(
        self,
        X,
        func,
        func_kwargs=None,
        verbose=False,
        get_exact_ijs=None,
        device="cuda",
    ):
        self.X = X
        self.nx = len(X)
        self.device = resolve_device(device)
        self.metric = get_function_from_input(func, func_kwargs, self.device)
        self.f = self.metric.scalar
        self.verbose = verbose
        if get_exact_ijs is None:
            self.get_exact_ijs = make_get_exact_ijs(self.metric)
        else:
            self.get_exact_ijs = get_exact_ijs
        test_parallelisation(self.get_exact_ijs, self.f, self.X, self.nx, s=20)

    def fit(self):
        nx = self.nx
        iu = np.triu_indices(nx, k=1)
        IJs = np.stack([iu[0], iu[1]], axis=1)
        dists = np.asarray(
            self.get_exact_ijs(self.f, self.X, IJs), dtype=np.float64
        )
        D = np.zeros((nx, nx))
        D[iu] = dists
        D += D.T
        self.D = D
        self.neighbor_graph = (
            np.argsort(D, axis=1, kind="stable"),
            np.sort(D, axis=1, kind="stable"),
        )


def compare_neighbor_graphs(nng_1, nng_2, n_neighbors):
    """Number of incorrect NN pairs between two k-NN graphs, compared
    as multisets of distances rounded to 3 decimals so equidistant
    neighbours never count as errors (reference annchor.py:1026-1066).

    Note the reference counts the number of *distinct* over-represented
    rounded values per row (len of the Counter difference), which this
    reproduces exactly.
    """
    # + 0.0 maps any -0.0 to +0.0 so the uint32 bit pattern of equal
    # rounded values is identical; nonnegative IEEE floats then sort
    # identically as bits, letting the whole per-row Counter
    # difference run as flat sorted-array ops
    d1 = (
        np.round(np.asarray(nng_1[1])[:, :n_neighbors], 3)
        .astype(np.float32) + 0.0
    )
    d2 = (
        np.round(np.asarray(nng_2[1])[:, :n_neighbors], 3)
        .astype(np.float32) + 0.0
    )
    # the reference zips rows, silently comparing the common prefix
    # when the graphs differ in length — keep that semantics
    nx = min(d1.shape[0], d2.shape[0])
    d1, d2 = d1[:nx], d2[:nx]

    def row_keys(d):
        bits = np.ascontiguousarray(d).view(np.uint32).astype(np.int64)
        row = np.repeat(
            np.arange(nx, dtype=np.int64), d.shape[1]
        )
        return np.sort(row * (1 << 32) + bits.ravel())

    k1 = row_keys(d1)
    k2 = row_keys(d2)
    first = np.ones(k1.shape[0], dtype=bool)
    first[1:] = k1[1:] != k1[:-1]
    uk = k1[first]
    starts = np.flatnonzero(first)
    ac = np.diff(np.append(starts, k1.shape[0]))
    cb = np.searchsorted(k2, uk, "right") - np.searchsorted(k2, uk, "left")
    # reference semantics: per row, the number of DISTINCT rounded
    # values over-represented in graph 1 vs graph 2
    return int(np.sum(ac > cb))
