"""Annchor: approximate k-NN graphs for slow metrics, on PyTorch.

Port of the JAX package's single-device ``annchor.py``:

  anchors -> locality -> features -> [sample -> regress -> errors ->
  refine -> tighten]*niters -> graph [-> graph-expansion refinement]

The orchestration is a staged host loop, as in the JAX package.  With
the default strategy objects the per-pair state lives on one torch
device (``ops/device_pipeline.py``).  Above 4,096 points (or with the
``ANNCHOR_TPU_FORCE_SPARSE`` test hook) that is the scale path: the pair
build keeps the pair list on the device (the budgeted band build for
metric fits, the admit-everything build for non-metric fits, hybrids
included), the state runs in sparse mode, and a share of the budget is
held back for the graph-expansion refinement (``refine.py``).  Any custom sampler,
regression or error predictor takes the host pipeline, whose per-pair
state is host numpy, as the JAX package's, and whose per-pair passes
(``ops/features``, ``ops/pairs``, ``ops/bounds_update``) run as torch on
the fit's device.  Every metric evaluation goes through the evaluator
``get_exact_ijs``; for the Levenshtein metric on a CUDA device that is
the hand-written pair kernel.  A metric with a scout (``wasserstein``
with ``scout="sinkhorn"``) runs the scout/certify hybrid: the search
evaluates the cheap scout, and ``_certify`` re-ranks the reported graph
with the exact metric.  A fitted index serves out-of-sample queries
(``query.py``), is saved and loaded in the JAX package's file formats
(``io.py``), and gives the nearest-enemy graph and the selective
subsets (``enemies.py``).  The fit runs on one device; the multi-device
fit is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from annchor_tpu_torch import parallel, trace
from annchor_tpu_torch._backend import resolve_device, synchronize
from annchor_tpu_torch.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu_torch.metrics import (
    get_function_from_input,
    make_get_exact_ijs,
    make_get_exact_query_ijs,
    test_parallelisation,
)
from annchor_tpu_torch.ops import pairs as pair_ops
from annchor_tpu_torch.ops.bounds_update import tighten_bounds
from annchor_tpu_torch.ops.device_pipeline import DeviceFitState, host_pairs
from annchor_tpu_torch.ops.features import bounds_and_dad
from annchor_tpu_torch.ops.locality import (
    DENSE_MAX_NX,
    candidate_pairs,
    candidate_pairs_device,
    candidate_pairs_device_budgeted,
)
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


def _state_view(own, of_state):
    """A property that reads ``of_state(self._dev)`` while the fit state
    lives and the attribute ``own`` otherwise; assignment brings the state
    to the host first (``_sync_from_device``) and sets ``own``."""

    def get(self):
        return getattr(self, own) if self._dev is None else of_state(self._dev)

    def put(self, value):
        self._sync_from_device()
        setattr(self, own, value)

    return property(get, put)


def _host_property(attr):
    """A property over ``attr`` that downloads a tensor value to numpy
    once, on first read; assignment stores the value as given."""

    def get(self):
        v = getattr(self, attr)
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
            setattr(self, attr, v)
        return v

    return property(get, lambda self, v: setattr(self, attr, v))


class Annchor:
    """Quickly computes the approximate k-NN graph for slow metrics.

    Parameters mirror the JAX package's (reference annchor.py:26-90):

    X: list or array — the data set.
    func: callable, Metric or string — the metric.  Supported strings:
        euclidean, sqeuclidean, cosine, levenshtein, wasserstein,
        wasserstein_sinkhorn.
    func_kwargs: dict of metric kwargs, bound to a callable metric; the
        Wasserstein metrics take cost_matrix, and wasserstein with
        scout="sinkhorn" fits as the scout/certify hybrid (non-metric,
        every reported distance exact; a user get_exact_ijs turns the
        scout off).
    n_anchors, n_neighbors, n_samples, p_work: budget knobs; p_work is
        the fraction of brute-force metric calls the fit may spend.
    anchor_picker / sampler / regression / error_predictor: duck-typed
        strategy objects (reference annchor.py:150-161).  Custom
        sampler, regression or error predictor objects take the host
        pipeline.
    locality / loc_thresh / loc_min: candidate filter knobs.
    is_metric: False disables triangle-inequality clipping.
    get_exact_ijs: optional user pairwise evaluator
        get_exact_ijs(f, X, IJ) -> np.array([f(X[i], X[j]) ...]).
    backend: worker pool for arbitrary Python metrics (built-in metrics
        use batched engines and ignore it, with a warning): None or
        "threading" -> shared thread pool, "loky" or "multiprocessing"
        -> spawned process pool (the metric must be picklable;
        unpicklable closures fall back to serial).
    niters: refinement iterations.
    lookahead: the host pipeline's refinement over-selection factor;
        the pairs selected beyond the batch are tightened first.
    trace_dir: run ``fit`` under ``torch.profiler`` and write its trace
        there (TensorBoard's trace handler).
    refine_frac / refine_rounds: hold back refine_frac of the p_work
        allowance and spend it after the fit on ``refine_rounds`` rounds
        of graph-expansion refinement (``refine_neighbor_graph``); 0
        reproduces the reference flow.
    pair_cap / pair_cap_factor: the scale path's per-point candidate
        cap, explicit, or derived as max(4 nn, factor * p_work * nx)
        (factor 0.7 by default); the ``ANNCHOR_TPU_PAIR_CAP`` and
        ``ANNCHOR_TPU_PAIR_CAP_FACTOR`` variables override them.
    max_resident_pairs: the admitted-pair bound of the scale path's
        admit-everything build (non-metric fits): above it the build
        switches to the budgeted one (default 10^8; the
        ``ANNCHOR_TPU_MAX_RESIDENT_PAIRS`` variable overrides it).
    device: torch device of the fit state and the metric engine
        ("cuda" by default; "cpu" runs the kernels' plain versions).
    uniforms: optional callable (random_seed, loop_num, m, device) ->
        (m,) float32 tensor in [0, 1), the device sample draw's random
        numbers (default: ``ops.device_pipeline.default_uniforms``).

    Knobs left unset (None) take the reference defaults up to 4,096
    points and the JAX package's scale defaults above: n_anchors =
    max(48, round(0.3 sqrt(nx) / 16) * 16), loc_thresh 3, niters 4,
    refine_frac 0.05 (reference defaults: 20, 1, 2, 0).
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
        backend=None,
        niters=None,
        lookahead=5,
        trace_dir=None,
        refine_frac=None,
        refine_rounds=3,
        pair_cap=None,
        pair_cap_factor=None,
        max_resident_pairs=None,
        device="cuda",
        uniforms=None,
    ):
        with trace.span("construct"):
            self.X = X
            self.nx = len(X)
            self.N = (self.nx * (self.nx - 1)) // 2
            self.device = resolve_device(device)
            self.uniforms = uniforms

            scale = self.nx > DENSE_MAX_NX
            if n_anchors is None:
                n_anchors = (
                    max(48, int(round(0.3 * self.nx**0.5 / 16.0)) * 16) if scale else 20
                )
            locality = 5 if locality is None else locality
            if loc_thresh is None:
                loc_thresh = 3 if scale else 1
            if niters is None:
                niters = 4 if scale else 2
            if refine_frac is None:
                refine_frac = 0.05 if scale else 0.0

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
            self.lookahead = lookahead
            self.refine_frac = float(np.clip(refine_frac, 0.0, 0.9))
            self.refine_rounds = int(refine_rounds)
            self.pair_cap = None if pair_cap is None else int(pair_cap)
            self.pair_cap_factor = (
                None if pair_cap_factor is None else float(pair_cap_factor)
            )
            self.max_resident_pairs = (
                None if max_resident_pairs is None else int(max_resident_pairs)
            )
            self.trace_dir = trace_dir

            self._features = None
            self._RefineApprox = None
            self._ncm = None
            self._P_idx = None
            self._ij_host = self._ij_device = self._P_cnt = None  # while no state owns them
            self._locality_info = None  # the scale path's build and admitted total
            self._S_raw = self._sid_raw = self._loc_eff_raw = None
            self._dev = None  # device-resident state (ops.device_pipeline)
            self._dev_eval = None  # device-id metric eval (fused pipeline)
            self.thresh = None  # host pipeline's per-point thresholds
            self.neighbor_graph = None

            self.backend = backend
            if backend is not None and self.metric.batch is not None:
                print(
                    "Warning: backend=%r is ignored for metric %r — it has "
                    "a batched engine (backend selects the worker pool for "
                    "arbitrary Python metrics only)." % (backend, self.metric.name)
                )
            if get_exact_ijs is None:
                self.get_exact_ijs = make_get_exact_ijs(
                    self.metric, verbose=self.verbose, backend=backend
                )
            else:
                self.get_exact_ijs = get_exact_ijs

            # scout/certify hybrid: when the metric ships a cheap approximate
            # engine, exploration runs on it and only the reported graph is
            # evaluated with the exact metric (``_certify``).  A user-supplied
            # evaluator always wins.
            self.scout_evals = 0
            self.certify_pad = 8
            self.certify_expand_rounds = 2  # scout-screened expansion in _certify
            self.certify_expand_cap = None  # None -> 32 * nx
            self._scouting = False
            scout = getattr(self.metric, "scout", None)
            if scout is not None and getattr(self.get_exact_ijs, "_annchor_default", False):
                self._exact_eval = self.get_exact_ijs

                def scout_eval(f, X, IJ):
                    return scout(X, X, np.asarray(IJ))

                scout_eval._annchor_default = True
                self.get_exact_ijs = scout_eval
                self._scouting = True
                # entropic values carry an O(eps) bias that can break the
                # triangle inequality: the non-metric path (reference
                # annchor.py:73-76)
                self.is_metric = False

            with trace.span("construct.smoke"):
                test_parallelisation(self.get_exact_ijs, self.f, self.X, self.nx, s=20)
            self.get_exact_query_ijs = None

    # -- device-resident state & lazy host mirrors -------------------------
    #
    # With the default strategy objects the per-pair state stays on the
    # device; the host arrays are materialised on first host access
    # (plug-ins, user scripts).  The host pipeline keeps them as plain
    # numpy arrays, which these properties then return and replace.

    def _sync_from_device(self):
        """Bring the fit state to the host and drop it: its host arrays,
        and the pair list and counts it owned."""
        dev = self._dev
        if dev is not None:
            self._features, self._RefineApprox, self._ncm = dev.materialise()
            self._ij_host, self._ij_device, self._P_cnt = (
                dev.ij_host, dev.device_pairs(), dev.P_cnt
            )
            self._dev = None

    @property
    def features(self):
        self._sync_from_device()
        return self._features

    @features.setter
    def features(self, value):
        self._sync_from_device()
        self._features = value

    @property
    def RefineApprox(self):
        self._sync_from_device()
        return self._RefineApprox

    @RefineApprox.setter
    def RefineApprox(self, value):
        self._sync_from_device()
        self._RefineApprox = value

    @property
    def not_computed_mask(self):
        if self._dev is not None:
            return self._dev.ncm_to_host()
        return self._ncm

    @not_computed_mask.setter
    def not_computed_mask(self, value):
        self._sync_from_device()
        self._ncm = value

    # the pair list and its counts: the fit state owns them while it
    # lives, and these views read through it
    _IJs = _state_view("_ij_host", lambda st: st.ij_host)  # None until assembled
    _ij_dev = _state_view("_ij_device", DeviceFitState.device_pairs)
    P_cnt = _state_view("_P_cnt", lambda st: st.P_cnt)

    @property
    def IJs(self):
        """The (m, 2) candidate pair array; a scale-path fit keeps it on
        the device, and the host copy is assembled on first access."""
        if self._dev is not None:
            return self._dev.IJs
        if self._IJs is None and self._ij_dev is not None:
            self._ij_host = host_pairs(*self._ij_dev)
        return self._IJs

    @IJs.setter
    def IJs(self, value):
        self._IJs = value
        self._ij_dev = None

    # the locality by-products stay on the device; host copies on access
    S = _host_property("_S_raw")
    sid = _host_property("_sid_raw")
    loc_eff = _host_property("_loc_eff_raw")

    @property
    def P_idx(self):
        """Padded point-incidence matrix, built on first access when the
        device pipeline kept its own (and not kept while the fit state,
        whose pair list may grow, lives)."""
        if self._P_idx is None:
            P_idx, _ = pair_ops.build_point_index(self.IJs, self.nx, self.device)
            if self._dev is not None:
                return P_idx
            self._P_idx = P_idx
        return self._P_idx

    @P_idx.setter
    def P_idx(self, value):
        self._P_idx = value

    def _device_pipeline_ok(self):
        """The device pipeline bakes the default strategies' numeric
        contracts into its programs; custom strategy objects take the
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
            self.get_exact_query_ijs = make_get_exact_query_ijs(
                self.metric, verbose=self.verbose, backend=self.backend
            )
        return self.get_exact_query_ijs

    def _count(self, n):
        """Count n evaluations of the active evaluator: scout calls
        during a hybrid fit, metric calls otherwise."""
        if self._scouting:
            self.scout_evals += n
        else:
            self.evals += n

    def _eval_pairs(self, IJ):
        """Evaluate pairs through the active evaluator (the scout during a
        hybrid fit), counting them."""
        d = np.asarray(
            self.get_exact_ijs(self.f, self.X, np.asarray(IJ)),
            dtype=np.float64,
        )
        self._count(d.shape[0])
        return d

    def _exact_pairs(self, IJ):
        """Evaluate pairs with the exact metric of a hybrid fit, counting
        them as evals."""
        d = np.asarray(self._exact_eval(self.f, self.X, IJ), dtype=np.float64)
        self.evals += d.shape[0]
        return d

    def _anchor_rows_exact(self, values):
        """Write every anchor pair's exact distance, read from the
        anchor columns D, into the per-pair array ``values`` (in place;
        reference annchor.py:365-372)."""
        m = self.IJs.shape[0]
        for col, a in enumerate(np.asarray(self.A, dtype=int)):
            ids = self.P_idx[a][self.P_idx[a] < m]
            others = self.IJs[ids].sum(axis=1) - a
            values[ids] = self.D[others, col]

    # -- pipeline stages ---------------------------------------------------

    def get_anchors(self):
        """Anchors + (nx, n_anchors) distance columns
        (reference annchor.py:191-206)."""
        self.A, self.D, evals = self.anchor_picker.get_anchors(self)
        self._count(evals)
        # an infinite distance (a vertex outside the anchors' component of
        # a graph metric) would poison every bound and the regression
        bad = np.flatnonzero(~np.isfinite(np.asarray(self.D)).all(axis=1))
        if bad.size:
            raise ValueError(
                "the metric gave non-finite anchor distances for %d points (first: "
                "%s); the fit needs finite distances: for a disconnected graph, "
                "fit each connected component on its own" % (bad.size, bad[:5].tolist())
            )

    def get_locality(self):
        """Candidate pairs from shared near-anchor sets
        (reference annchor.py:208-256), and for the host pipeline the
        padded point-incidence index.  Above 4,096 points, or with
        ``ANNCHOR_TPU_FORCE_SPARSE`` set (a test hook the JAX package
        reads too), the default strategies take the scale path's pair
        build, whose pair list stays on the device; the host pipeline
        takes the blocked ``candidate_pairs`` there."""
        device_ok = self._device_pipeline_ok()
        if device_ok and (
            self.nx > DENSE_MAX_NX or os.environ.get("ANNCHOR_TPU_FORCE_SPARSE")
        ):
            self._budgeted_locality()
        else:
            self._dense_locality(device_ok)
        if (self.P_cnt < self.n_neighbors).any():
            raise Exception(
                "Error: Not enough candidates in pool for all indices.\n"
                + "Try again with higher locality."
            )

    def _budgeted_locality(self):
        """The scale path's pair build (JAX annchor.py:475-561): the
        budgeted build at an explicit cap (``ANNCHOR_TPU_PAIR_CAP``, then
        ``pair_cap``) or, for metric fits, at the cap derived from the
        in-fit budget; non-metric fits (the triangle bound ranks nothing
        there) and ``ANNCHOR_TPU_NO_PAIR_BUDGET`` take the
        admit-everything build, which switches to the budgeted one at the
        derived cap when more than ``max_resident_pairs`` pairs
        (``ANNCHOR_TPU_MAX_RESIDENT_PAIRS``, default 10^8) are admitted.
        ``_locality_info`` records the build taken and the admitted
        total.  The builds are the spans ``locality.admit`` (counts
        ``blocks``, ``admitted``, ``m``, ``switched``) and
        ``locality.budgeted`` (``m``; ``admitted``, ``bands`` from the
        build), inside the admit span when it hands over."""
        env_cap = os.environ.get("ANNCHOR_TPU_PAIR_CAP")
        cap = int(env_cap) if env_cap is not None else (self.pair_cap or 0)
        auto_cap = self._derived_pair_cap()
        info = self._locality_info = {"build": "budgeted", "admitted": None}
        if cap <= 0 and (not self.is_metric or os.environ.get("ANNCHOR_TPU_NO_PAIR_BUDGET")):
            env_res = os.environ.get("ANNCHOR_TPU_MAX_RESIDENT_PAIRS")
            if env_res is not None:
                max_res = int(env_res)
            else:
                max_res = 10**8 if self.max_resident_pairs is None else self.max_resident_pairs
            with trace.device_span("locality.admit", (self.device,)) as sp:
                built = candidate_pairs_device(
                    self.D, self.locality, self.loc_thresh, self.loc_min,
                    verbose=self.verbose, max_resident=max_res, budget_cap=auto_cap,
                    device=self.device, info=info,
                )
                sp.count(admitted=info["admitted"], m=built[2],
                         switched=int(info["build"] == "budgeted"))
        else:
            with trace.device_span("locality.budgeted", (self.device,)) as sp:
                built = candidate_pairs_device_budgeted(
                    self.D, self.locality, self.loc_thresh, self.loc_min,
                    cap if cap > 0 else auto_cap, verbose=self.verbose, device=self.device,
                )
                sp.count(m=built[2])
        ij_i, ij_j, m, self.sid, self.S, self.loc_eff, self.P_cnt = built
        self._IJs = None
        self._ij_dev = (ij_i, ij_j, m)
        self._P_idx = None  # the device pipeline builds its own

    def _pair_cap_factor(self) -> float:
        env = os.environ.get("ANNCHOR_TPU_PAIR_CAP_FACTOR")
        if env is not None:
            return float(env)
        return 0.7 if self.pair_cap_factor is None else self.pair_cap_factor

    def _derived_pair_cap(self) -> int:
        """The scale path's per-point cap when none is given:
        max(4 nn, factor * in-fit p_work * nx * mesh scale)."""
        return max(
            4 * self.n_neighbors,
            int(round(
                self._pair_cap_factor() * self._p_work_fit * self.nx * self._mesh_scale()
            )),
        )

    def _mesh_scale(self) -> int:
        """Shards the fit state will be split over (1 without a mesh).

        The derived pair cap scales with the mesh, so more devices buy
        candidate coverage and not only residency: each shard still holds
        about cap_1 * nx / s pairs, but the tracked set is s times wider.
        An explicit ``ANNCHOR_TPU_PAIR_CAP`` never scales: the sharded fit
        equals the single-device fit bit for bit whenever the two track
        the same pair set."""
        mesh = parallel.auto_mesh(self.device)
        return 1 if mesh is None else int(mesh.size)

    @property
    def _p_work_fit(self):
        """The in-fit share of the eval allowance: refine_frac of p_work
        is held back for the post-fit graph-expansion refinement.  Hybrid
        fits keep the whole allowance: they explore on the scout, and
        ``_certify`` does its own graph expansion."""
        if self._scouting:
            return self.p_work
        return self.p_work * (1.0 - self.refine_frac)

    def _dense_locality(self, device_ok):
        self.IJs, self.sid, self.S, self.loc_eff = candidate_pairs(
            self.D, self.locality, self.loc_thresh, self.loc_min, self.device
        )
        if device_ok:
            # the device pipeline builds its own incidence matrix; the
            # host copy stays lazy (P_idx property)
            self._P_idx = None
            self.P_cnt = (
                np.bincount(self.IJs[:, 0], minlength=self.nx)
                + np.bincount(self.IJs[:, 1], minlength=self.nx)
            ).astype(np.int32)
        else:
            self.P_idx, self.P_cnt = pair_ops.build_point_index(
                self.IJs, self.nx, self.device
            )

    def get_features_IJ(self, IJs, P_idx=None):
        """Per-pair features (reference annchor.py:258-303)."""
        lb, ub, dad = bounds_and_dad(
            self.D, IJs[:, 0], IJs[:, 1], device=self.device
        )
        if len(self.A):
            anchor_set = np.zeros(self.nx, dtype=bool)
            anchor_set[np.asarray(self.A, dtype=int)] = True
            anchors = (
                anchor_set[IJs[:, 0]] | anchor_set[IJs[:, 1]]
            ).astype(np.float64)
        else:
            anchors = np.zeros(IJs.shape[0])
        features = np.stack([lb, ub, dad, anchors], axis=1)
        not_computed_mask = features[:, 3] < 1
        return list(FEATURE_NAMES), features, not_computed_mask

    def get_features(self):
        if self._device_pipeline_ok():
            self.feature_names = list(FEATURE_NAMES)
            pairs = self._ij_device if self._ij_device is not None else self._ij_host
            self._dev = DeviceFitState(
                self.device, self.nx, self.D, self.A, self._P_cnt, pairs, self.is_metric,
                self.n_neighbors,
            )
            # the state owns the pair list and its counts from here on
            self._ij_host = self._ij_device = self._P_cnt = None
            self._dev_eval = self._make_device_eval()
            return
        (
            self.feature_names,
            self.features,
            self.not_computed_mask,
        ) = self.get_features_IJ(self.IJs)

    def _make_device_eval(self):
        """Device-id metric eval for the fused pipeline, or None when the
        user supplied get_exact_ijs (whose call sequence is then part of
        the plug-in contract) or the active engine (the scout during a
        hybrid fit) has no device entry."""
        if not getattr(self.get_exact_ijs, "_annchor_default", False):
            return None
        eng = self.metric.scout if self._scouting else self.metric.batch
        if eng is None or not hasattr(eng, "batch_dev"):
            return None
        if not eng.batch_dev_ready(self.X):
            return None
        X = self.X

        def run(I, J):
            return eng.batch_dev(X, I, J)

        return run

    def get_sample(self):
        """Stratified sample of pairs + their exact distances
        (reference annchor.py:313-343)."""
        if self._dev is not None:
            # default-sampler semantics, drawn on the device
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
                self._count(sample_y.shape[0])
            else:
                self.sample_y = self._eval_pairs(self.sample_ijs)
            return
        (
            self.sample_ixs,
            self.n_samples,
            self.sample_bins,
        ) = self.sampler.sample(
            self.features,
            self.feature_names,
            self.n_samples,
            self.not_computed_mask,
            self.random_seed,
        )
        self.sample_features = self.features[self.sample_ixs]
        self.sample_ijs = self.IJs[self.sample_ixs]
        self.sample_y = self._eval_pairs(self.sample_ijs)
        self.not_computed_mask[self.sample_ixs] = False

    def fit_predict_regression(self):
        """Fit the distance regression, predict every pair and clip it to
        its bounds (reference annchor.py:345-380)."""
        self.regression.fit(
            self.sample_features,
            self.feature_names,
            self.sample_y,
            sample_bins=self.sample_bins,
        )
        if self._dev is not None:
            self.sample_predict = self._dev.regress_update(
                self.regression,
                self.sample_ixs,
                self.sample_y,
                self.sample_features,
            )
            return
        self.pred = self.regression.predict(self.features, self.feature_names)
        self.sample_predict = self.pred[self.sample_ixs]

        ilb = self.feature_names.index("lower bound")
        iub = self.feature_names.index("upper bound")
        self.pred = np.clip(
            self.pred, self.features[:, ilb], self.features[:, iub]
        )
        # without the triangle inequality the anchor-pair rows keep
        # their exact column values
        if not self.is_metric and len(self.A):
            self._anchor_rows_exact(self.pred)

        if self.RefineApprox is None:
            self.RefineApprox = self.pred.copy()
        else:
            self.RefineApprox[self.not_computed_mask] = self.pred[
                self.not_computed_mask
            ]
        self.RefineApprox[self.sample_ixs] = self.sample_y

    def fit_predict_errors(self):
        """Fit the empirical residual CDFs (reference annchor.py:382-393)."""
        self.error_predictor.fit(
            self.sample_features,
            self.feature_names,
            self.sample_y - self.sample_predict,
            sample_bins=self.sample_bins,
        )
        if self._dev is not None:
            return  # per-pair bin labels are computed on the device
        self.errors = self.error_predictor.predict(
            self.features, self.feature_names
        )

    def select_refine_candidate_pairs(self, w=0.5, it=0):
        """Spend the refine budget on the pairs most likely to be true
        k-NN edges (reference annchor.py:395-473)."""
        nn = self.n_neighbors
        n_refine = max(
            int((self._p_work_fit * self.N - self.na - self.n_samples) * w) + 1, 0
        )
        if self._dev is not None:
            self.nextback = np.zeros(0, dtype=np.int64)
            if self._dev_eval is not None:
                self._count(self._dev.select_refine_fused(
                    self.error_predictor, n_refine, nn, it == 0, 3 * nn // 2,
                    self._dev_eval,
                ))
                return
            candidates, cand_IJ = self._dev.select(
                self.error_predictor, n_refine, nn, it == 0, 3 * nn // 2
            )
            if candidates.shape[0]:
                self._dev.apply_exact(candidates, self._eval_pairs(cand_IJ))
            return
        self.thresh = pair_ops.kth_smallest_per_point(
            self.RefineApprox, self.P_idx, nn, self.device
        )
        if it == 0:
            self.RefineApprox = pair_ops.guarantee_nmin(
                self.RefineApprox,
                self.not_computed_mask,
                self.P_idx,
                self.P_cnt,
                3 * nn // 2,
                self.device,
            )

        ncm = self.not_computed_mask
        p = (
            np.maximum(
                self.thresh[self.IJs[ncm, 0]], self.thresh[self.IJs[ncm, 1]]
            )
            - self.RefineApprox[ncm]
        )
        prob = pair_ops.empirical_cdf_probs(
            p, self.errors[ncm], self.error_predictor.errs, self.device
        )

        # the n_refine most probable pairs, from a lookahead-times larger
        # over-selection whose remainder is tightened first next
        if n_refine >= prob.shape[0]:
            candidates = np.arange(prob.shape[0])
            nxt = np.arange(prob.shape[0])
        else:
            if n_refine * self.lookahead >= prob.shape[0]:
                large_part = np.arange(prob.shape[0])
            else:
                large_part = np.argpartition(
                    -prob, n_refine * self.lookahead
                )[: n_refine * self.lookahead]
            argpart = np.argpartition(-prob[large_part], n_refine)
            candidates = large_part[argpart[:n_refine]]
            nxt = large_part[argpart[n_refine:]]

        ncm_ids = np.flatnonzero(ncm)
        self.nextback = ncm_ids[nxt]
        mapback = ncm_ids[candidates]

        exact = self._eval_pairs(self.IJs[mapback])
        self.RefineApprox[mapback] = exact
        self.not_computed_mask[mapback] = False

    def _contender_ids(self):
        """Uncomputed pairs that could still enter a top-k list: their
        lower bound is below the larger endpoint threshold."""
        ncm_ids = np.flatnonzero(self.not_computed_mask)
        lb = self.features[ncm_ids, 0]
        cap = np.maximum(
            self.thresh[self.IJs[ncm_ids, 0]],
            self.thresh[self.IJs[ncm_ids, 1]],
        )
        return ncm_ids[lb < cap]

    def _tighten(self, ids):
        """Tightened (lb, ub) of the pairs ``ids`` on the device."""
        return tighten_bounds(
            self.nx,
            self.IJs,
            self.RefineApprox,
            self.not_computed_mask,
            self.IJs[ids],
            self.features[ids, 0],
            self.features[ids, 1],
            device=self.device,
        )

    def update_anchor_points(self, timeout=10, chunk_size=200000):
        """Bound tightening between iterations: every computed distance
        is a pseudo-anchor for the pending pairs (reference
        annchor.py:475-512, utils.py:304-352).  The host pipeline
        tightens the lookahead over-selection first, then every other
        contender, in chunks, and stops after ``timeout`` seconds of
        wall clock, as the reference does (annchor.py:511)."""
        if self._dev is not None:
            self._dev.tighten()
            return
        contenders = self._contender_ids()
        extra = contenders[
            ~np.isin(contenders, self.nextback, assume_unique=True)
        ]
        todo = np.concatenate([self.nextback, extra])
        if todo.shape[0] == 0:
            return
        start = time.time()
        for s in range(0, todo.shape[0], chunk_size):
            nb = todo[s : s + chunk_size]
            self.features[nb, 0], self.features[nb, 1] = self._tighten(nb)
            if time.time() - start > timeout:
                break

    def finalise_bounds(self, timeout=10):
        """Post-refinement tightening of the never-computed pairs and a
        re-clip of their estimates into the tightened interval, so graph
        assembly ranks them with the best bound information.  Metric
        spaces only: without the triangle inequality the interval is not
        a bound."""
        if not self.is_metric:
            return
        if self._dev is not None:
            self._dev.finalise()
            return
        if self.thresh is None:
            return
        # fresh thresholds: the last refinement batch has landed since
        # select_refine computed them
        self.thresh = pair_ops.kth_smallest_per_point(
            self.RefineApprox, self.P_idx, self.n_neighbors, self.device
        )
        contenders = self._contender_ids()
        if contenders.shape[0] == 0:
            return
        lb_new, ub_new = self._tighten(contenders)
        self.features[contenders, 0] = lb_new
        self.features[contenders, 1] = ub_new
        self.RefineApprox[contenders] = np.clip(
            self.RefineApprox[contenders], lb_new, ub_new
        )

    def _certify(self, ngi, ngd):
        """Exact re-evaluation of the scout-built candidate graph, then
        scout-screened graph expansion (the JAX package's host numpy,
        whose set operations and row ranking run here on ``self.device``:
        the same sorted keys and stable orders).

        Pass 1: the scout selected ``k-1+certify_pad`` candidates per
        point; the exact metric scores the deduplicated candidate edges
        and each row keeps its exact top k-1.

        Expansion: a missed true neighbour is almost always a graph
        neighbour of a found one, but can sit deep in the scout ranking.
        Each round takes the neighbours-of-neighbours of the current exact
        top lists, scout-evaluates them fresh, and exactly evaluates only
        those whose scout value could beat a row's exact kth distance,
        with the admission margin calibrated from the scout-vs-exact
        residuals of the pass-1 edges."""
        with trace.span("certify") as certify:
            nx, nsel = ngi.shape
            kk = self.n_neighbors - 1

            def exact_of(IJ):
                with trace.span("certify.exact", pairs=IJ.shape[0]):
                    return self._exact_pairs(IJ)

            def scout_of(IJ):
                with trace.span("certify.scout", pairs=IJ.shape[0]):
                    return self._eval_pairs(IJ)

            rows = np.repeat(np.arange(nx, dtype=np.int64), nsel)
            cols = ngi.reshape(-1).astype(np.int64)
            valid = (cols >= 0) & (cols != rows)
            key = (np.minimum(rows, cols) * nx + np.maximum(rows, cols))[valid]
            uniq = np.unique(key)
            IJ = np.stack([uniq // nx, uniq % nx], axis=1)
            # queue the scout values of the same edges first, then the exact
            # batch (on a card K12 runs after them on the same stream, else
            # the host solver overlaps them), then download once
            scout_dev = None
            scout = self.metric.scout
            if hasattr(scout, "dispatch"):
                scout_dev, _ = scout.dispatch(self.X, self.X, IJ)
            exact = exact_of(IJ)
            if scout_dev is not None:
                with trace.span("certify.scout_wait", pairs=IJ.shape[0]):
                    scout_d = scout_dev.cpu().numpy().astype(np.float64)
                self.scout_evals += IJ.shape[0]
            else:
                scout_d = scout_of(IJ)
            lo = float(np.quantile(exact - scout_d, 0.001)) - 1e-3

            dev = self.device
            seen = torch.as_tensor(uniq, device=dev)  # sorted, as np.union1d keeps it
            pool_keys = uniq
            pool_vals = exact

            def row_topk():
                """Each row's exact top kk of the pool, (gi, gd) on dev."""
                keys = torch.as_tensor(pool_keys, device=dev)
                vals = torch.as_tensor(pool_vals, device=dev)
                a = keys // nx
                b = keys % nx
                pr = torch.cat([a, b])
                pc = torch.cat([b, a])
                pv = torch.cat([vals, vals])
                order = pair_ops.lexsort_stable((pv, pr))
                pr_s = pr[order]
                starts = torch.searchsorted(pr_s, torch.arange(nx, device=dev))
                rank = torch.arange(pr_s.shape[0], device=dev) - starts[pr_s]
                sel = rank < kk
                gi = torch.full((nx, kk), -1, dtype=torch.int64, device=dev)
                gd = torch.full((nx, kk), float("inf"), dtype=torch.float64, device=dev)
                gi[pr_s[sel], rank[sel]] = pc[order][sel]
                gd[pr_s[sel], rank[sel]] = pv[order][sel]
                return gi, gd

            cap = self.certify_expand_cap
            if cap is None:
                cap = 32 * nx
            rounds = 0
            for _ in range(self.certify_expand_rounds):
                gi, gd = row_topk()
                kth = gd[:, -1].cpu().numpy()
                vi, vj = torch.nonzero(gi >= 0, as_tuple=True)
                j = gi[vi, vj]
                ri = vi.repeat_interleave(kk)
                ci = gi[j].reshape(-1)
                ok = (ci >= 0) & (ci != ri)
                ek = torch.minimum(ri, ci) * nx + torch.maximum(ri, ci)
                found = torch.unique(ek[ok])  # sorted, as np.unique
                # np.setdiff1d(found, seen, assume_unique=True)
                found = found[~torch.isin(found, seen, assume_unique=True)]
                if found.numel() == 0:
                    break
                rounds += 1
                seen = torch.sort(torch.cat([seen, found])).values  # np.union1d
                new = found.cpu().numpy()
                a = new // nx
                b = new % nx
                sdn = scout_of(np.stack([a, b], axis=1))
                margin = sdn + lo - np.maximum(kth[a], kth[b])
                admit = np.flatnonzero(margin <= 0.0)
                if admit.size > cap:
                    admit = admit[np.argpartition(margin[admit], cap)[:cap]]
                if admit.size == 0:
                    continue
                ex = exact_of(np.stack([a[admit], b[admit]], axis=1))
                pool_keys = np.concatenate([pool_keys, new[admit]])
                pool_vals = np.concatenate([pool_vals, ex])
            certify.count(rounds=rounds)
            gi, gd = row_topk()
            return gi.cpu().numpy(), gd.cpu().numpy()

    def get_ann(self):
        """Assemble the k-NN graph, self-prepended
        (reference annchor.py:514-530).  Hybrid fits over-select by
        certify_pad and re-rank the rows with exact distances."""
        nsel = self.n_neighbors - 1
        if self._scouting:
            nsel += self.certify_pad
        if self._dev is not None:
            ngi, ngd = self._dev.knn_graph(nsel)
            ng_exact = self._dev.ng_exact_mask
        else:
            ngi, ngd, pair_ids = pair_ops.knn_from_pairs(
                self.RefineApprox,
                self.IJs,
                self.P_idx,
                self.not_computed_mask,
                nsel,
                self.device,
            )
            m = self.IJs.shape[0]
            ng_exact = (pair_ids < m) & ~self.not_computed_mask[
                np.clip(pair_ids, 0, m - 1)
            ]
        if self._scouting:
            ngi, ngd = self._certify(ngi, ngd)
            ng_exact = np.ones(ngi.shape, dtype=bool)  # every edge certified
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
        times are the device's.  While a ``torch.profiler`` records, the
        fit and each stage are spans (``trace.py``: ``fit``,
        ``fit.<stage>``), which do not synchronise.  With trace_dir set,
        the whole fit runs under ``torch.profiler`` and its trace,
        spans included, is written there."""
        prof = contextlib.nullcontext()
        if self.trace_dir is not None:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(self.trace_dir))
        with prof, trace.span("fit"):
            return self._fit_impl()

    def _fit_impl(self):
        evals_seen = [self.evals]

        def timeit(item, origin, start):
            d_evals = self.evals - evals_seen[0]
            evals_seen[0] = self.evals
            now = time.time()
            print(
                "%40s: %6.3f | %7.3f | %7d evals"
                % (item, now - start, now - origin, d_evals)
            )

        @contextlib.contextmanager
        def stage(name, **counts):
            """A stage's span ``fit.<name>``, with the evaluations it spent
            as counts; with verbose, its row of the stage table, timed to a
            synchronise of the device outside the span."""
            start = time.time()
            evals, scout_evals = self.evals, self.scout_evals
            try:
                with trace.span("fit." + name, **counts) as sp:
                    yield
                    sp.count(evals=self.evals - evals, scout_evals=self.scout_evals - scout_evals)
            finally:
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
            with stage(name):
                fn()

        niters = self.niters
        for it in range(niters):
            with stage("get_sample", it=it):
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

            with stage("fit_predict_regression", it=it):
                self.fit_predict_regression()
            with stage("fit_predict_errors", it=it):
                self.fit_predict_errors()
            with stage("select_refine_candidate_pairs", it=it):
                self.select_refine_candidate_pairs(w=1 / niters, it=it)
            if it < niters - 1:
                with stage("update_anchor_points", it=it):
                    self.update_anchor_points()

        with stage("finalise_bounds"):
            self.finalise_bounds()
        with stage("get_ann"):
            self.get_ann()
        if self.refine_frac > 0 and not self._scouting:
            # the held-back share of p_work goes to graph expansion
            with stage("refine_neighbor_graph"):
                self.refine_neighbor_graph(rounds=self.refine_rounds)

    def refine_neighbor_graph(self, rounds=2, budget=None):
        """Post-fit graph-expansion refinement (``refine.py``): certify
        the reported-but-predicted edges, then spend the rest of the
        budget on triangle-screened 2-hop candidates.  The default
        budget is the unspent p_work allowance."""
        from annchor_tpu_torch.refine import refine_neighbor_graph

        return refine_neighbor_graph(self, rounds=rounds, budget=budget)

    # -- serving: query, persistence, extras --------------------------------

    def query(self, Q, nn=15, p_work=0.3, get_exact_query_ijs=None,
              loc_thresh=None, locality=None, seed_frac=0.5, expand_rounds=3):
        """Query new points against the fitted index (reference
        annchor.py:643-683; ``query.py``).  Returns (indices, distances),
        each (len(Q), nn + 1).

        loc_thresh/locality override the fitted filter knobs for the
        query-side candidates only; seed_frac/expand_rounds split the
        p_work budget between the error-model seed and the graph walk."""
        from annchor_tpu_torch.query import query_

        nq = len(Q)
        limit = ((nq * nn * 3) // 2 - 1 + self.n_anchors * nq) / (nq * self.nx)
        if p_work < limit:
            print("Warning: p_work too low")
            print("Increasing p_work to %5.3f" % limit)
            p_work = limit
        return query_(
            self, Q, nn=nn, p_work=p_work,
            get_exact_query_ijs=get_exact_query_ijs,
            loc_thresh=loc_thresh, locality=locality,
            seed_frac=seed_frac, expand_rounds=expand_rounds,
        )

    def legacy_query(self, Z, k=5, alpha=1.4, beta=1.4, get_exact_query_ijs=None):
        """The older landmark-descent query (reference
        query_functions.py:218-338, unwired there; ``query.py``)."""
        from annchor_tpu_torch.query import legacy_query_

        return legacy_query_(
            self, Z, get_exact_query_ijs=get_exact_query_ijs, k=k, alpha=alpha,
            beta=beta,
        )

    def save(self, path, include_exact=True):
        """Persist the fitted index (``io.py``; the dataset and metric are
        supplied again at load time).  Scale-path fits are saved as v2,
        without the m-sized pair state; include_exact=False drops its
        exact-store dump."""
        from annchor_tpu_torch.io import save_annchor

        save_annchor(self, path, include_exact=include_exact)

    @classmethod
    def load(cls, path, X, func, func_kwargs=None, device="cuda", **kwargs):
        """Rebuild an index saved by ``save`` (by either package) on
        ``device``.  For a v2 checkpoint, rebuild_pairs=True re-runs the
        pair build from the stored anchor columns (no metric calls)."""
        from annchor_tpu_torch.io import load_annchor

        return load_annchor(path, X, func, func_kwargs=func_kwargs, device=device,
                            **kwargs)

    def get_nearest_enemies(self, y, nn=3, loc_min=100):
        """The nn nearest differently-labelled points of every point
        (``enemies.py``)."""
        from annchor_tpu_torch.enemies import get_nearest_enemies

        return get_nearest_enemies(self, y, nn=nn, loc_min=loc_min)

    def annchor_selective_subset(self, y, dne=None, alpha=0):
        """A selective subset for 1-NN classification (``enemies.py``)."""
        from annchor_tpu_torch.enemies import annchor_selective_subset

        return annchor_selective_subset(self, y, dne=dne, alpha=alpha)

    def alpha_rss(self, y, dne=None, alpha=0):
        """The sequential alpha-RSS subset (``enemies.py``)."""
        from annchor_tpu_torch.enemies import alpha_rss

        return alpha_rss(self, y, dne=dne, alpha=alpha)

    def _evaluate_remaining(self):
        """Tiny data sets: the stratified sampler cannot draw on the
        first iteration, but if the whole pool fits the eval budget it
        is evaluated outright (the reference raises here).  Returns
        whether it did so."""
        ncm = np.asarray(self.not_computed_mask)
        remaining = int(ncm.sum())
        budget = int(self._p_work_fit * self.N - self.na)
        if remaining and remaining > budget:
            return False
        ids = np.flatnonzero(ncm).astype(np.int64)
        if self._dev is not None:
            if remaining:
                self._dev.apply_exact(
                    ids, self._eval_pairs(self._dev._pairs_at(ids))
                )
            # the regression predict never ran, so the device RA still
            # holds zeros for the anchor-exact pairs
            self._dev.seed_ra_from_store()
        else:
            # nor did it on the host: RA starts from the anchor columns
            # (the JAX package indexes the unset RefineApprox here)
            if self.RefineApprox is None:
                RA = np.zeros(self.IJs.shape[0])
                self._anchor_rows_exact(RA)
                self.RefineApprox = RA
            if remaining:
                self.RefineApprox[ids] = self._eval_pairs(self.IJs[ids])
                self.not_computed_mask[ids] = False
        print(
            "Warning: nothing to sample — evaluated the remaining %d "
            "candidate pairs exactly." % remaining
        )
        return True

    def to_sparse_matrix(self):
        """k-NN graph as a symmetrised scipy dok_matrix with +eps so
        UMAP 'precomputed' treats stored zeros as edges
        (reference annchor.py:625-641)."""
        from scipy.sparse import dok_matrix

        D = dok_matrix((self.nx, self.nx), dtype=np.float64)
        eps = np.nextafter(0, 1, dtype=np.float64)
        for i, (js, ds) in enumerate(zip(*self.neighbor_graph)):
            for j, d in zip(js, ds):
                D[i, j] = D[j, i] = d + eps
        return D


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
        backend=None,
        device="cuda",
    ):
        self.X = X
        self.nx = len(X)
        self.device = resolve_device(device)
        self.metric = get_function_from_input(func, func_kwargs, self.device)
        self.f = self.metric.scalar
        self.verbose = verbose
        if get_exact_ijs is None:
            self.get_exact_ijs = make_get_exact_ijs(
                self.metric, verbose=verbose, backend=backend
            )
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
