"""Checkpoint and resume of fitted indexes.

Port of the JAX package's ``io.py``, with its npz keys and dtypes, so a
file written by either package loads in the other.  Two formats:

* **v1** (fits with a host pair list): everything, the m-sized per-pair
  arrays (``IJs``, ``features``, ``RefineApprox``, the not-computed
  mask) included; a loaded index serves queries and the
  nearest-enemy extras as the fitted one does.
* **v2** (scale-path fits, chosen when the fit state is sparse): only
  the serving state -- anchor columns ``D``, the locality by-products,
  the regression and error model, the graph with its per-edge
  exactness, and optionally the exact store as canonical
  (min*nx + max) keys with their float64 values.  ``load(...,
  rebuild_pairs=True)`` re-runs the budgeted band build from ``D`` (no
  metric calls), and ``refine_neighbor_graph`` merges 2-hop candidates
  found in the stored values at no metric cost.

The dataset and the metric are supplied again at load time.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_annchor", "load_annchor"]

_FORMAT = 1
_FORMAT_SPARSE = 2


def _model_payload(ann):
    """Fitted regression and error-model state (both formats)."""
    reg = ann.regression
    ep = ann.error_predictor
    err_labels = np.array(sorted(ep.errs.keys()), dtype=np.int64)
    payload = {
        "reg_coefs": np.asarray(reg.coefs, dtype=np.float64),
        "reg_intercepts": np.asarray(reg.intercepts, dtype=np.float64),
        "reg_bins": np.asarray(reg.sample_bins, dtype=np.float64),
        "err_bins": np.asarray(ep.partition_bins, dtype=np.float64),
        "err_labels": err_labels,
    }
    for k in err_labels:
        payload[f"err_{int(k)}"] = np.asarray(ep.errs[int(k)], dtype=np.float64)
    return payload


def _restore_models(ann, z):
    reg = ann.regression
    reg.coefs = z["reg_coefs"]
    reg.intercepts = z["reg_intercepts"]
    reg.sample_bins = z["reg_bins"]
    reg.n_partitions = reg.coefs.shape[0]

    ep = ann.error_predictor
    ep.partition_bins = z["err_bins"]
    ep.n_partitions = ep.partition_bins.shape[0] - 1
    ep.labels = range(ep.n_partitions)
    ep.errs = {int(k): z[f"err_{int(k)}"] for k in z["err_labels"]}


def _common_payload(ann, fmt):
    ng_exact = getattr(ann, "_ng_exact", None)
    if ng_exact is None:
        ng_exact = np.ones_like(ann.neighbor_graph[0], dtype=bool)
    payload = {
        "format": np.int64(fmt),
        "nx": np.int64(ann.nx),
        "n_anchors": np.int64(ann.n_anchors),
        "n_neighbors": np.int64(ann.n_neighbors),
        "locality": np.int64(ann.locality),
        "loc_thresh": np.int64(ann.loc_thresh),
        "is_metric": np.bool_(ann.is_metric),
        "evals": np.int64(ann.evals),
        # a hybrid fit's scout calls (its evals count the exact calls)
        "scout_evals": np.int64(getattr(ann, "scout_evals", 0)),
        "A": np.asarray(ann.A, dtype=np.int64),
        "D": np.asarray(ann.D, dtype=np.float64),
        "ng_i": np.asarray(ann.neighbor_graph[0], dtype=np.int64),
        "ng_d": np.asarray(ann.neighbor_graph[1], dtype=np.float64),
        # per-edge exactness: refine_neighbor_graph on a loaded index
        # certifies only the predicted edges
        "ng_exact": np.asarray(ng_exact),
        # build and budget knobs: rebuild_pairs must rebuild the pair
        # list the fit tracked, and the post-load budgets key off p_work
        # (caller kwargs still win at load)
        "p_work": np.float64(ann.p_work),
        "refine_frac": np.float64(ann.refine_frac),
        "loc_min": np.int64(ann.loc_min),
        "n_samples": np.int64(ann.n_samples),
        "pair_cap": np.int64(-1 if ann.pair_cap is None else ann.pair_cap),
        "pair_cap_factor": np.float64(
            np.nan if ann.pair_cap_factor is None else ann.pair_cap_factor
        ),
        "max_resident_pairs": np.int64(
            -1 if ann.max_resident_pairs is None else ann.max_resident_pairs
        ),
    }
    payload.update(_model_payload(ann))
    return payload


def save_annchor(ann, path: str, include_exact: bool = True) -> None:
    """Persist a fitted index to ``path`` (.npz).

    A fit whose device state is sparse (the scale path) is saved as v2,
    which never brings the m-sized pair state to the host;
    ``include_exact=False`` drops its exact-store dump."""
    if ann.neighbor_graph is None:
        raise ValueError("save_annchor: fit() has not been run")
    dev = ann._dev
    if dev is None or not dev.sparse:
        payload = _common_payload(ann, _FORMAT)
        payload.update({
            "S": np.asarray(ann.S, dtype=np.float32),
            "IJs": np.asarray(ann.IJs, dtype=np.int32),
            "RefineApprox": np.asarray(ann.RefineApprox, dtype=np.float64),
            "not_computed_mask": np.asarray(ann.not_computed_mask),
            "features": np.asarray(ann.features, dtype=np.float64),
        })
        np.savez_compressed(path, **payload)
        return

    payload = _common_payload(ann, _FORMAT_SPARSE)
    payload["S"] = np.asarray(ann.S, dtype=np.float32)
    payload["sid"] = np.asarray(ann.sid, dtype=np.int32)
    payload["loc_eff"] = np.asarray(ann.loc_eff, dtype=np.int32)
    if include_exact:
        # the refinement batches evaluated on the card join the store
        # first, so the dump holds every computed value
        dev._flush_exacts()
        store = dev.exact
        if store.ids.shape[0]:
            # canonical (min*nx + max) keys survive a pair-list rebuild
            # (pair-row ids would not)
            IJ = dev._pairs_at(store.ids)
            keys = np.minimum(IJ[:, 0], IJ[:, 1]) * ann.nx + np.maximum(IJ[:, 0], IJ[:, 1])
            order = np.argsort(keys, kind="stable")
            payload["exact_keys"] = keys[order]
            payload["exact_vals"] = store.vals[order]
    np.savez_compressed(path, **payload)


def load_annchor(path: str, X, func, func_kwargs=None, rebuild_pairs: bool = False,
                 device="cuda", **kwargs):
    """Rebuild a fitted index from ``path`` on ``device``.

    X and the metric must be those the index was built from (the dataset
    is not stored).  Extra kwargs go to the ``Annchor`` constructor and
    win over the knobs the checkpoint carries.  For a v2 checkpoint,
    ``rebuild_pairs=True`` re-runs the device pair build from the stored
    anchor columns (no metric calls), so the pair list and ``P_cnt``
    exist again."""
    from annchor_tpu_torch.annchor import FEATURE_NAMES, Annchor
    from annchor_tpu_torch.ops import pairs as pair_ops
    from annchor_tpu_torch.ops.locality import effective_thresholds

    z = np.load(path, allow_pickle=False)
    fmt = int(z["format"])
    if fmt not in (_FORMAT, _FORMAT_SPARSE):
        raise ValueError(f"unsupported checkpoint format {fmt}")
    if int(z["nx"]) != len(X):
        raise ValueError(
            f"checkpoint was built from {int(z['nx'])} points, "
            f"got a dataset of {len(X)}"
        )

    # persisted fit and build knobs first, explicit caller kwargs win
    ctor = {}
    if "p_work" in z.files:
        ctor["p_work"] = float(z["p_work"])
        ctor["refine_frac"] = float(z["refine_frac"])
        ctor["loc_min"] = int(z["loc_min"])
        ctor["n_samples"] = int(z["n_samples"])
        if int(z["pair_cap"]) >= 0:
            ctor["pair_cap"] = int(z["pair_cap"])
        if np.isfinite(float(z["pair_cap_factor"])):
            ctor["pair_cap_factor"] = float(z["pair_cap_factor"])
        if int(z["max_resident_pairs"]) >= 0:
            ctor["max_resident_pairs"] = int(z["max_resident_pairs"])
    ctor.update(kwargs)
    ann = Annchor(
        X,
        func,
        func_kwargs=func_kwargs,
        n_anchors=int(z["n_anchors"]),
        n_neighbors=int(z["n_neighbors"]),
        locality=int(z["locality"]),
        loc_thresh=int(z["loc_thresh"]),
        is_metric=bool(z["is_metric"]),
        device=device,
        **ctor,
    )
    ann.A = z["A"]
    ann.D = z["D"]
    ann.S = z["S"]
    ann.neighbor_graph = (z["ng_i"], z["ng_d"])
    if "ng_exact" in z.files:
        ann._ng_exact = z["ng_exact"]
    ann.evals = int(z["evals"])
    if "scout_evals" in z.files:
        ann.scout_evals = int(z["scout_evals"])
    ann.feature_names = list(FEATURE_NAMES)
    _restore_models(ann, z)

    if fmt == _FORMAT:
        ann.IJs = z["IJs"]
        ann.RefineApprox = z["RefineApprox"]
        ann.not_computed_mask = z["not_computed_mask"]
        ann.features = z["features"]
        ann.P_idx, ann.P_cnt = pair_ops.build_point_index(ann.IJs, ann.nx, ann.device)
        # v1 carries no loc_eff, which the nearest-enemy path reads (the
        # JAX package's loaded index fails there, ROADMAP F7): the main
        # filter's thresholds come back from S as the fit computed them
        ann.loc_eff = effective_thresholds(
            ann.S, ann.loc_thresh, ann.loc_min, device=ann.device
        )
        return ann

    # v2: the serving state only
    ann.sid = z["sid"]
    ann.loc_eff = z["loc_eff"]
    if "exact_keys" in z.files:
        ann._exact_keys = z["exact_keys"]
        ann._exact_vals = z["exact_vals"]
    if rebuild_pairs:
        ann.get_locality()
    return ann
