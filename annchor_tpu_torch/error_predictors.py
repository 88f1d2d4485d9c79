"""Empirical error model (capability parity with reference
annchor/error_predictors.py).

Per stratification bin, the fitted artefact is the *sorted array of
residuals* (d - dhat) — an empirical CDF.  "Predict" assigns each pair
its bin label; the refinement step turns a margin p into a probability
with a CDF lookup (the device pipeline samples each bin's CDF onto a
fixed grid, ops.device_pipeline.DeviceFitState._cdf_tables).

Everything here is single-pass vectorised: fit groups all residuals
with one lexsort keyed on (bin, residual); update merges pre-sorted
batches into the stored CDFs without re-sorting them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SimpleStratifiedErrorRegression"]


class SimpleStratifiedErrorRegression:
    def __init__(
        self, partition_feature_name="double anchor distance", n_partitions=7
    ):
        self.n_partitions = n_partitions
        self.partition_feature_name = partition_feature_name
        self.labels = range(n_partitions)
        self.errs = {}
        self.partition_bins = None

    def _default_bins(self, feature):
        """Interior edges spanning the 1%–99% order statistics."""
        pool = feature.shape[0]
        ilo = min(pool // 100, pool - 1)
        ihi = min((99 * pool) // 100, pool - 1)
        part = np.partition(feature, (ilo, ihi))
        inner = np.linspace(part[ilo], part[ihi], self.n_partitions - 1)
        return np.concatenate(([-np.inf], inner, [np.inf]))

    def fit(
        self, sample_features, feature_names, sample_error, sample_bins=None
    ):
        col = feature_names.index(self.partition_feature_name)
        feature = sample_features[:, col]

        if sample_bins is None:
            self.partition_bins = self._default_bins(feature)
        else:
            self.n_partitions = sample_bins.shape[0] - 1
            self.partition_bins = np.asarray(sample_bins)
        self.labels = range(self.n_partitions)

        # one lexsort groups residuals by bin AND sorts within bin
        tags = self.predict(sample_features, feature_names)
        order = np.lexsort((sample_error, tags))
        ranked = sample_error[order]
        cuts = np.searchsorted(tags[order], np.arange(1, self.n_partitions))
        self.errs = dict(enumerate(np.split(ranked, cuts)))

    def predict(self, features, feature_names):
        col = feature_names.index(self.partition_feature_name)
        feature = features[:, col]
        # single searchsorted pass (a per-bin mask loop costs
        # n_partitions full passes over the pair array — noticeable at
        # tens of millions of candidate pairs)
        tags = np.searchsorted(
            self.partition_bins[1:-1], feature, side="right"
        )
        return np.clip(tags, 0, self.n_partitions - 1)

    def update_errors(self, errors, partitions):
        """Fold fresh residuals into the per-bin CDFs.  Near-zero
        residuals (exactly-predicted pairs) carry no information and
        are dropped; each batch is merged, not concatenate-and-sorted."""
        keep = np.abs(errors) > 1e-6
        errors, partitions = errors[keep], partitions[keep]
        for b in np.unique(partitions):
            batch = np.sort(errors[partitions == b])
            have = self.errs.get(int(b), np.zeros(0))
            at = np.searchsorted(have, batch)
            self.errs[int(b)] = np.insert(have, at, batch)
