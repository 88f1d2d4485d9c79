"""Distance regression (reference annchor/regressors.py:18-103).

Per-bin multivariate linear regression predicting true distance from
the bound features.  The reference fits one sklearn LinearRegression
per bin and parallelises prediction with joblib; here fitting is
closed-form least squares (normal equations are 4x4) and prediction is
a single vectorised gather —

    y = sum_b 1[bin==b] * (X @ coef_b + intercept_b)

which jits/shards trivially for large pair counts.  ``predict_tensor``
is the same prediction on float64 tensors, on their device, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SimpleStratifiedLinearRegression"]


class SimpleStratifiedLinearRegression:
    def __init__(
        self,
        reg_feature_names=(
            "lower bound",
            "upper bound",
            "double anchor distance",
        ),
        partition_feature_name="double anchor distance",
        n_partitions=7,
    ):
        self.n_partitions = n_partitions
        self.partition_feature_name = partition_feature_name
        self.reg_feature_names = list(reg_feature_names)
        self.coefs = None
        self.intercepts = None
        self.sample_bins = None

    def _feature_indices(self, feature_names):
        i_part = feature_names.index(self.partition_feature_name)
        i_feats = [
            i
            for i, name in enumerate(feature_names)
            if name in self.reg_feature_names
        ]
        return i_part, i_feats

    def fit(self, sample_features, feature_names, sample_y, sample_bins=None):
        i_part, i_feats = self._feature_indices(feature_names)
        F = sample_features[:, i_part]

        if sample_bins is None:
            n = F.shape[0]
            iq1 = int(n / 100)
            iq3 = int(99 * n / 100)
            q1 = np.partition(F, iq1)[iq1]
            q3 = np.partition(F, iq3)[iq3]
            bins = np.linspace(q1, q3, self.n_partitions - 1)
            self.sample_bins = np.hstack([-np.inf, bins, np.inf])
        else:
            self.n_partitions = sample_bins.shape[0] - 1
            self.sample_bins = sample_bins

        nf = len(i_feats)
        self.coefs = np.zeros((self.n_partitions, nf))
        self.intercepts = np.zeros(self.n_partitions)
        for nbin in range(self.n_partitions):
            mask = (F > self.sample_bins[nbin]) & (
                F <= self.sample_bins[nbin + 1]
            )
            Xb = sample_features[mask][:, i_feats]
            yb = sample_y[mask]
            if Xb.shape[0] == 0:  # empty bin: fall back to global fit
                Xb = sample_features[:, i_feats]
                yb = sample_y
            A = np.concatenate([Xb, np.ones((Xb.shape[0], 1))], axis=1)
            sol, *_ = np.linalg.lstsq(A, yb, rcond=None)
            self.coefs[nbin] = sol[:-1]
            self.intercepts[nbin] = sol[-1]

    def predict(self, features, feature_names):
        i_part, i_feats = self._feature_indices(feature_names)
        X = features[:, i_feats]
        F = features[:, i_part]
        # bin label per pair: same (lo, hi] convention as fit
        labels = np.searchsorted(self.sample_bins[1:-1], F, side="left")
        y = np.einsum("ij,ij->i", X, self.coefs[labels]) + self.intercepts[
            labels
        ]
        return y

    def predict_tensor(self, features, feature_names):
        """``predict`` on a float64 tensor of feature rows, on its device:
        the same bits.  ``features[:, i_feats]`` is a column-major copy,
        for which numpy's ``einsum("ij,ij->i")`` adds each row's products
        one by one into a zeroed output, left to right, with no fused
        multiply-add; so does this, then adds the intercept last."""
        i_part, i_feats = self._feature_indices(feature_names)
        dev = features.device
        edges, coefs, icepts = (
            torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
            for a in (self.sample_bins[1:-1], self.coefs, self.intercepts)
        )
        labels = torch.searchsorted(edges, features[:, i_part].contiguous())
        c = coefs[labels]
        dot = torch.zeros(features.shape[0], dtype=torch.float64, device=dev)
        for k, i in enumerate(i_feats):
            dot = dot + features[:, i] * c[:, k]
        return dot + icepts[labels]
