"""Samplers: choose the training pairs for the distance regression
(capability parity with reference annchor/samplers.py).

Stratified over one feature (default "double anchor distance") so the
regression sees the full distance range, not just the bulk.

With the default ``SimpleStratifiedSampler`` a dense fit draws on the
device (``ops/device_pipeline.DeviceFitState.draw_sample``) and the
sampler contributes its budget plan and its per-iteration counter.
Every other sampler runs ``sample`` below on the host: candidates get a
bin label in one searchsorted pass and all bins are drawn at once with
a random-key lexsort from ``np.random.default_rng(random_seed +
loop_num)``, the JAX package's generator, so both packages draw the
same samples.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

__all__ = [
    "NothingToSample",
    "Sampler",
    "SimpleStratifiedSampler",
    "ClusterSampler",
    "SamplingError",
]


class NothingToSample(Exception):
    pass


class SamplingError(Exception):
    pass


def _spanning_order_stats(x, lo, hi):
    """The lo-th and hi-th order statistics of x in one partial sort."""
    lo = int(np.clip(lo, 0, x.shape[0] - 1))
    hi = int(np.clip(hi, lo, x.shape[0] - 1))
    part = np.partition(x, (lo, hi))
    return part[lo], part[hi]


def _edges_from_inner(inner):
    """Bracket interior edges with ±inf to cover the whole line."""
    return np.concatenate(([-np.inf], np.asarray(inner, float), [np.inf]))


def _label_bins(values, edges):
    """Half-open bin label per value: edges[b] <= v < edges[b+1]."""
    return np.searchsorted(edges[1:-1], values, side="right")


def _draw_per_bin(pool_ids, bin_of, quotas, rng):
    """Uniform without-replacement draw of quotas[b] ids from each bin.

    One shuffle-key lexsort groups the pool by bin with random order
    inside each bin; taking the first quotas[b] of each group is then
    an exact per-bin uniform sample.  Returns (chosen_ids, got_per_bin).
    """
    n_bins = quotas.shape[0]
    order = np.lexsort((rng.random(pool_ids.shape[0]), bin_of))
    ranked_bins = bin_of[order]
    starts = np.searchsorted(ranked_bins, np.arange(n_bins + 1))
    avail = np.diff(starts)
    got = np.minimum(avail, quotas)
    # flat positions of each bin's first `got[b]` entries in `order`
    take = np.repeat(starts[:-1], got) + _ramp(got)
    return pool_ids[order[take]], got


def _ramp(counts):
    """[0..counts[0]-1, 0..counts[1]-1, ...] without a Python loop."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    reset = np.zeros(total, dtype=np.int64)
    ends = np.cumsum(counts)[:-1]
    keep = ends < total  # bins ending at `total` have nothing after them
    np.add.at(reset, ends[keep], counts[:-1][keep])
    return np.arange(total) - np.cumsum(reset)


class Sampler(ABC):
    """Base sampler.  Subclasses choose the stratification edges via
    get_partition(sample_feature, n_samples) -> (edges, n_samples');
    the draw itself is shared."""

    def __init__(self, partition_feature_name, n_partitions):
        self.partition_feature_name = partition_feature_name
        self.n_partitions = n_partitions
        self.loop_num = 0

    @abstractmethod
    def get_partition(self, sample_feature, n_samples):
        ...

    def sample_partition(
        self, indices, n_samples, sample_feature, sample_bins, random_seed
    ):
        """Draw ~n_samples ids stratified over sample_bins.  Each bin's
        quota is n_samples/n_bins (first bins absorb the remainder);
        a bin yielding fewer than 2 ids is a stratification failure."""
        n_bins = self.n_partitions
        quotas = np.full(n_bins, n_samples // n_bins, dtype=np.int64)
        quotas[: n_samples % n_bins] += 1

        rng = np.random.default_rng(random_seed + self.loop_num)
        self.loop_num += 1

        bin_of = _label_bins(sample_feature, sample_bins)
        chosen, got = _draw_per_bin(indices, bin_of, quotas, rng)
        if got.min(initial=2) < 2:
            raise SamplingError("Some sampler bins contain too few samples")
        return chosen

    def sample(
        self,
        features,
        feature_names,
        n_samples,
        not_computed_mask,
        random_seed,
    ):
        if not not_computed_mask.any():
            raise NothingToSample()

        col = feature_names.index(self.partition_feature_name)
        # slice the column before masking: copying one column beats
        # copying the whole (m, 4) feature matrix every iteration
        pool_feature = features[:, col][not_computed_mask]
        pool_ids = np.flatnonzero(not_computed_mask)

        sample_bins, adjusted = self.get_partition(pool_feature, n_samples)
        if adjusted != n_samples:
            print(
                "Warning: n_samples has changed from %d to %d."
                % (n_samples, adjusted)
            )
        if adjusted == 0:
            raise NothingToSample()

        try:
            sample_ixs = self.sample_partition(
                pool_ids, adjusted, pool_feature, sample_bins, random_seed
            )
        except SamplingError:
            # degenerate stratification (linspace edges in density gaps
            # of a multimodal feature, or coinciding quantile edges on
            # discrete distances): retry with equal-mass bins, then
            # degrade to a uniform draw — training pairs matter more
            # than strict stratification, so never abort the fit
            print(
                "Warning: stratification bins degenerate; "
                "switching to equal-mass bins."
            )
            pool = pool_feature.shape[0]
            qix = (np.arange(1, self.n_partitions) * pool) // self.n_partitions
            inner = np.sort(pool_feature)[np.clip(qix, 0, pool - 1)]
            sample_bins = _edges_from_inner(inner)
            try:
                sample_ixs = self.sample_partition(
                    pool_ids, adjusted, pool_feature, sample_bins,
                    random_seed,
                )
            except SamplingError:
                print(
                    "Warning: stratification bins degenerate; "
                    "sampling uniformly."
                )
                rng = np.random.default_rng(random_seed + self.loop_num - 1)
                take = min(adjusted, pool_ids.shape[0])
                sample_ixs = rng.choice(pool_ids, size=take, replace=False)
        if adjusted != sample_ixs.shape[0]:
            print("Warning: Some bins contained fewer samples than requested")
        return sample_ixs, sample_ixs.shape[0], sample_bins


class SimpleStratifiedSampler(Sampler):
    """Linear bins spanning the 1%–99% feature quantiles, widening to
    10%–90% (then shrinking n_samples) when the tails are too thin to
    fill every bin."""

    def __init__(
        self, partition_feature_name="double anchor distance", n_partitions=7
    ):
        super().__init__(partition_feature_name, n_partitions)

    def plan(self, pool, n_samples):
        """Quantile indices + budget adjustment for a pool of the given
        size (shared with the device draw, which computes the order
        statistics on the device)."""
        ilo, ihi = pool // 100, (99 * pool) // 100
        if ilo * self.n_partitions < n_samples:
            ilo, ihi = pool // 10, (9 * pool) // 10
        if ilo * self.n_partitions < n_samples:
            n_samples = ilo * self.n_partitions
            print(
                "Warning: n_samples too large for data set size.\n"
                + "Reducing n_samples to %d." % n_samples
            )
        return ilo, ihi, n_samples

    def get_partition(self, sample_feature, n_samples):
        ilo, ihi, n_samples = self.plan(sample_feature.shape[0], n_samples)
        lo, hi = _spanning_order_stats(sample_feature, ilo, ihi)
        inner = np.linspace(lo, hi, self.n_partitions - 1)
        return _edges_from_inner(inner), n_samples


class ClusterSampler(Sampler):
    """Bin edges from a 1-D KMeans clustering of the feature: clusters
    of a 1-D KMeans are contiguous intervals, so the upper endpoint of
    each interval (except the last) is an interior edge.  Needs
    scikit-learn, imported at first use."""

    def __init__(
        self, partition_feature_name="double anchor distance", n_partitions=5
    ):
        super().__init__(partition_feature_name, n_partitions)

    def get_partition(self, sample_feature, n_samples):
        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=self.n_partitions, n_init=10)
        tags = km.fit_predict(sample_feature.reshape(-1, 1))
        # interval upper endpoints, ascending; drop the global max
        tops = np.sort(
            np.array(
                [
                    sample_feature[tags == c].max()
                    for c in range(self.n_partitions)
                ]
            )
        )[:-1]
        return _edges_from_inner(tops), n_samples
