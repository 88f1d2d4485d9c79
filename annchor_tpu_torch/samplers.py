"""Samplers: choose the training pairs for the distance regression
(capability parity with reference annchor/samplers.py).

Only the default strategy is ported: the draw itself runs on the
device (``ops/device_pipeline.DeviceFitState.draw_sample``), and the
sampler contributes its budget plan and its per-iteration counter.
"""

from __future__ import annotations

__all__ = ["NothingToSample", "SimpleStratifiedSampler"]


class NothingToSample(Exception):
    pass


class SimpleStratifiedSampler:
    """Linear bins spanning the 1%–99% feature quantiles, widening to
    10%–90% (then shrinking n_samples) when the tails are too thin to
    fill every bin."""

    def __init__(
        self, partition_feature_name="double anchor distance", n_partitions=7
    ):
        self.partition_feature_name = partition_feature_name
        self.n_partitions = n_partitions
        self.loop_num = 0

    def plan(self, pool, n_samples):
        """Quantile indices + budget adjustment for a pool of the given
        size (the device draw computes the order statistics)."""
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
