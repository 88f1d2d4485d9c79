"""annchor_tpu_torch: the PyTorch/CUDA port of annchor_tpu.

Approximate k-NN graphs for slow metrics, with the per-pair fit state on
one torch device (or split over a mesh of them) and every edit distance computed by a hand-written CUDA
kernel (``csrc/levenshtein_myers.cu``) on an NVIDIA card, or by its
plain PyTorch version when ``device="cpu"``.

Ported so far: fits at nx <= 4096 under ``levenshtein``, ``euclidean``,
``sqeuclidean``, ``cosine``, ``wasserstein`` (exact EMD on the card up
to 64 bins, K12, else on the host, with ``scout="sinkhorn"`` the
scout/certify hybrid whose scout runs on the device), ``wasserstein_sinkhorn``, ``GraphShortestPathMetric`` or
any Python callable, with the default strategies (device pipeline) or
custom strategy objects (host pipeline), and above 4,096 points the
scale path for metric fits; ``BruteForce``, the exact oracles
``exact_knn``/``exact_rows``/``exact_query_rows``,
``compare_neighbor_graphs`` and the scalar ``distances``; after a fit,
``query``/``legacy_query``, ``save``/``load`` (the JAX package's file
formats) and the nearest-enemy extras; and the multi-device fit, whose
pair state ``parallel``'s device mesh shards (``ops/sharded_fit.py``).
This package imports neither ``jax`` nor ``annchor_tpu``.
"""

from annchor_tpu_torch import distances, parallel
from annchor_tpu_torch.annchor import Annchor, BruteForce, compare_neighbor_graphs
from annchor_tpu_torch.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu_torch.exact import exact_knn, exact_query_rows, exact_rows
from annchor_tpu_torch.graph_sp import GraphShortestPathMetric
from annchor_tpu_torch.metrics import Metric, get_function_from_input
from annchor_tpu_torch.pickers import (
    ExternalAnchorPicker,
    MaxMinAnchorPicker,
    RandomAnchorPicker,
    SelectedAnchorPicker,
)
from annchor_tpu_torch.regressors import SimpleStratifiedLinearRegression
from annchor_tpu_torch.samplers import (
    ClusterSampler,
    NothingToSample,
    Sampler,
    SimpleStratifiedSampler,
)

__all__ = [
    "Annchor",
    "BruteForce",
    "compare_neighbor_graphs",
    "Metric",
    "get_function_from_input",
    "MaxMinAnchorPicker",
    "RandomAnchorPicker",
    "SelectedAnchorPicker",
    "ExternalAnchorPicker",
    "Sampler",
    "SimpleStratifiedSampler",
    "ClusterSampler",
    "NothingToSample",
    "SimpleStratifiedLinearRegression",
    "SimpleStratifiedErrorRegression",
    "distances",
    "parallel",
    "exact_knn",
    "exact_rows",
    "exact_query_rows",
    "GraphShortestPathMetric",
]
