"""annchor_tpu_torch: the PyTorch/CUDA port of annchor_tpu.

Approximate k-NN graphs for slow metrics, with the per-pair fit state on
one torch device and every edit distance computed by a hand-written CUDA
kernel (``csrc/levenshtein_myers.cu``) on an NVIDIA card, or by its
plain PyTorch version when ``device="cpu"``.

Ported so far: the dense (nx <= 4096) Levenshtein fit with the default
strategies, ``BruteForce`` and ``compare_neighbor_graphs``.  This
package imports neither ``jax`` nor ``annchor_tpu``.
"""

from annchor_tpu_torch.annchor import Annchor, BruteForce, compare_neighbor_graphs
from annchor_tpu_torch.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu_torch.metrics import Metric, get_function_from_input
from annchor_tpu_torch.pickers import (
    ExternalAnchorPicker,
    MaxMinAnchorPicker,
    RandomAnchorPicker,
    SelectedAnchorPicker,
)
from annchor_tpu_torch.regressors import SimpleStratifiedLinearRegression
from annchor_tpu_torch.samplers import NothingToSample, SimpleStratifiedSampler

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
    "SimpleStratifiedSampler",
    "NothingToSample",
    "SimpleStratifiedLinearRegression",
    "SimpleStratifiedErrorRegression",
]
