"""Rows of an array in a ``.npz`` file of the benchmark, as float64.

Spec keys: ``file`` (relative to the checkout's root), ``key`` (the
array), ``n`` (the rows the configuration states; a file holding any
other number is refused, so a configuration never runs quietly on a
different set).
"""

from __future__ import annotations

import os

import numpy as np


def make(spec, root):
    with np.load(os.path.join(root, spec["file"])) as z:
        X = np.ascontiguousarray(z[spec["key"]], dtype=np.float64)
    if X.shape[0] != int(spec["n"]):
        raise ValueError("%s holds %d rows of %r; the configuration states %d" % (
            spec["file"], X.shape[0], spec["key"], spec["n"]))
    return X
