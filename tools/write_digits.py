"""Write the 1,797 UCI optical-recognition digits (the test split that
sklearn bundles, 8 x 8 images of intensities 0-16) into the port's data
file, so the port's loaders need no sklearn.

    python3 tools/write_digits.py

Writes ``annchor_tpu_torch/data/digits.npz`` with ``images`` uint8
(1797, 64) and ``labels`` uint8 (1797,), read from sklearn's bundled copy
(``sklearn.datasets.load_digits``; no network).
"""

from __future__ import annotations

import os

import numpy as np
from sklearn.datasets import load_digits


def main() -> None:
    d = load_digits()
    images = d.data.astype(np.uint8)
    labels = d.target.astype(np.uint8)
    if not (np.array_equal(images, d.data) and np.array_equal(labels, d.target)):
        raise SystemExit("the digits do not fit uint8")
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "annchor_tpu_torch", "data", "digits.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, images=images, labels=labels)
    print("wrote %s: %s images, %d bytes" % (out, images.shape, os.path.getsize(out)))


if __name__ == "__main__":
    main()
