"""The 5,620-image digits stand-in: a frozen copy of the program's
``datasets.make_digits_large``, reading the 1,797 UCI test digits from a
``.npz`` file of the benchmark.

Spec keys: ``file`` (relative to the checkout's root), ``key`` (the
images), ``n`` and ``seed`` (of the augmentations).  The stand-in
stands for the whole UCI set, 3,823 train and 1,797 test images: any
other ``n``, or a file of any other number of images, is refused, so a
configuration never runs quietly on a different set.
"""

from __future__ import annotations

import os

import numpy as np

BASE = 1797  # the UCI test split, the file's images
N = 5620  # the whole UCI set


def make(spec, root):
    if int(spec["n"]) != N:
        raise ValueError("the digits stand-in has %d images; the configuration states %d" % (
            N, spec["n"]))
    with np.load(os.path.join(root, spec["file"])) as z:
        base = np.ascontiguousarray(z[spec["key"]], dtype=np.float64)
    if base.shape[0] != BASE:
        raise ValueError("%s holds %d rows of %r; the stand-in augments the %d test digits" % (
            spec["file"], base.shape[0], spec["key"], BASE))
    return augment(base, N, int(spec["seed"]))


def augment(Xb, n, seed):
    """Xb (nb, 64) and n - nb seeded, label-preserving augmentations of
    its images: sub-pixel shifts and small rotations resampled bilinearly
    on the 8 x 8 grid, re-quantised to the 0..16 intensity range."""
    from scipy.ndimage import map_coordinates

    base = Xb.reshape(-1, 8, 8)
    nb = base.shape[0]
    rng = np.random.default_rng(seed)
    extra = n - nb
    src = rng.integers(0, nb, size=extra)
    theta = rng.uniform(-0.15, 0.15, size=extra)  # about +-8.6 degrees
    dx = rng.uniform(-0.7, 0.7, size=extra)
    dy = rng.uniform(-0.7, 0.7, size=extra)
    gy, gx = np.mgrid[0:8, 0:8].astype(np.float64)
    cy = cx = 3.5
    out = np.empty((extra, 8, 8))
    for t in range(extra):
        c, s = np.cos(theta[t]), np.sin(theta[t])
        # inverse map: output pixel -> source coordinate
        sy = cy + c * (gy - cy) + s * (gx - cx) - dy[t]
        sx = cx - s * (gy - cy) + c * (gx - cx) - dx[t]
        out[t] = map_coordinates(base[src[t]], [sy, sx], order=1, mode="constant")
    out = np.clip(np.rint(out), 0, 16)
    return np.concatenate([base.reshape(nb, 64), out.reshape(extra, 64)])
