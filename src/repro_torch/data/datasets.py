"""Offline dataset generators for the labeling experiments.

* ``make_classification`` — Guyon-style generator (the paper's own hardness
  sweep uses exactly this family, citing [19]): informative subspace +
  redundant linear combinations + noise features + label flips.
* ``mnist_like`` / ``cifar_like`` — image-dimension stand-ins (784 / 3072
  features) built from class-template Gaussian mixtures, so nothing is
  downloaded. Hardness is controlled by template separation and noise.

The port's own copy of ``src/repro/data/datasets.py``: numpy only, and
bit-identical to it for the same seed.
"""
from __future__ import annotations

import numpy as np


def make_classification(n_samples=2000, n_features=20, n_informative=5,
                        n_classes=2, class_sep=1.0, flip_y=0.01, seed=0):
    rng = np.random.default_rng(seed)
    n_clusters = max(1, 2 // max(n_classes - 1, 1)) * n_classes
    centroids = rng.normal(0, class_sep * 2.0, (n_clusters, n_informative))
    X_inf = np.zeros((n_samples, n_informative))
    y = np.zeros(n_samples, dtype=np.int64)
    per = n_samples // n_clusters
    for c in range(n_clusters):
        lo = c * per
        hi = (c + 1) * per if c < n_clusters - 1 else n_samples
        X_inf[lo:hi] = centroids[c] + rng.normal(0, 1.0,
                                                  (hi - lo, n_informative))
        y[lo:hi] = c % n_classes
    # redundant features: random linear combos of informative ones
    n_red = min(n_informative, max(0, n_features - n_informative))
    A = rng.normal(0, 1, (n_informative, n_red))
    X_red = X_inf @ A
    n_noise = n_features - n_informative - n_red
    X_noise = rng.normal(0, 1, (n_samples, max(n_noise, 0)))
    X = np.concatenate([X_inf, X_red, X_noise], axis=1).astype(np.float32)
    # label noise
    flip = rng.random(n_samples) < flip_y
    y[flip] = rng.integers(0, n_classes, flip.sum())
    # shuffle
    p = rng.permutation(n_samples)
    X, y = X[p], y[p]
    X = (X - X.mean(0)) / (X.std(0) + 1e-6)
    return X, y


def _image_like(n_samples, n_features, n_classes, sep, seed):
    rng = np.random.default_rng(seed)
    templates = rng.normal(0, sep, (n_classes, n_features))
    y = rng.integers(0, n_classes, n_samples)
    X = templates[y] + rng.normal(0, 1.0, (n_samples, n_features))
    return X.astype(np.float32), y.astype(np.int64)


def mnist_like(n_samples=4000, seed=0):
    """784-feature 10-class stand-in (MNIST dims), moderately easy."""
    return _image_like(n_samples, 784, 10, sep=0.12, seed=seed)


def cifar_like(n_samples=4000, seed=0):
    """3072-feature binary stand-in (CIFAR birds/airplanes dims), harder."""
    return _image_like(n_samples, 3072, 2, sep=0.06, seed=seed)


def train_test_split(X, y, test_frac=0.25, seed=0):
    rng = np.random.default_rng(seed + 99)
    p = rng.permutation(len(y))
    n_test = int(len(y) * test_frac)
    te, tr = p[:n_test], p[n_test:]
    return X[tr], y[tr], X[te], y[te]
