"""Data pipelines: the port's copy of ``repro.data.pipeline``'s jet data.

``jet_substructure_data`` is a deterministic numpy function of
``(n, seed)``, so the port and the reference draw identical arrays.
"""

from __future__ import annotations

import numpy as np


def jet_substructure_data(n: int, seed: int = 0
                          ) -> tuple[np.ndarray, np.ndarray]:
    """16 expert features -> 5 jet classes (q, g, W, Z, t stand-ins).

    Class-conditional Gaussians with shared covariance structure and
    nonlinear feature interactions; Bayes accuracy ~ high 80s%, like the
    real task's AUC regime.
    """
    rng = np.random.default_rng(seed)
    n_classes, d = 5, 16
    means = rng.normal(0, 1.2, size=(n_classes, d))
    mix = rng.normal(0, 0.3, size=(d, d))
    y = rng.integers(0, n_classes, size=n)
    x = means[y] + rng.normal(0, 1.0, size=(n, d)) @ mix
    # nonlinear touches: jet-mass-like quadratic feature
    x[:, 0] = x[:, 0] + 0.3 * x[:, 1] * x[:, 2]
    x[:, 3] = np.abs(x[:, 3])
    return x.astype(np.float32), y.astype(np.int32)
