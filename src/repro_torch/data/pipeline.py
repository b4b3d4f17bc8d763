"""Data pipelines: the port's copy of ``repro.data.pipeline``'s jet data
and procedural digits.

``jet_substructure_data`` and ``mnist_like_data`` are deterministic numpy
functions of ``(n, seed)``, so the port and the reference draw identical
arrays.
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


_DIGIT_SEGS = {  # 7-segment-ish encodings for digit rendering
    0: "abcdef", 1: "bc", 2: "abdeg", 3: "abcdg", 4: "bcfg",
    5: "acdfg", 6: "acdefg", 7: "abc", 8: "abcdefg", 9: "abcdfg",
}


def _render_digit(d: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    segs = _DIGIT_SEGS[d]
    ox, oy = rng.integers(2, 8), rng.integers(2, 8)
    w, h = rng.integers(10, 14), rng.integers(14, 18)
    t = 2

    def hline(y0, x0, ln):
        img[y0:y0 + t, x0:x0 + ln] = 1.0

    def vline(y0, x0, ln):
        img[y0:y0 + ln, x0:x0 + t] = 1.0

    if "a" in segs:
        hline(oy, ox, w)
    if "g" in segs:
        hline(oy + h // 2, ox, w)
    if "d" in segs:
        hline(oy + h, ox, w)
    if "f" in segs:
        vline(oy, ox, h // 2)
    if "b" in segs:
        vline(oy, ox + w - t, h // 2)
    if "e" in segs:
        vline(oy + h // 2, ox, h // 2 + t)
    if "c" in segs:
        vline(oy + h // 2, ox + w - t, h // 2 + t)
    img += rng.normal(0, 0.15, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def mnist_like_data(n: int, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Procedural 28x28 10-class digit images (N, 28, 28, 1)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n)
    x = np.stack([_render_digit(int(d), rng) for d in y])
    return x[..., None].astype(np.float32), y.astype(np.int32)
