"""Data pipelines: the port's copy of ``repro.data.pipeline``.

Every generator is a deterministic numpy function of its seed (and, for
``TokenStream``, of the step and the host), so the port and the reference
draw identical arrays, and a restarted or re-sharded job never replays or
skips data.

* ``TokenStream`` — synthetic LM token batches (Zipfian unigrams with a
  copy-back structure, so perplexity is learnable).
* ``jet_substructure_data`` — 16-feature 5-class jet stand-in (paper §6).
* ``mnist_like_data`` — procedural 28x28 digit-like classes (paper §7).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        self.local_batch = self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Per-host slice of the global batch at ``step``; deterministic:
        int32 ``tokens`` and next-token ``labels``, each (local_batch,
        seq_len)."""
        rng = np.random.default_rng((self.seed, step, self.host))
        # Zipf unigram base with a copy-back structure: token[t] often
        # repeats token[t-k] — gives the model something to learn.
        zipf = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        toks = np.minimum(zipf, self.vocab - 1).astype(np.int32)
        k = 1 + (step % 7)
        copy = rng.random((self.local_batch, self.seq_len + 1)) < 0.5
        toks[:, k:][copy[:, k:]] = toks[:, :-k][copy[:, k:]]
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}


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
