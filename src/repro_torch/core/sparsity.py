"""Per-neuron fan-in sparsity (paper §1.2.2, §3.1.1, Algorithm 1), the port
of ``repro.core.sparsity``.

Every output neuron sees exactly ``fan_in`` inputs, so its truth table
stays enumerable.  Three families: a-priori random expander masks (numpy
``default_rng(seed)``, so the port's masks are the reference's), iterative
magnitude pruning on a cubic schedule, and modified sparse momentum
(per-neuron prune by |w|, regrow by |momentum|).  Also the Erdős–Rényi
layer-sparsity allocation of §3.3.

Masks are (in_features, out_features) float {0, 1} tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def apriori_mask(seed: int, in_features: int, out_features: int,
                 fan_in: int) -> torch.Tensor:
    """Random-expander mask: each output neuron gets ``fan_in`` distinct
    inputs.  float32 (in_features, out_features) on the CPU, exactly
    ``fan_in`` ones per column."""
    if fan_in > in_features:
        raise ValueError(f"fan_in {fan_in} > in_features {in_features}")
    rng = np.random.default_rng(seed)
    mask = np.zeros((in_features, out_features), dtype=np.float32)
    for j in range(out_features):
        idx = rng.choice(in_features, size=fan_in, replace=False)
        mask[idx, j] = 1.0
    return torch.from_numpy(mask)


def mask_to_indices(mask) -> np.ndarray:
    """(out_features, fan_in) int32 input indices per neuron (sorted).

    Requires a uniform per-neuron fan-in; raises otherwise — that is the
    LogicNets invariant.
    """
    m = (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
         else np.asarray(mask))
    counts = m.sum(axis=0).astype(np.int64)
    if counts.size == 0:
        raise ValueError("empty mask")
    if not (counts == counts[0]).all():
        raise ValueError(f"non-uniform per-neuron fan-in: {np.unique(counts)}")
    fan_in = int(counts[0])
    idx = np.zeros((m.shape[1], fan_in), dtype=np.int32)
    for j in range(m.shape[1]):
        idx[j] = np.nonzero(m[:, j])[0]
    return idx


def _per_neuron_topk_mask(score: torch.Tensor, k: int) -> torch.Tensor:
    """Keep, per column (neuron), the ``k`` highest-scoring rows.

    Exact count even with ties (rank by a double stable argsort).
    """
    order = torch.argsort(-score, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True)
    return (ranks < k).to(score.dtype)


def iterative_prune_mask(weights: torch.Tensor, mask: torch.Tensor,
                         target_fan_in: int, frac: float) -> torch.Tensor:
    """One iterative-pruning step (paper Fig. 3.2 pipeline).

    ``frac`` in [0, 1] is training progress; the per-neuron keep count
    decays from in_features (dense) to target_fan_in on a cubic schedule,
    pruning the smallest-magnitude *active* weights per neuron.
    """
    in_features = weights.shape[0]
    frac = float(np.clip(frac, 0.0, 1.0))
    keep = int(round(target_fan_in + (in_features - target_fan_in)
                     * (1.0 - frac) ** 3))
    keep = max(target_fan_in, min(in_features, keep))
    return _per_neuron_topk_mask(weights.abs() * mask, keep)


def sparse_momentum_step(weights: torch.Tensor, momentum: torch.Tensor,
                         mask: torch.Tensor, fan_in: int,
                         prune_rate: float) -> torch.Tensor:
    """Algorithm 1 (modified per-neuron sparse learning), one pruning step.

    Per neuron: prune ``ceil(prune_rate * fan_in)`` smallest-|w| active
    weights and regrow as many inactive weights with the largest
    |momentum|; the fan-in is preserved exactly.
    """
    n_prune = min(int(np.ceil(prune_rate * fan_in)), fan_in)
    keep = fan_in - n_prune
    big = weights.new_full((), float(np.finfo(np.float32).max))
    active_score = torch.where(mask > 0, weights.abs(), -big)
    kept = _per_neuron_topk_mask(active_score, keep)
    inactive_score = torch.where(kept > 0, -big, momentum.abs())
    regrown = _per_neuron_topk_mask(inactive_score, n_prune)
    return torch.clamp(kept + regrown, 0.0, 1.0)


def momentum_ema(momentum: torch.Tensor, grad: torch.Tensor,
                 alpha: float = 0.9) -> torch.Tensor:
    """Exponentially smoothed gradient M^{t+1} = a M^t + (1-a) dE/dW (§3.1.1)."""
    return alpha * momentum + (1.0 - alpha) * grad


def mean_momentum_contributions(momenta: list[torch.Tensor],
                                masks: list[torch.Tensor]) -> torch.Tensor:
    """Normalized mean momentum per layer (tracked for parity, §3.1.1)."""
    means = torch.stack([
        (m * (k > 0)).abs().sum() / torch.clamp((k > 0).sum(), min=1)
        for m, k in zip(momenta, masks)])
    return means / torch.clamp(means.sum(), min=1e-12)


def erdos_renyi_sparsity(layer_dims: list[tuple[int, int]],
                         scale: float = 1.0) -> list[float]:
    """Per-layer sparsity ~ 1 - scale * (n_in + n_out) / (n_in * n_out)."""
    return [float(np.clip(1.0 - scale * (n_in + n_out) / (n_in * n_out),
                          0.0, 1.0))
            for n_in, n_out in layer_dims]


def fan_in_from_sparsity(in_features: int, sparsity: float,
                         minimum: int = 1) -> int:
    """Convert a layer sparsity to the per-neuron fan-in it implies."""
    return max(minimum, int(round(in_features * (1.0 - sparsity))))
