"""LogicNet training: the three sparsity regimes of the paper on one loop,
the port of ``repro.core.train``.

* 'apriori'   — fixed random expander masks (never change)
* 'iterative' — per-neuron magnitude pruning, cubic anneal to fan_in
* 'momentum'  — Algorithm 1 sparse-momentum prune/regrow

The loop is the reference's step for step: the same numpy batch indices
(``default_rng(seed).integers(0, n, size=batch)``), the same anneal and
prune schedule, AdamW with the fan-in masks applied to gradients and
updated weights.  BN running statistics ride along the forward pass.  On
the card every sparse layer's forward and input gradient launch the
masked-matmul kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import logicnet as LN
from repro_torch.core import sparsity as SP
from repro_torch.core.layers import SparseLinear
from repro_torch.optim.adamw import AdamWCfg, adamw_update, init_opt_state


@dataclasses.dataclass
class TrainResult:
    model: LN.LogicNet
    losses: list
    accuracy: float


def train_logicnet(cfg: LN.LogicNetCfg, x_train: np.ndarray,
                   y_train: np.ndarray, x_test: np.ndarray,
                   y_test: np.ndarray, *, method: str = "apriori",
                   steps: int = 600, batch: int = 256, lr: float = 1e-2,
                   prune_every: int = 50, prune_rate: float = 0.3,
                   seed: int = 0, device=None,
                   net: LN.LogicNet | None = None) -> TrainResult:
    """Train a LogicNet of ``cfg``; ``device`` defaults to ``cuda``.

    Without ``net`` the network is ``LN.init(cfg, torch.Generator seeded
    seed, mask_seed=seed)``; a given ``net`` (e.g. weights carried from the
    reference) is moved to ``device`` and trained in place.
    """
    if method not in ("apriori", "iterative", "momentum"):
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    if net is None:
        net = LN.init(cfg, torch.Generator().manual_seed(seed),
                      mask_seed=seed, device=dev)
    else:
        net = net.to(dev)
    layer_cfgs = cfg.layer_cfgs()
    sparse = {i: m for i, m in enumerate(net.layers)
              if isinstance(m, SparseLinear)}
    if method == "iterative":
        # start dense; anneal per-neuron counts down to fan_in
        for m in sparse.values():
            m.mask.fill_(1.0)

    opt_cfg = AdamWCfg(lr=lr, weight_decay=0.0, clip_norm=1.0)
    params = dict(net.named_parameters())
    opt_state = init_opt_state(params)
    masks = {f"layers.{i}.w": m.mask for i, m in sparse.items()}

    def mask_fn(name, _params):
        return masks.get(name)

    xt = torch.as_tensor(x_train, dtype=torch.float32, device=dev)
    yt = torch.as_tensor(y_train, device=dev).long()
    n = xt.shape[0]
    losses = []
    rng = np.random.default_rng(seed)
    # Anneal sparsity over the first 60% of training; the remainder is
    # recovery at the final fan-in.
    anneal_end = max(1, int(0.6 * steps))
    prune_every = min(prune_every, max(5, steps // 12))
    net.train()
    for step in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, size=batch)).to(dev)
        nll = LN.loss_fn(net, xt[idx], yt[idx], train=True)
        grads = torch.autograd.grad(nll, list(params.values()))
        adamw_update(opt_cfg, params, dict(zip(params, grads)), opt_state,
                     mask_fn=mask_fn)
        losses.append(nll.detach())

        if method != "apriori" and step > 0 and step % prune_every == 0 \
                and step <= anneal_end + prune_every:
            frac = min(1.0, step / anneal_end)
            with torch.no_grad():
                for i, m in sparse.items():
                    c = layer_cfgs[i]
                    if method == "iterative":
                        new = SP.iterative_prune_mask(m.w, m.mask, c.fan_in,
                                                      frac)
                    else:
                        new = SP.sparse_momentum_step(
                            m.w * m.mask, opt_state["m"][f"layers.{i}.w"],
                            m.mask, c.fan_in, prune_rate)
                    m.mask.copy_(new)
                    # keep pruned weights exactly zero
                    m.w.mul_(m.mask)

    # final hard projection for iterative (guarantee exact fan-in)
    if method == "iterative":
        with torch.no_grad():
            for i, m in sparse.items():
                m.mask.copy_(SP.iterative_prune_mask(
                    m.w, m.mask, layer_cfgs[i].fan_in, 1.0))
                m.w.mul_(m.mask)

    net.eval()
    losses = torch.stack(losses).tolist() if losses else []
    return TrainResult(model=net, losses=losses,
                       accuracy=LN.accuracy(net, x_test, y_test))


def auc_roc_ovr(net: LN.LogicNet, x: np.ndarray,
                y: np.ndarray) -> dict[int, float]:
    """One-vs-rest AUC-ROC per class (Table 6.2 metric), Mann-Whitney U."""
    with torch.no_grad():
        logits = LN.forward(net, x, train=False)
    scores = torch.softmax(logits, dim=-1).cpu().numpy()
    y = np.asarray(y)
    aucs = {}
    for c in range(scores.shape[1]):
        pos = scores[y == c, c]
        neg = scores[y != c, c]
        if len(pos) == 0 or len(neg) == 0:
            aucs[c] = float("nan")
            continue
        order = np.argsort(np.concatenate([pos, neg]), kind="stable")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(order) + 1)
        r_pos = ranks[:len(pos)].sum()
        u = r_pos - len(pos) * (len(pos) + 1) / 2
        aucs[c] = float(u / (len(pos) * len(neg)))
    return aucs
