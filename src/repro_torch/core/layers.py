"""LogicNets layer types (paper §4.2–§4.3) as ``nn.Module``s: the port of
``repro.core.layers``'s BatchNorm, SparseLinear and DenseQuantLinear.

Every layer has an implicit input quantizer.  Weights keep the reference's
``(in_features, out_features)`` layout, so carried weights need no
transpose and the masked-matmul kernel takes ``(K, N)`` as it is.  Fan-in
masks and batch-norm running statistics are buffers, never parameters:
the optimizer cannot touch them.

``SparseConv`` (§4.4) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import lut_cost as lc
from repro_torch.core import sparsity
from repro_torch.core.quantize import QuantizerCfg, quantize
from repro_torch.kernels.masked_matmul import MaskedMatmulFn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class BatchNorm(nn.Module):
    """Per-feature batch norm over the batch axis, as the reference writes it.

    Not ``nn.BatchNorm1d``: the reference normalises with, and tracks, the
    biased batch variance (``jnp.var``), where ``BatchNorm1d`` tracks the
    unbiased one.  In training mode the running statistics are updated in
    place with momentum 0.1.
    """

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            n = x.shape[0]
            mean = x.sum(0) / n
            var = (x - mean).square().sum(0) / n
            with torch.no_grad():
                self.mean.copy_((1 - BN_MOMENTUM) * self.mean
                                + BN_MOMENTUM * mean)
                self.var.copy_((1 - BN_MOMENTUM) * self.var
                               + BN_MOMENTUM * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + BN_EPS)
        return y * self.scale + self.bias

    def eval_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The per-feature affine that truth tables fold into a neuron."""
        scale = self.scale.detach() * torch.rsqrt(self.var + BN_EPS)
        return scale, self.bias.detach() - self.mean * scale


@dataclasses.dataclass(frozen=True)
class SparseLinearCfg:
    in_features: int
    out_features: int
    fan_in: int                      # per-neuron synapse count (X)
    bw_in: int                       # input quantizer bit-width (BW)
    max_val_in: float = 2.0
    use_bn: bool = True

    @property
    def in_quant(self) -> QuantizerCfg:
        return QuantizerCfg(self.bw_in, self.max_val_in)

    @property
    def fan_in_bits(self) -> int:
        return self.fan_in * self.bw_in

    def luts(self, bw_out: int) -> int:
        """Analytical LUT cost of this layer for a bw_out-bit output (§4.2)."""
        return lc.sparse_linear_cost(self.out_features, self.fan_in,
                                     self.bw_in, bw_out)


class SparseLinear(nn.Module):
    """Input-quantize -> masked linear -> BN.

    The masked product runs through :class:`MaskedMatmulFn`: on the card
    its forward and input gradient launch the masked-matmul kernel.  With a
    ``generator`` the weights are drawn N(0, 1/fan_in) from it; without,
    they start at zero (to be overwritten, e.g. by carried weights).  The
    mask is the a-priori expander mask of ``mask_seed``.
    """

    def __init__(self, cfg: SparseLinearCfg,
                 generator: torch.Generator | None = None,
                 mask_seed: int = 0):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.in_features, cfg.out_features)
        w = (torch.randn(shape, generator=generator)
             / max(cfg.fan_in, 1) ** 0.5 if generator is not None
             else torch.zeros(shape))
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(cfg.out_features))
        self.bn = BatchNorm(cfg.out_features)
        self.register_buffer("mask", sparsity.apriori_mask(
            mask_seed, cfg.in_features, cfg.out_features, cfg.fan_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qt = quantize(self.cfg.in_quant, x)
        y = MaskedMatmulFn.apply(qt.value.contiguous(), self.w, self.mask,
                                 self.b)
        return self.bn(y) if self.cfg.use_bn else y


@dataclasses.dataclass(frozen=True)
class DenseQuantLinearCfg:
    in_features: int
    out_features: int
    bw_in: int
    max_val_in: float = 2.0
    bw_weight: int = 4               # for the eq. 4.1 cost model
    use_bn: bool = True

    @property
    def in_quant(self) -> QuantizerCfg:
        return QuantizerCfg(self.bw_in, self.max_val_in)

    def luts(self) -> float:
        return lc.dense_quant_linear_cost(self.out_features, self.in_features,
                                          self.bw_in, self.bw_weight)


class DenseQuantLinear(nn.Module):
    """Input-quantize -> dense linear -> BN (the usual final layer).

    The dense product is a plain ``torch.matmul``, as the reference leaves
    it to XLA.
    """

    def __init__(self, cfg: DenseQuantLinearCfg,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.in_features, cfg.out_features)
        w = (torch.randn(shape, generator=generator) / cfg.in_features ** 0.5
             if generator is not None else torch.zeros(shape))
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(cfg.out_features))
        self.bn = BatchNorm(cfg.out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qt = quantize(self.cfg.in_quant, x)
        y = qt.value @ self.w + self.b
        return self.bn(y) if self.cfg.use_bn else y
