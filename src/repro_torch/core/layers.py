"""LogicNets layer types (paper §4.2–§4.4) as ``nn.Module``s: the port of
``repro.core.layers``'s BatchNorm, SparseLinear, DenseQuantLinear and
SparseConv.

Every layer has an implicit input quantizer.  Weights keep the reference's
layouts (``(in_features, out_features)``; a depthwise kernel ``(k, k,
channels)``, activations NHWC), so carried weights need no transpose and
the masked-matmul kernel takes ``(K, N)`` as it is.  Fan-in masks and
batch-norm running statistics are buffers, never parameters: the
optimizer cannot touch them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.core import lut_cost as lc
from repro_torch.core import sparsity
from repro_torch.core.quantize import QuantizerCfg, quantize
from repro_torch.kernels.masked_matmul import MaskedMatmulFn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class BatchNorm(nn.Module):
    """Per-feature batch norm, features last, as the reference writes it.

    Not ``nn.BatchNorm1d``: the reference normalises with, and tracks, the
    biased batch variance (``jnp.var``), where ``BatchNorm1d`` tracks the
    unbiased one.  Statistics are taken over ``dims``: the batch axis, or
    ``(0, 1, 2)`` for NHWC conv activations.  In training mode the running
    statistics are updated in place with momentum 0.1.
    """

    def __init__(self, features: int, dims: tuple[int, ...] = (0,)):
        super().__init__()
        self.dims = dims
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            n = int(np.prod([x.shape[d] for d in self.dims]))
            mean = x.sum(self.dims) / n
            var = (x - mean).square().sum(self.dims) / n
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


# ---------------------------------------------------------------------------
# SparseConv (§4.4) — sparse quantized depthwise-separable convolution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparseConvCfg:
    in_channels: int
    out_channels: int
    kernel_size: int = 3
    stride: int = 1
    x_k: int = 5                     # depthwise kernel sparsity (synapses)
    x_s: int = 5                     # pointwise sparsity (synapses)
    bw_in: int = 2                   # input quantizer bits
    bw_mid: int = 2                  # intermediate quantizer bits
    max_val_in: float = 2.0
    max_val_mid: float = 2.0
    first_layer: bool = False

    @property
    def in_quant(self) -> QuantizerCfg:
        return QuantizerCfg(self.bw_in, self.max_val_in)

    @property
    def mid_quant(self) -> QuantizerCfg:
        return QuantizerCfg(self.bw_mid, self.max_val_mid)

    @property
    def replicate(self) -> bool:
        # §4.4: first layer with 1 input channel replicates the input to
        # out_channels depthwise kernels (a single sparse 2D kernel cannot
        # extract enough information).
        return self.first_layer and self.in_channels == 1

    @property
    def dw_channels(self) -> int:
        return self.out_channels if self.replicate else self.in_channels

    def luts(self, out_pix: int, o_bits: int) -> tuple[int, int]:
        dw = lc.sparse_conv_dw_cost(out_pix, self.bw_mid, self.dw_channels,
                                    self.x_k, self.bw_in)
        pw = lc.sparse_conv_pw_cost(out_pix, o_bits, self.out_channels,
                                    self.x_s, self.bw_mid)
        return dw, pw


@contextlib.contextmanager
def _float32_convs():
    """cuDNN convolutions in float32 inside the block: on the card cuDNN
    computes float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), about 1e-3 off the reference's
    float32 result.  The caller's setting is restored on exit."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


class _Depthwise(torch.autograd.Function):
    """``F.conv2d(x, weight, stride, groups)`` whose forward and both
    gradients run in float32 (:func:`_float32_convs`): the backward
    convolutions run after the forward's block has closed, so they take
    the same block of their own."""

    @staticmethod
    def forward(ctx, x, weight, stride: int, groups: int):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, groups)
        with _float32_convs():
            return F.conv2d(x, weight, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        stride, groups = ctx.conv
        gx = gw = None
        with _float32_convs():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, weight, gy,
                                                stride=stride, groups=groups)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, weight.shape, gy,
                                                 stride=stride, groups=groups)
        return gx, gw, None, None


def depthwise(x: torch.Tensor, w: torch.Tensor, stride: int,
              replicate: bool) -> torch.Tensor:
    """NHWC depthwise conv, VALID padding: ``x`` (B, H, W, C_in), ``w``
    (k, k, C) -> (B, H', W', C).  ``replicate`` (first-layer rule, §4.4)
    feeds the one input channel to all C kernels, which is a plain
    convolution of that channel with C filters."""
    weight = w.permute(2, 0, 1).unsqueeze(1).contiguous()   # (C, 1, kh, kw)
    groups = 1 if replicate else w.shape[-1]
    y = _Depthwise.apply(x.permute(0, 3, 1, 2), weight, stride, groups)
    return y.permute(0, 2, 3, 1)


class SparseConv(nn.Module):
    """quant -> sparse depthwise -> BN -> quant -> sparse pointwise -> BN,
    on NHWC activations.

    The depthwise kernel is ``(k, k, dw_channels)`` with ``x_k`` taps a
    kernel kept (the a-priori mask of ``mask_seed``), the pointwise weights
    ``(dw_channels, out_channels)`` with ``x_s`` inputs a neuron (``mask_seed
    + 1``), both drawn from ``generator`` (zeros without one).  The
    depthwise conv runs in float32 on every device (:func:`depthwise`); the
    pointwise product is a plain ``torch`` product, as the reference leaves
    its einsum to XLA.
    """

    def __init__(self, cfg: SparseConvCfg,
                 generator: torch.Generator | None = None,
                 mask_seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dw_ch, k = cfg.dw_channels, cfg.kernel_size

        def draw(shape, fan):
            if generator is None:
                return torch.zeros(shape)
            return torch.randn(shape, generator=generator) / float(fan) ** 0.5

        self.w_dw = nn.Parameter(draw((k, k, dw_ch), cfg.x_k))
        self.w_pw = nn.Parameter(draw((dw_ch, cfg.out_channels), cfg.x_s))
        self.b_dw = nn.Parameter(torch.zeros(dw_ch))
        self.b_pw = nn.Parameter(torch.zeros(cfg.out_channels))
        self.bn1 = BatchNorm(dw_ch, dims=(0, 1, 2))
        self.bn2 = BatchNorm(cfg.out_channels, dims=(0, 1, 2))
        self.register_buffer("mask_dw", sparsity.apriori_mask(
            mask_seed, k * k, dw_ch, min(cfg.x_k, k * k)).reshape(k, k,
                                                                  dw_ch))
        self.register_buffer("mask_pw", sparsity.apriori_mask(
            mask_seed + 1, dw_ch, cfg.out_channels, min(cfg.x_s, dw_ch)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        qt = quantize(cfg.in_quant, x)
        h = depthwise(qt.value, self.w_dw * self.mask_dw, cfg.stride,
                      cfg.replicate) + self.b_dw
        h = self.bn1(h)
        qm = quantize(cfg.mid_quant, h)
        y = torch.einsum("bhwc,co->bhwo", qm.value,
                         self.w_pw * self.mask_pw) + self.b_pw
        return self.bn2(y)


_CONV_LEAVES = {"w_dw": ("params", "w_dw"), "w_pw": ("params", "w_pw"),
                "b_dw": ("params", "b_dw"), "b_pw": ("params", "b_pw"),
                "bn1.scale": ("params", "bn1", "scale"),
                "bn1.bias": ("params", "bn1", "bias"),
                "bn2.scale": ("params", "bn2", "scale"),
                "bn2.bias": ("params", "bn2", "bias"),
                "bn1.mean": ("bn_state", "bn1", "mean"),
                "bn1.var": ("bn_state", "bn1", "var"),
                "bn2.mean": ("bn_state", "bn2", "mean"),
                "bn2.var": ("bn_state", "bn2", "var"),
                "mask_dw": ("mask_dw",), "mask_pw": ("mask_pw",)}


def sparse_conv_from_reference(cfg: SparseConvCfg, layer: dict[str, Any],
                               device=None) -> SparseConv:
    """A :class:`SparseConv` holding the reference's ``sparse_conv_init``
    layer dict (params, masks and BN state; arrays of any kind numpy can
    read), on ``device`` (default ``cuda``)."""
    mod = SparseConv(cfg)
    state = mod.state_dict()
    with torch.no_grad():
        for name, path in _CONV_LEAVES.items():
            node = layer
            for key in path:
                node = node[key]
            state[name].copy_(torch.from_numpy(np.array(node, np.float32)))
    return mod.to(resolve_device(device))


def sparse_conv_to_reference(mod: SparseConv) -> dict[str, Any]:
    """The reference's layer dict of a :class:`SparseConv`, numpy arrays."""
    out: dict[str, Any] = {}
    for name, t in mod.state_dict().items():
        node = out
        *path, last = _CONV_LEAVES[name]
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t.detach().cpu().numpy().copy()
    return out
