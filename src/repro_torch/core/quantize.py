"""Activation quantizers (paper §3.1.2, §4.1), the port of ``repro.core.quantize``.

``quantize`` fake-quantizes with a straight-through estimator (STE) and
returns a ``QuantTensor`` (dequantized value, scale, bit width); ``codes``
maps an activation to its integer level and ``dequantize_code`` inverts it
exactly, which is what makes truth-table verification exact.

Both frameworks round half to even.  Two details keep the numbers the
reference's:

* the clip is ``torch.minimum(torch.maximum(x, lo), hi)`` with tensor
  bounds, whose gradient is 0.5 at an exact tie with a bound, as
  ``jnp.clip``'s is (``torch.clamp``'s is 1);
* the step is a 0-dim tensor on ``x``'s device, so ``x / step`` is a true
  division on the card too (a Python or CPU scalar divisor becomes a
  multiplication by its reciprocal there).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class QuantTensor(NamedTuple):
    """Mirror of Brevitas' QuantTensor: dequantized value + scale + bits."""

    value: torch.Tensor
    scale: torch.Tensor
    bit_width: int


@dataclasses.dataclass(frozen=True)
class QuantizerCfg:
    """Configuration of one activation quantizer.

    bit_width == 1  -> QuantHardTanh: output in {-max_val, +max_val}.
    bit_width >= 2  -> QuantReLU: uniform levels {0, ..., 2^b - 1} * step,
                       step = max_val / (2^b - 1).
    """

    bit_width: int
    max_val: float = 1.0

    @property
    def n_levels(self) -> int:
        return 2 ** self.bit_width

    @property
    def step(self) -> float:
        if self.bit_width == 1:
            # two levels: -max_val, +max_val
            return 2.0 * self.max_val
        return self.max_val / (self.n_levels - 1)


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward is exactly ``q``; the gradient is the identity on ``x``."""
    return q + (x - x.detach())


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def quantize(cfg: QuantizerCfg, x: torch.Tensor) -> QuantTensor:
    """Fake-quantize ``x``; the forward value is exactly on the grid."""
    if cfg.bit_width == 1:
        # QuantHardTanh: sign() to +-max_val; the clip bounds the STE region
        clipped = _clip(x, -cfg.max_val, cfg.max_val)
        hi = x.new_full((), cfg.max_val)
        q = torch.where(x.detach() >= 0.0, hi, -hi)
        return QuantTensor(_ste(clipped, q), hi, 1)
    # QuantReLU
    step = x.new_full((), cfg.step)
    clipped = _clip(x, 0.0, cfg.max_val)
    q = torch.round(clipped.detach() / step) * step
    return QuantTensor(_ste(clipped, q), step, cfg.bit_width)


def codes(cfg: QuantizerCfg, x: torch.Tensor) -> torch.Tensor:
    """Integer level of each element of ``x`` after quantization (int32).

    For bit_width 1 the codes are {0, 1} (0 -> -max_val, 1 -> +max_val);
    otherwise {0, ..., 2^b - 1}.
    """
    x = x.detach()
    if cfg.bit_width == 1:
        return (x >= 0.0).to(torch.int32)
    c = torch.round(_clip(x, 0.0, cfg.max_val) / x.new_full((), cfg.step))
    return c.to(torch.int32)


def dequantize_code(cfg: QuantizerCfg, c: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Exact inverse of :func:`codes` onto the quantizer grid."""
    c = c.to(dtype)
    if cfg.bit_width == 1:
        return (2.0 * c - 1.0) * cfg.max_val
    return c * c.new_full((), cfg.step)


def all_codes(cfg: QuantizerCfg) -> torch.Tensor:
    """All integer levels of this quantizer, shape (2^bit_width,)."""
    return torch.arange(cfg.n_levels, dtype=torch.int32)
