"""Analytical LUT-cost model (paper §2.1 eqs. 2.1–2.3, §4 eq. 4.1).

The port's copy of the parts of ``repro.core.lut_cost`` that the LogicNet
layers, configs and truth tables need.  All counts are for hardware
building blocks composed solely of 6:1 LUTs — the paper's pessimistic
cost heuristic (actual Vivado synthesis lands 1.6–9.5x lower, Table 5.2).
"""

from __future__ import annotations


def code_width(bits: int) -> int:
    """Bytes of the smallest {1, 2, 4}-byte int holding a ``bits``-bit code."""
    return 1 if bits <= 8 else (2 if bits <= 16 else 4)


def lut_cost_per_bit(n_fan_in_bits: int) -> int:
    """6-LUT count for one output bit of a neuron with N fan-in bits.

    Closed form (2.3): (2^(N-4) - (-1)^N) / 3, valid for N >= 6; any boolean
    function of <= 6 inputs fits a single 6:1 LUT.
    """
    n = int(n_fan_in_bits)
    if n <= 0:
        raise ValueError(f"fan-in bits must be positive, got {n}")
    if n <= 6:
        return 1
    return (2 ** (n - 4) - (-1) ** n) // 3


def lut_cost(n_fan_in_bits: int, m_out_bits: int) -> int:
    """Eq. (2.3): LUT_{N,M} = M * (2^(N-4) - (-1)^N) / 3 (clamped at 1/bit)."""
    return int(m_out_bits) * lut_cost_per_bit(n_fan_in_bits)


def sparse_linear_cost(out_features: int, fan_in: int, bw_in: int,
                       bw_out: int) -> int:
    """LUT cost of a SparseLinear layer: every neuron sees fan_in synapses of
    bw_in bits each and emits bw_out bits."""
    return out_features * lut_cost(fan_in * bw_in, bw_out)


def dense_quant_linear_cost(n_out: int, n_in: int, bw_in: int,
                            bw_wt: int) -> float:
    """Eq. (4.1): LUTS = n(O) * (n(I) * BWin * BWwt * 1.0699 + 10.779)."""
    return n_out * (n_in * bw_in * bw_wt * 1.0699 + 10.779)
