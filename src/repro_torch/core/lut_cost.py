"""Analytical LUT-cost model (paper §2.1 eqs. 2.1–2.3, §4 eqs. 4.1–4.4).

The port's copy of ``repro.core.lut_cost`` but its netlist and SOP costs
(which wait for the port's Verilog backend) and ``table_vmem_bytes`` (a
TPU VMEM figure).  All counts are for hardware building blocks composed
solely of 6:1 LUTs — the paper's pessimistic cost heuristic (actual
Vivado synthesis lands 1.6–9.5x lower, Table 5.2).
"""

from __future__ import annotations

import dataclasses


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


def lut_cost_recursive(n_fan_in_bits: int, m_out_bits: int) -> int:
    """Eq. (2.1) recursion — used to property-test the closed form."""
    n, m = int(n_fan_in_bits), int(m_out_bits)
    if n <= 6:
        return m
    per_bit = lut_cost_recursive(n - 1, m) // m
    return m * (2 * per_bit - (-1) ** n)


@dataclasses.dataclass(frozen=True)
class StaticMappingRow:
    """One row of Table 2.1."""

    fan_in: int
    n_6luts: int
    truth_table_bits: int
    lut_config_bits: int
    pct_utilized: float


def static_mapping_row(fan_in_bits: int) -> StaticMappingRow:
    """Table 2.1: mapping a ``fan_in_bits``:1 truth table onto 6:1 LUTs."""
    n = lut_cost_per_bit(fan_in_bits)
    tt_bits = 2 ** fan_in_bits
    cfg_bits = 64 * n
    return StaticMappingRow(fan_in_bits, n, tt_bits, cfg_bits,
                            100.0 * tt_bits / cfg_bits)


def truth_table_bits(ip_bits: int, op_bits: int) -> int:
    """Storage for the naive LUT of a neuron f: B^ip -> B^op (§3 intro):
    2^ip * (op + ip) bits (the paper stores inputs alongside outputs)."""
    return (2 ** ip_bits) * (op_bits + ip_bits)


def truth_table_output_bits(ip_bits: int, op_bits: int) -> int:
    """Output-only storage, 2^ip * op bits — the §1.2 '4.50e15 bits for a
    fan-in-3 16-bit neuron' accounting."""
    return (2 ** ip_bits) * op_bits


# ---------------------------------------------------------------------------
# Layer-level costs
# ---------------------------------------------------------------------------

def sparse_linear_cost(out_features: int, fan_in: int, bw_in: int,
                       bw_out: int) -> int:
    """LUT cost of a SparseLinear layer: every neuron sees fan_in synapses of
    bw_in bits each and emits bw_out bits."""
    return out_features * lut_cost(fan_in * bw_in, bw_out)


def dense_quant_linear_cost(n_out: int, n_in: int, bw_in: int,
                            bw_wt: int) -> float:
    """Eq. (4.1): LUTS = n(O) * (n(I) * BWin * BWwt * 1.0699 + 10.779)."""
    return n_out * (n_in * bw_in * bw_wt * 1.0699 + 10.779)


def dense_conv_cost(out_pix: int, o_bits: int, n_ofm: int, n_ifm: int,
                    k: int, i_bits: int) -> int:
    """Eq. (4.2): fully-unfolded dense convolution."""
    return out_pix * o_bits * n_ofm * lut_cost_per_bit(n_ifm * k * k * i_bits)


def sparse_conv_dw_cost(out_pix: int, o_bits: int, n_ofm: int, x_k: int,
                        i_bits: int) -> int:
    """Eq. (4.3): depthwise stage; X_k = kernel sparsity (synapse count)."""
    return out_pix * o_bits * n_ofm * lut_cost_per_bit(x_k * i_bits)


def sparse_conv_pw_cost(out_pix: int, o_bits: int, n_ofm: int, x_s: int,
                        i_bits: int) -> int:
    """Eq. (4.4): pointwise stage; X_s = pointwise sparsity (synapse count)."""
    return out_pix * o_bits * n_ofm * lut_cost_per_bit(x_s * i_bits)
