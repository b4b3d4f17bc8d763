"""Truth-table generation (paper §5.1) and the logic-minimization proxy:
the port of ``repro.core.truth_table``.

A trained SparseLinear neuron with ``fi`` synapses and a ``bi``-bit input
quantizer is a boolean function of ``fi*bi`` bits.  Every one of its
``2^(fi*bi)`` input codes goes through the exact neuron function
(dequantize -> dot(w) + b -> folded BN -> next layer's input quantizer)
and the output code is recorded.  Input element k (the k-th of the
neuron's sorted fan-in indices) occupies bits [bi*k, bi*(k+1)) of the
table index, LSB first — the convention of the LUT kernels.

The enumeration is chunked over table entries and runs on the layer's
device.  Tables are numpy int32 arrays, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import layers as L
from repro_torch.core.lut_cost import lut_cost_per_bit
from repro_torch.core.quantize import QuantizerCfg, codes, dequantize_code
from repro_torch.core.sparsity import mask_to_indices

MAX_FAN_IN_BITS = 24  # enumeration gate; exponential blow-up is fundamental


@dataclasses.dataclass
class LayerTruthTable:
    """Truth tables for one sparse layer.

    table:   (out_features, 2^(fan_in*bw_in)) int32 output codes
    indices: (out_features, fan_in) int32 input feature indices (sorted)
    bw_in:   input quantizer bits (per element)
    bw_out:  output quantizer bits
    """

    table: np.ndarray
    indices: np.ndarray
    bw_in: int
    bw_out: int

    @property
    def out_features(self) -> int:
        return self.table.shape[0]

    @property
    def fan_in(self) -> int:
        return self.indices.shape[1]

    @property
    def n_entries(self) -> int:
        return self.table.shape[1]


@dataclasses.dataclass(frozen=True)
class MixedLayerTables:
    """Compact mixed-width truth tables for one sparse layer.

    The exact-width sibling of ``LayerTruthTable`` that the truth-table
    compiler lowers to: element k of neuron j contributes
    ``(code & (2^elem_widths[j,k] - 1)) << shifts[j,k]`` to its table entry,
    and neuron j's table holds exactly ``2^entry_bits[j]`` codes.

    indices:     (out_features, fan_in_max) int32 input feature indices;
                 padded elements repeat the first index with width 0.
    shifts:      (out_features, fan_in_max) int32 LSB-first bit offsets.
    elem_widths: (out_features, fan_in_max) int32 code widths (0 = pad).
    entry_bits:  (out_features,) int32, ``sum_k elem_widths[j, k]``.
    tables:      per-neuron ``(2^entry_bits[j],)`` int32 output codes.
    """

    indices: np.ndarray
    shifts: np.ndarray
    elem_widths: np.ndarray
    entry_bits: np.ndarray
    tables: tuple[np.ndarray, ...]

    @property
    def out_features(self) -> int:
        return self.indices.shape[0]

    @property
    def fan_in_max(self) -> int:
        return self.indices.shape[1]

    @property
    def n_entries(self) -> int:
        """Total table entries across the layer (the exact slab rows)."""
        return int(sum(t.shape[0] for t in self.tables))


def _entry_digits(entry_ids: torch.Tensor, fan_in: int,
                  bw_in: int) -> torch.Tensor:
    """(E,) table indices -> (E, fan_in) per-element codes (LSB-first)."""
    shifts = bw_in * torch.arange(fan_in, dtype=entry_ids.dtype,
                                  device=entry_ids.device)
    return (entry_ids[:, None] >> shifts[None, :]) & ((1 << bw_in) - 1)


def generate_sparse_linear_table(cfg: L.SparseLinearCfg,
                                 layer: L.SparseLinear,
                                 out_quant: QuantizerCfg,
                                 chunk: int = 1 << 14) -> LayerTruthTable:
    """Enumerate truth tables for every neuron of a SparseLinear layer.

    ``out_quant`` is the *next* module's input quantizer (or the network's
    final output quantizer).  Runs on the layer's device; the chunk's
    ``vals @ wj.T`` is a plain product, as in the reference.
    """
    fi_bits = cfg.fan_in_bits
    if fi_bits > MAX_FAN_IN_BITS:
        raise ValueError(
            f"fan-in {fi_bits} bits exceeds enumeration gate "
            f"({MAX_FAN_IN_BITS}); 2^{fi_bits} entries is infeasible — the "
            "same wall the paper hits on FPGAs")
    idx = mask_to_indices(layer.mask)                       # (O, fi)
    dev = layer.w.device
    with torch.no_grad():
        w = layer.w * layer.mask                            # (I, O)
        wj = w.gather(0, torch.from_numpy(idx.T).long().to(dev)).T  # (O, fi)
        b = layer.b.detach()
        if cfg.use_bn:
            scale, bias = layer.bn.eval_affine()
        else:
            scale, bias = torch.ones_like(b), torch.zeros_like(b)
        in_q = cfg.in_quant
        n_entries = 2 ** fi_bits
        out = np.empty((cfg.out_features, n_entries), dtype=np.int32)
        for start in range(0, n_entries, chunk):
            stop = min(start + chunk, n_entries)
            ids = torch.arange(start, stop, dtype=torch.int32, device=dev)
            digits = _entry_digits(ids, cfg.fan_in, in_q.bit_width)
            vals = dequantize_code(in_q, digits)            # (E, fi)
            pre = vals @ wj.T + b                           # (E, O)
            y = pre * scale + bias
            out[:, start:stop] = codes(out_quant, y).T.cpu().numpy()
    return LayerTruthTable(out, idx, in_q.bit_width, out_quant.bit_width)


def table_as_listing(tt: LayerTruthTable, neuron: int) -> list[list[int]]:
    """Listing 5.1 structure: [[input codes...], [output codes...]]."""
    return [list(range(tt.n_entries)), tt.table[neuron].tolist()]


def minimized_lut_estimate(tt: LayerTruthTable) -> int:
    """Cheap stand-in for Vivado synthesis results (Table 5.2).

    Counts three reductions exactly: constant output bits cost 0 LUTs;
    duplicate neurons (same table and fan-in wires) are built once; and an
    output bit that ignores some input bits has a smaller effective fan-in.
    Returns an estimated 6-LUT count for the layer (<= analytical cost).
    """
    seen: set[bytes] = set()
    total = 0
    for j in range(tt.out_features):
        key = tt.table[j].tobytes() + tt.indices[j].tobytes()
        if key in seen:
            continue
        seen.add(key)
        for bit in range(tt.bw_out):
            col = (tt.table[j] >> bit) & 1
            if col.min() == col.max():
                continue  # constant bit: free
            eff_bits = _effective_fan_in_bits(col, tt.fan_in, tt.bw_in)
            total += lut_cost_per_bit(max(eff_bits, 1))
    return total


def _effective_fan_in_bits(col: np.ndarray, fan_in: int, bw_in: int) -> int:
    """Count input *bits* this single-output-bit function depends on."""
    entries = np.arange(col.shape[0])
    used = 0
    for bit in range(fan_in * bw_in):
        lo = entries[(entries >> bit) & 1 == 0]
        if not np.array_equal(col[lo], col[lo | (1 << bit)]):
            used += 1
    return used
