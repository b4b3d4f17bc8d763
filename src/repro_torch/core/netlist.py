"""Netlist of Hardware Building Blocks (paper §4 design flow step 3): the
port's copy of ``repro.core.netlist``.

The trained network of Neuron EQuivalents (NEQs) becomes a list of LUT
layers; each neuron is one HBB: (input bit positions on the layer bus,
truth-table entries).  This IR feeds both the Verilog generator and the
lut_lookup serving path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.truth_table import LayerTruthTable


@dataclasses.dataclass
class NeuronHBB:
    """One hardware building block (a configured multi-bit LUT).

    ``reachable`` (optional, set by the compile pipeline) marks which table
    entries can actually occur at runtime; unreachable entries are
    don't-cares that the Verilog generator may fold into a ``default:`` arm.
    """

    layer: int
    neuron: int
    input_bits: list[int]     # positions on the incoming layer bus, LSB first
    out_bits: int
    table: np.ndarray         # (2^len(input_bits),) output codes
    reachable: np.ndarray | None = None   # (2^len(input_bits),) bool
    # minimized two-level cover (repro_torch.synth.SopCover), attached by
    # synth.synthesize_netlist; None = unsynthesized or budget fallback.
    # Exact on reachable entries only — may differ from `table` on
    # don't-cares.
    sop: object | None = None

    @property
    def n_entries(self) -> int:
        return int(self.table.shape[0])


@dataclasses.dataclass
class Netlist:
    in_bits: int                     # width of the input bus M0
    out_bits: int                    # width of the output bus
    layers: list[list[NeuronHBB]]
    # per-layer input code width; recorded by build_netlist (and the compile
    # pipeline's lowering) so the optimizer can lift bus bits back to
    # feature indices.  None on hand-built netlists.
    layer_bw_in: list[int] | None = None
    # per-layer, per-feature input code widths — set by the compile
    # pipeline's lowering once the cross-layer re-encoding pass has narrowed
    # individual bus features below the uniform layer_bw_in.  Feature f of
    # layer l's input bus occupies bits [sum(widths[:f]), sum(widths[:f+1]))
    # of that layer's bus.  None means every feature is layer_bw_in wide.
    layer_in_widths: list[list[int]] | None = None

    @property
    def n_hbbs(self) -> int:
        return sum(len(l) for l in self.layers)

    def table_bytes(self) -> int:
        """Per-neuron packed table storage (minimal {1,2,4}-byte codes)."""
        from repro_torch.core.lut_cost import code_width

        return sum(n.n_entries * code_width(n.out_bits)
                   for layer in self.layers for n in layer)


def build_netlist(tables: list[LayerTruthTable], in_features: int) -> Netlist:
    """Wire LayerTruthTables into a bus-addressed netlist.

    Layer l's input bus packs feature f's code at bits
    [bw_in*f, bw_in*(f+1)) — the convention shared with table_infer.
    """
    layers = []
    bus_features = in_features
    for li, tt in enumerate(tables):
        if li > 0 and bus_features != tables[li - 1].out_features:
            raise ValueError("layer width mismatch")
        neurons = []
        for j in range(tt.out_features):
            bits = []
            for k in range(tt.fan_in):          # element k -> LSB-first
                f = int(tt.indices[j, k])
                bits.extend(tt.bw_in * f + b for b in range(tt.bw_in))
            neurons.append(NeuronHBB(li, j, bits, tt.bw_out, tt.table[j]))
        layers.append(neurons)
        bus_features = tt.out_features
    in_bits = tables[0].bw_in * in_features
    out_bits = tables[-1].bw_out * tables[-1].out_features
    return Netlist(in_bits, out_bits, layers,
                   layer_bw_in=[tt.bw_in for tt in tables])
