"""Compiler IR: a netlist with per-neuron variable fan-in (the port's copy
of ``repro.compile.ir``).

The generation-side IRs are rigid: ``LayerTruthTable`` forces one uniform
``(out_features, fan_in)`` shape per layer (what the LUT kernels want) and
``Netlist`` is bus-addressed bits (what the Verilog generator wants).  The
optimization passes need something in between — neurons whose fan-in and
table *shrink independently* as don't-cares are folded, inputs pruned and
duplicates merged.  ``CNet`` is that form: a list of layers, each a list of
``CNeuron``s holding feature-level fan-in indices and a dense truth table
over the bits its inputs actually carry.

Bus widths are **per feature**, not per layer: the cross-layer re-encoding
pass (reencode.py) narrows a feature that only ever carries k < 2^bw
distinct codes down to ``ceil(log2 k)`` bits.  The single source of truth
is the *producing* neuron's ``out_width`` (``None`` = the layer's uniform
``bw_out``); every consumer derives its element widths from the producer
via ``CNet.input_widths``, so index rewires, CSE and DCE never have to
patch width tables.  A neuron's packed entry places element k at bit
offset ``sum(widths of elements 0..k-1)`` (LSB first), and its table holds
exactly ``2^(sum of element widths)`` entries.

Lowering goes both ways:

  * ``CNet.to_tables()``  -> uniform ``LayerTruthTable`` list for the
    table-forward / per-layer and uniform kernel paths.  Per layer every feature is padded up to
    the widest input feature (so the kernels' uniform ``bw_in`` shift-pack
    still applies) and neurons below the layer's max fan-in are padded
    with a duplicate of their first input; padded digits and the entries
    of widened elements are unreachable by construction.
  * ``CNet.to_mixed_tables()`` -> compact ``MixedLayerTables`` list for the
    fused mixed-width kernel (``kernels.lut_network``).  Nothing is
    padded: each neuron keeps its exact per-element widths as a
    per-(neuron, element) shift/width pair and its table stays the compact
    ``2^(sum of element widths)`` entries the passes produced — the fused
    kernel banks exactly the bytes the compiler proved.
  * ``CNet.to_netlist()`` -> exact per-neuron ``Netlist`` for Verilog; no
    padding, each neuron keeps its own (possibly pruned) fan-in width and
    its own (possibly re-encoded, compact) output width — emitted wires
    shrink with the encoding — and the per-entry reachability masks ride
    along for don't-care-aware emission.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.netlist import Netlist, NeuronHBB
from repro_torch.core.truth_table import LayerTruthTable, MixedLayerTables

# Entry sweeps are chunked so 20+-bit fan-ins never materialize the full
# (entries, fan_in) digit matrices at once — the shared budget for every
# whole-table sweep (to_tables expansion, reachability, re-encoding).
ENTRY_CHUNK = 1 << 16


def entry_widths_offsets(widths: np.ndarray) -> np.ndarray:
    """LSB-first bit offsets of each element of a packed entry."""
    w = np.asarray(widths, dtype=np.int64)
    return np.concatenate([np.zeros(1, np.int64), np.cumsum(w)[:-1]])


def entry_digits(entry_ids: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """(E,) packed entries -> (E, fan_in) per-element codes, LSB-first.

    Element k occupies bits [offset_k, offset_k + widths[k]) of the entry,
    where offset_k is the cumulative width of the preceding elements — the
    mixed-width generalization of the uniform ``bw_in * k`` convention.
    """
    w = np.asarray(widths, dtype=np.int64)
    offs = entry_widths_offsets(w)
    return ((entry_ids[:, None] >> offs[None, :])
            & ((np.int64(1) << w) - 1)[None, :])


@dataclasses.dataclass
class CNeuron:
    """One LUT neuron: feature indices into the previous layer + dense table.

    ``reachable`` is a per-entry boolean mask filled in by the reachability
    pass (None means "assume every entry reachable").  Entries with
    ``reachable == False`` are don't-cares: their table values are
    canonicalized copies of reachable entries and any rewrite that preserves
    behaviour on reachable entries is legal.

    ``out_width`` is the bit-width of the codes this neuron emits — set by
    the re-encoding pass when the neuron's reachable output set fits fewer
    bits than the layer's uniform ``bw_out`` (``None``).  Consumers derive
    their element widths from it (``CNet.input_widths``), so the table of a
    neuron reading re-encoded features is dense over the *compact* widths.
    """

    indices: np.ndarray               # (fan_in,) int32, features of prev bus
    table: np.ndarray                 # (2^(sum elem widths),) int32 codes
    reachable: np.ndarray | None = None   # (n_entries,) bool
    out_width: int | None = None          # None -> layer uniform bw_out

    @property
    def fan_in(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_entries(self) -> int:
        return int(self.table.shape[0])


@dataclasses.dataclass
class CLayer:
    """One layer; ``bw_in``/``bw_out`` are the *uniform* (container) widths.

    After re-encoding they are upper bounds: the exact per-feature widths
    live on the producing neurons (``CNeuron.out_width``) and are derived
    via ``CNet.input_widths``.
    """

    neurons: list[CNeuron]
    bw_in: int
    bw_out: int

    @property
    def out_features(self) -> int:
        return len(self.neurons)

    def max_fan_in(self) -> int:
        return max((n.fan_in for n in self.neurons), default=0)

    def out_width_of(self, j: int) -> int:
        n = self.neurons[j]
        return self.bw_out if n.out_width is None else n.out_width


@dataclasses.dataclass
class CNet:
    in_features: int
    layers: list[CLayer]

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_tables(tables: list[LayerTruthTable],
                    in_features: int | None = None) -> "CNet":
        if not tables:
            raise ValueError("need at least one layer of truth tables")
        if in_features is None:
            in_features = int(np.max(tables[0].indices)) + 1
        layers = []
        width = in_features
        for li, tt in enumerate(tables):
            if int(np.max(tt.indices, initial=0)) >= width:
                raise ValueError(
                    f"layer {li} indexes feature "
                    f"{int(np.max(tt.indices))} of a {width}-wide bus")
            if li > 0 and tt.bw_in != tables[li - 1].bw_out:
                raise ValueError(
                    f"layer {li} bw_in={tt.bw_in} != upstream "
                    f"bw_out={tables[li - 1].bw_out}")
            if tt.n_entries != 1 << (tt.fan_in * tt.bw_in):
                raise ValueError(
                    f"layer {li}: {tt.n_entries} entries for "
                    f"fan_in={tt.fan_in} at bw_in={tt.bw_in}")
            neurons = [CNeuron(np.array(tt.indices[j], dtype=np.int32),
                               np.array(tt.table[j], dtype=np.int32))
                       for j in range(tt.out_features)]
            layers.append(CLayer(neurons, tt.bw_in, tt.bw_out))
            width = tt.out_features
        return CNet(in_features, layers)

    @staticmethod
    def from_netlist(nl: Netlist) -> "CNet":
        """Lift a bus-addressed ``Netlist`` back to feature indices.

        Requires the per-layer width metadata that ``build_netlist`` and
        ``to_netlist`` record (``layer_in_widths`` for mixed-width buses,
        ``layer_bw_in`` for uniform ones); hand-built netlists without it
        cannot be optimized (the bit->feature grouping would be ambiguous).
        """
        if nl.layer_bw_in is None and nl.layer_in_widths is None:
            raise ValueError(
                "Netlist lacks layer_bw_in metadata (build it with "
                "netlist.build_netlist, or optimize the LayerTruthTable "
                "list instead)")
        layers = []
        in_features = None
        for li, hbbs in enumerate(nl.layers):
            if nl.layer_in_widths is not None:
                widths = np.asarray(nl.layer_in_widths[li], dtype=np.int64)
            else:
                bw = nl.layer_bw_in[li]
                bus_bits = (nl.in_bits if li == 0 else
                            sum(h.out_bits for h in nl.layers[li - 1]))
                widths = np.full(bus_bits // bw, bw, dtype=np.int64)
            if li == 0:
                in_features = len(widths)
            offs = entry_widths_offsets(widths)
            # bit position -> feature whose group starts there
            start2feat = {int(o): f for f, o in enumerate(offs)}
            bw_in = int(widths.max(initial=1))
            bw_out = max((h.out_bits for h in hbbs), default=0)
            neurons = []
            for h in hbbs:
                bits = [int(b) for b in h.input_bits]
                feats = []
                pos = 0
                while pos < len(bits):
                    f = start2feat.get(bits[pos])
                    w = None if f is None else int(widths[f])
                    if (f is None or bits[pos:pos + w]
                            != [int(offs[f]) + b for b in range(w)]):
                        raise ValueError(
                            f"L{li}N{h.neuron}: input bits are not whole "
                            f"feature groups of the {len(widths)}-feature "
                            "bus")
                    feats.append(f)
                    pos += w
                neurons.append(CNeuron(
                    np.array(feats, dtype=np.int32),
                    np.array(h.table, dtype=np.int32),
                    out_width=(None if h.out_bits == bw_out
                               else h.out_bits)))
            layers.append(CLayer(neurons, bw_in, bw_out))
        return CNet(in_features, layers)

    # -- per-feature bus widths ---------------------------------------------

    def input_widths(self, li: int) -> np.ndarray:
        """Per-feature code widths of layer ``li``'s input bus.

        Layer 0 reads the network input (uniform — the input quantizer is
        the caller's contract and is never re-encoded); every other layer
        reads the previous layer's per-neuron output widths.
        """
        if li == 0:
            return np.full(self.in_features, self.layers[0].bw_in,
                           dtype=np.int64)
        prev = self.layers[li - 1]
        return np.array([prev.out_width_of(j)
                         for j in range(prev.out_features)], dtype=np.int64)

    def elem_widths(self, li: int, n: CNeuron) -> np.ndarray:
        """Per-element input code widths of one neuron of layer ``li``."""
        widths = self.input_widths(li)
        return widths[n.indices] if n.fan_in else np.zeros(0, np.int64)

    # -- lowering -----------------------------------------------------------

    def to_tables(self) -> list[LayerTruthTable]:
        """Uniform per-layer tables (the kernels' / table-forward contract).

        Mixed-width layers are padded to a common element width — the bus's
        widest feature — per layer: each neuron's table is re-indexed from
        its compact mixed-width entries to the uniform packing the kernels'
        ``bw_in * k`` shift expects.  Expanded digit values >= 2^w of a
        w-bit feature can never arrive (the lowered producer still emits
        codes < 2^w), so the expansion is bit-exact by construction; when a
        re-encoding pass lowered the *widest* feature of a bus the whole
        layer's uniform tables shrink accordingly.
        """
        tables = []
        n_layers = len(self.layers)
        in_w = [self.input_widths(li) for li in range(n_layers)]
        u_in = [max(int(w.max(initial=1)), 1) for w in in_w]
        for li, layer in enumerate(self.layers):
            u = u_in[li]
            u_out = u_in[li + 1] if li + 1 < n_layers else layer.bw_out
            fi = max(layer.max_fan_in(), 1)
            n_entries = 1 << (fi * u)
            o = layer.out_features
            idx = np.zeros((o, fi), dtype=np.int32)
            tab = np.empty((o, n_entries), dtype=np.int32)
            uniform_w = np.full(fi, u, np.int64)
            for j, n in enumerate(layer.neurons):
                pad = n.indices[0] if n.fan_in else np.int32(0)
                idx[j, :n.fan_in] = n.indices
                idx[j, n.fan_in:] = pad
                ew = in_w[li][n.indices] if n.fan_in else np.zeros(0,
                                                                   np.int64)
                if (ew == u).all():
                    # trailing padded elements are the high digits of the
                    # packed entry, so tiling repeats the true table and the
                    # padded digits are ignored — bit-exact by construction
                    tab[j] = np.tile(n.table, n_entries // n.n_entries)
                    continue
                # mixed widths: map each uniform-width entry back to the
                # neuron's compact entry (digits of widened elements wrap
                # into the compact range; those entries are unreachable)
                for start in range(0, n_entries, ENTRY_CHUNK):
                    ids = np.arange(start, min(start + ENTRY_CHUNK,
                                               n_entries), dtype=np.int64)
                    digits = entry_digits(ids, uniform_w)
                    compact = np.zeros_like(ids)
                    off = 0
                    for k in range(n.fan_in):
                        w = int(ew[k])
                        compact |= (digits[:, k] & ((1 << w) - 1)) << off
                        off += w
                    tab[j, ids] = n.table[compact]
            tables.append(LayerTruthTable(tab, idx, u, u_out))
        return tables

    def to_mixed_tables(self) -> list[MixedLayerTables]:
        """Compact mixed-width tables (the fused mixed-width kernel).

        The zero-padding lowering: each neuron's table is handed over
        exactly as the passes left it — ``2^(sum of its element widths)``
        entries, dense over the compact per-element widths — together with
        a per-(neuron, element) shift/width pair that generalizes the
        kernels' uniform ``bw_in * k`` shift-pack.  Neurons below the
        layer's max fan-in repeat their first index with element width 0
        (masked to a zero contribution in the kernel), so the only padded
        storage is the tiny index/shift/width metadata, never table
        entries.  ``build_mixed_network_slabs`` row-stacks the result so
        the fused kernel's shared-memory cost equals the netlist's exact
        ``table_bytes()`` accounting.
        """
        out = []
        for li, layer in enumerate(self.layers):
            widths = self.input_widths(li)
            fi = max(layer.max_fan_in(), 1)
            o = layer.out_features
            idx = np.zeros((o, fi), dtype=np.int32)
            shifts = np.zeros((o, fi), dtype=np.int32)
            elem_w = np.zeros((o, fi), dtype=np.int32)
            entry_bits = np.zeros(o, dtype=np.int32)
            tables = []
            for j, n in enumerate(layer.neurons):
                pad = n.indices[0] if n.fan_in else np.int32(0)
                idx[j, :n.fan_in] = n.indices
                idx[j, n.fan_in:] = pad
                ew = (widths[n.indices] if n.fan_in
                      else np.zeros(0, np.int64))
                offs = entry_widths_offsets(ew)
                shifts[j, :n.fan_in] = offs
                shifts[j, n.fan_in:] = int(ew.sum())
                elem_w[j, :n.fan_in] = ew
                entry_bits[j] = int(ew.sum())
                tables.append(n.table.astype(np.int32, copy=True))
            out.append(MixedLayerTables(idx, shifts, elem_w, entry_bits,
                                        tuple(tables)))
        return out

    def to_netlist(self) -> Netlist:
        """Exact per-neuron netlist (the Verilog contract), masks attached.

        Per-feature widths carry through: feature f of layer ``li``'s input
        bus occupies bits [offset_f, offset_f + width_f) where offset_f is
        the cumulative width of features 0..f-1, and each neuron's
        ``out_bits`` is its own (possibly re-encoded) output width — so
        emitted wires shrink to the compact encodings.
        """
        layers = []
        layer_in_widths = []
        for li, layer in enumerate(self.layers):
            widths = self.input_widths(li)
            offs = entry_widths_offsets(widths)
            layer_in_widths.append([int(w) for w in widths])
            hbbs = []
            for j, n in enumerate(layer.neurons):
                bits = [int(offs[f]) + b for f in n.indices
                        for b in range(int(widths[f]))]
                hbbs.append(NeuronHBB(li, j, bits, layer.out_width_of(j),
                                      n.table.copy(),
                                      reachable=(None if n.reachable is None
                                                 else n.reachable.copy())))
            layers.append(hbbs)
        in_bits = int(self.input_widths(0).sum())
        last = self.layers[-1]
        out_bits = sum(last.out_width_of(j)
                       for j in range(last.out_features))
        return Netlist(in_bits, out_bits, layers,
                       layer_bw_in=[lay.bw_in for lay in self.layers],
                       layer_in_widths=layer_in_widths)

    # -- accounting ---------------------------------------------------------

    @property
    def n_neurons(self) -> int:
        return sum(lay.out_features for lay in self.layers)

    @property
    def n_table_entries(self) -> int:
        return sum(n.n_entries for lay in self.layers for n in lay.neurons)

    def table_bytes(self) -> int:
        """Per-neuron packed storage (codes at the minimal int width)."""
        from repro_torch.core.lut_cost import code_width

        return sum(code_width(lay.out_width_of(j)) * n.n_entries
                   for lay in self.layers
                   for j, n in enumerate(lay.neurons))

    def lut_cost(self) -> int:
        """Analytical 6-LUT cost, identical to
        ``lut_cost.netlist_lut_cost(self.to_netlist())`` but with no
        netlist materialization (no table copies)."""
        from repro_torch.core.lut_cost import lut_cost

        total = 0
        for li, lay in enumerate(self.layers):
            widths = self.input_widths(li)
            for j, n in enumerate(lay.neurons):
                in_bits = int(widths[n.indices].sum()) if n.fan_in else 0
                total += lut_cost(max(in_bits, 1), lay.out_width_of(j))
        return total

    def validate(self) -> None:
        width = self.in_features
        for li, lay in enumerate(self.layers):
            widths = self.input_widths(li)
            for n in lay.neurons:
                if n.fan_in and int(n.indices.max()) >= width:
                    raise ValueError(f"layer {li}: index out of range")
                ebits = int(widths[n.indices].sum()) if n.fan_in else 0
                if n.n_entries != 1 << ebits:
                    raise ValueError(f"layer {li}: table size mismatch")
                if n.out_width is not None and not (
                        1 <= n.out_width <= lay.bw_out):
                    raise ValueError(f"layer {li}: out_width out of range")
                if n.reachable is not None and (
                        n.reachable.shape != n.table.shape):
                    raise ValueError(f"layer {li}: reachable mask mismatch")
            if li + 1 < len(self.layers) and (
                    lay.bw_out != self.layers[li + 1].bw_in):
                raise ValueError(f"layer {li}: bw_out/bw_in mismatch")
            width = lay.out_features


def forward_codes(net: CNet, in_codes: np.ndarray) -> np.ndarray:
    """Plain-numpy reference forward over the variable-fan-in IR.

    Independent of the lowering paths on purpose: the tests use it to pin
    ``to_tables`` padding and the plain-torch and CUDA consumers to the same oracle.
    """
    c = np.asarray(in_codes)
    for li, lay in enumerate(net.layers):
        widths = net.input_widths(li)
        out = np.empty((c.shape[0], lay.out_features), dtype=np.int64)
        for j, n in enumerate(lay.neurons):
            entry = np.zeros(c.shape[0], dtype=np.int64)
            off = 0
            for f in n.indices:
                entry |= c[:, int(f)].astype(np.int64) << off
                off += int(widths[int(f)])
            out[:, j] = n.table[entry]
        c = out
    return c
