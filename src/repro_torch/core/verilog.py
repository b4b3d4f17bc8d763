"""Verilog code generation (paper §5.2, Listings 5.2–5.6): the port's copy
of ``repro.core.verilog``, emitting the same text character for character
for the same netlist.

Emits the exact module structure of the thesis: a ``LogicNetModule`` top,
one ``LUTLayer{l}`` per layer wiring per-neuron input selections, and one
``LUT_L{l}_N{n}`` case-statement module per neuron.  No LUT primitives are
instantiated — "we define the entire truth table and leave it up to the
logic synthesis tool" (§5.2).  Optional pipeline registers between layers
(Fig. 5.1) for the fully-pipelined variant (§5.4).

``evaluate_verilog`` is a mini-interpreter for the restricted subset we
emit, used by the tests to prove generated-RTL == truth-table forward.
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch.core.netlist import Netlist


def _concat_expr(bus: str, bits: list[int]) -> str:
    """Verilog concatenation {MSB, ..., LSB} for LSB-first bit positions."""
    return "{" + ", ".join(f"{bus}[{b}]" for b in reversed(bits)) + "}"


def neuron_module(name: str, n_in_bits: int, out_bits: int,
                  table: np.ndarray,
                  reachable: np.ndarray | None = None) -> str:
    """One case-statement LUT module, always with an explicit ``default:``.

    Without the default arm an incomplete case would make the synthesized
    combinational block diverge from ``evaluate_verilog`` (and infer a
    latch) on any uncovered input.  When a ``reachable`` mask is given
    (compile-pipeline output), unreachable entries are don't-cares: they are
    folded into the default arm, whose value is the most common *reachable*
    output code — and reachable arms equal to it are omitted too, since the
    default reproduces them exactly.
    """
    lines = [f"module {name} ( input [{n_in_bits - 1}:0] M0, "
             f"output [{out_bits - 1}:0] M1 );",
             f"  reg [{out_bits - 1}:0] M1;",
             "  always @ (M0) begin",
             "    case (M0)"]
    if reachable is None:
        default = 0
        emit = np.ones(len(table), dtype=bool)
    else:
        vals, counts = np.unique(np.asarray(table)[reachable],
                                 return_counts=True)
        default = int(vals[np.argmax(counts)])
        emit = reachable & (np.asarray(table) != default)
    for entry, code in enumerate(table):
        if emit[entry]:
            lines.append(f"      {n_in_bits}'d{entry}: "
                         f"M1 = {out_bits}'d{int(code)};")
    lines.append(f"      default: M1 = {out_bits}'d{default};")
    lines += ["    endcase", "  end", "endmodule"]
    return "\n".join(lines)


def neuron_module_sop(name: str, n_in_bits: int, out_bits: int,
                      cover) -> str:
    """One assign-network LUT module from a minimized SOP cover.

    Instead of the full case statement, each output bit is an OR of
    parenthesized AND terms over ``M0`` literals — the two-level form
    ``repro_torch.synth`` minimized, handed to the downstream synthesis
    tool as explicit structure rather than a table.  Constant bits become
    ``1'b0`` / ``1'b1``.  On don't-care (unreachable) inputs the module
    may differ from its case-statement sibling; on reachable inputs they
    are bit-identical (the minimizer's exactness contract).
    """
    lines = [f"module {name} ( input [{n_in_bits - 1}:0] M0, "
             f"output [{out_bits - 1}:0] M1 );"]
    for b, cubes in enumerate(cover.bits):
        terms: list[str] | None = []
        for c in cubes:
            lits = c.literals()
            if not lits:            # tautology cube: the bit is constant 1
                terms = None
                break
            terms.append("(" + " & ".join(
                ("" if positive else "~") + f"M0[{p}]"
                for p, positive in lits) + ")")
        if terms is None:
            rhs = "1'b1"
        elif not terms:
            rhs = "1'b0"
        else:
            rhs = " | ".join(terms)
        lines.append(f"  assign M1[{b}] = {rhs};")
    lines.append("endmodule")
    return "\n".join(lines)


def layer_module(netlist: Netlist, layer: int) -> str:
    neurons = netlist.layers[layer]
    in_bits = (netlist.in_bits if layer == 0 else
               sum(n.out_bits for n in netlist.layers[layer - 1]))
    out_bits = sum(n.out_bits for n in neurons)
    lines = [f"module LUTLayer{layer} (input [{in_bits - 1}:0] M0, "
             f"output [{out_bits - 1}:0] M1);"]
    pos = 0
    for n in neurons:
        wire = f"inpWire{layer}_{n.neuron}"
        width = len(n.input_bits)
        lines.append(f"  wire [{width - 1}:0] {wire} = "
                     f"{_concat_expr('M0', n.input_bits)};")
        hi, lo = pos + n.out_bits - 1, pos
        lines.append(f"  LUT_L{layer}_N{n.neuron} "
                     f"LUT_L{layer}_N{n.neuron}_inst "
                     f"(.M0({wire}), .M1(M1[{hi}:{lo}]));")
        pos += n.out_bits
    lines.append("endmodule")
    return "\n".join(lines)


def top_module(netlist: Netlist, pipeline: bool = False) -> str:
    n_layers = len(netlist.layers)
    widths = [netlist.in_bits] + [sum(n.out_bits for n in layer)
                                  for layer in netlist.layers]
    lines = [f"module LogicNetModule (input [{widths[0] - 1}:0] M0, "
             f"output [{widths[-1] - 1}:0] M{n_layers}"
             + (", input clk" if pipeline else "") + ");"]
    for l in range(1, n_layers):
        kind = "reg" if pipeline else "wire"
        lines.append(f"  {kind} [{widths[l] - 1}:0] M{l};")
    if pipeline:
        lines.append(f"  reg [{widths[0] - 1}:0] M0_r;")
        for l in range(1, n_layers):
            lines.append(f"  wire [{widths[l] - 1}:0] M{l}_w;")
        lines.append("  always @ (posedge clk) begin")
        lines.append("    M0_r <= M0;")
        for l in range(1, n_layers):
            lines.append(f"    M{l} <= M{l}_w;")
        lines.append("  end")
    for l in range(n_layers):
        src = ("M0_r" if pipeline and l == 0 else f"M{l}")
        dst = (f"M{l + 1}_w" if pipeline and l + 1 < n_layers
               else f"M{l + 1}")
        lines.append(f"  LUTLayer{l} LUTLayer{l}_inst "
                     f"(.M0({src}), .M1({dst}));")
    lines.append("endmodule")
    return "\n".join(lines)


def generate_verilog(netlist: Netlist, pipeline: bool = False,
                     sop: bool = False) -> dict[str, str]:
    """All .v sources, keyed by file name (Listing 5.2–5.6 layout).

    ``sop=True`` emits assign-network modules from the minimized covers
    that ``compile.optimize(..., synth=True)`` attached to the netlist
    (``NeuronHBB.sop``); neurons without a cover (synthesis budget
    fallback, or an unsynthesized netlist) keep the case-statement form.
    Layer/top modules are identical either way.
    """
    files = {"LogicNetModule.v": top_module(netlist, pipeline)}
    for l, layer in enumerate(netlist.layers):
        files[f"LUTLayer{l}.v"] = layer_module(netlist, l)
        for n in layer:
            name = f"LUT_L{l}_N{n.neuron}"
            if sop and n.sop is not None:
                files[f"{name}.v"] = neuron_module_sop(
                    name, len(n.input_bits), n.out_bits, n.sop)
            else:
                files[f"{name}.v"] = neuron_module(
                    name, len(n.input_bits), n.out_bits, n.table,
                    n.reachable)
    return files


# ---------------------------------------------------------------------------
# Mini evaluator for the emitted subset (test oracle for RTL == tables)
# ---------------------------------------------------------------------------

_CASE_RE = re.compile(r"(\d+)'d(\d+):\s*M1\s*=\s*(\d+)'d(\d+);")
_DEFAULT_RE = re.compile(r"default:\s*M1\s*=\s*(\d+)'d(\d+);")
_ASSIGN_RE = re.compile(r"assign M1\[(\d+)\] = (.*);")
_LIT_RE = re.compile(r"(~?)M0\[(\d+)\]")
_WIDTH_RE = re.compile(r"input \[(\d+):0\] M0")
_WIRE_RE = re.compile(
    r"wire \[(\d+):0\] (inpWire\d+_\d+) = \{([^}]*)\};")
_INST_RE = re.compile(
    r"LUT_L(\d+)_N(\d+) LUT_L\d+_N\d+_inst "
    r"\(\.M0\((inpWire\d+_\d+)\), \.M1\(M1\[(\d+):(\d+)\]\)\);")


def _parse_tables(files: dict[str, str]) -> dict[str, np.ndarray]:
    tables = {}
    for fname, text in files.items():
        if not fname.startswith("LUT_L"):
            continue
        n_in_bits = int(_WIDTH_RE.search(text).group(1)) + 1
        if "assign M1[" in text:
            # SOP assign-network module: rebuild the full table by
            # evaluating every product term, so downstream evaluation is
            # identical to the case-statement path
            words = np.arange(1 << n_in_bits, dtype=np.int64)
            table = np.zeros(words.shape, dtype=np.int64)
            for m in _ASSIGN_RE.finditer(text):
                b, rhs = int(m.group(1)), m.group(2)
                if rhs == "1'b0":
                    continue
                if rhs == "1'b1":
                    table |= np.int64(1) << b
                    continue
                hit = np.zeros(words.shape, dtype=bool)
                for term in re.findall(r"\(([^()]*)\)", rhs):
                    mask = value = 0
                    for neg, pos in _LIT_RE.findall(term):
                        mask |= 1 << int(pos)
                        if not neg:
                            value |= 1 << int(pos)
                    hit |= (words & mask) == value
                table |= hit.astype(np.int64) << b
            tables[fname[:-2]] = table
            continue
        dm = _DEFAULT_RE.search(text)
        default = int(dm.group(2)) if dm else 0
        # every entry not listed as an explicit arm takes the default value
        # — exactly the case-statement semantics synthesis sees
        table = np.full(1 << n_in_bits, default, dtype=np.int64)
        for m in _CASE_RE.finditer(text):
            table[int(m.group(2))] = int(m.group(4))
        tables[fname[:-2]] = table
    return tables


def evaluate_verilog(files: dict[str, str], input_word: int,
                     n_layers: int) -> int:
    """Evaluate the generated combinational network on one input word."""
    tables = _parse_tables(files)
    bus = input_word
    for l in range(n_layers):
        text = files[f"LUTLayer{l}.v"]
        wires: dict[str, int] = {}
        for m in _WIRE_RE.finditer(text):
            name, sel = m.group(2), m.group(3)
            bits = [int(b) for b in re.findall(r"M0\[(\d+)\]", sel)]
            val = 0
            for i, b in enumerate(reversed(bits)):      # MSB-first concat
                val |= ((bus >> b) & 1) << i
            wires[name] = val
        out = 0
        for m in _INST_RE.finditer(text):
            mod = f"LUT_L{m.group(1)}_N{m.group(2)}"
            hi, lo = int(m.group(4)), int(m.group(5))
            out |= int(tables[mod][wires[m.group(3)]]) << lo
        bus = out
    return bus
