"""Truth-table compiler: netlist optimization passes for LogicNets; the
port's copy of ``repro.compile`` (host-side numpy, same passes, same
outputs bit for bit).

The generated tables are exact but maximally redundant — every neuron
stores all ``2^(fan_in*bw_in)`` entries even for input codes the previous
layer can never emit.  This package is the logic-synthesis step the paper
delegates to Vivado, done at the netlist level so *both* deployment targets
benefit: smaller packed slabs for the fused CUDA kernels (more stacks fit
the shared-memory budget) and fewer/narrower case-statement modules in the emitted
Verilog.

    from repro_torch import compile as rcompile
    res = rcompile.optimize(tables, level=2)
    res.tables        # uniform LayerTruthTables (the per-layer path)
    res.mixed_tables  # compact MixedLayerTables (the fused mixed-width
                      # kernel: per-(neuron, element) shifts, exact
                      # 2^(sum of input widths)-entry tables — shared
                      # memory costs
                      # exactly what the compiler proved)
    res.netlist       # per-neuron Netlist with don't-care masks (Verilog)
    res.stats         # per-pass reduction statistics

Passes: reachable-code analysis + don't-care canonicalization, neuron CSE,
dead-input pruning, cross-layer code re-encoding (level 3: a bus feature
carrying k < 2^bw distinct codes is narrowed to ceil(log2 k) bits with
coordinated producer/consumer rewrites), constant folding / dead-neuron
elimination.  See pipeline.py for the level ladder.

``optimize(..., synth=True)`` (or ``level=4``) appends two-level logic
synthesis: ``repro_torch.synth`` minimizes each surviving neuron into an SOP
cover attached to ``res.netlist`` for assign-network Verilog emission
and measured (rather than worst-case-bounded) LUT costing.
"""

from repro_torch.compile.ir import CLayer, CNet, CNeuron, forward_codes
from repro_torch.compile.pipeline import (CompileStats, OptimizeResult, PassStats,
                                    optimize, optimize_mixed_tables,
                                    optimize_tables, optimize_triples,
                                    raw_stats, summarize,
                                    tables_from_triples)
from repro_torch.compile.reencode import reencode
from repro_torch.core.truth_table import MixedLayerTables

__all__ = [
    "CLayer", "CNet", "CNeuron", "forward_codes",
    "CompileStats", "MixedLayerTables", "OptimizeResult", "PassStats",
    "optimize", "optimize_mixed_tables", "optimize_tables",
    "optimize_triples", "raw_stats", "reencode", "summarize",
    "tables_from_triples",
]
