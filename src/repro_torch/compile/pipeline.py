"""The truth-table compiler driver: ``optimize(netlist, level=...)`` (the
port's copy of ``repro.compile.pipeline``).

Levels (each includes the previous):

  0 — no rewriting; analysis + lowering only (stats still reported).
  1 — reachable-code analysis / don't-care canonicalization + dead-neuron
      elimination.
  2 — (default) + neuron CSE and dead-input pruning, one round.
  3 — + cross-layer code re-encoding (reencode.py: intermediate bus
      features narrowed to ceil(log2 k) bits with coordinated
      producer/consumer rewrites), and the full round iterated to a
      fixpoint: constants exposed by one round's pruning collapse further
      consumers in the next, and narrowed features hand pruning fresh
      singleton elements, until nothing changes.
  4 — + two-level logic synthesis (alias for ``level=3, synth=True``):
      each surviving neuron's table is minimized into an SOP cover
      (repro_torch.synth) over its reachable on-set, attached to the netlist
      for the assign-network Verilog backend and measured LUT costing.

The input is either a ``list[LayerTruthTable]`` (straight from
``logicnet.generate_tables``) or a ``Netlist`` built by
``netlist.build_netlist``.  The result carries all three views of the
optimized network — uniform tables for the table-forward and kernel paths, an exact
per-neuron netlist for Verilog, and the raw IR — plus per-pass statistics
and before/after storage + LUT-cost accounting.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import obs
from repro_torch.compile import passes, reachability, reencode
from repro_torch.compile.ir import CNet
from repro_torch.core.netlist import Netlist
from repro_torch.core.truth_table import LayerTruthTable, MixedLayerTables

MAX_ROUNDS = 16  # fixpoint guard; each round strictly shrinks the net

# PassStats mirrored into the process registry so one snapshot answers
# "which compile pass got slower?" next to the serving-tier histograms
_M_OPT_RUNS = obs.registry().counter(
    "compile_optimize_runs_total",
    "optimize() invocations by pipeline level", labels=("level",))
_M_OPT_SECONDS = obs.registry().histogram(
    "compile_optimize_seconds", "end-to-end optimize() wall time")
_M_PASS_RUNS = obs.registry().counter(
    "compile_pass_runs_total",
    "pass executions across all optimize() rounds", labels=("pass",))
_M_PASS_SECONDS = obs.registry().counter(
    "compile_pass_seconds_total",
    "cumulative wall time per pass name", labels=("pass",))


@dataclasses.dataclass(frozen=True)
class PassStats:
    """One pass execution: what it removed and what it cost."""

    name: str
    round: int
    seconds: float
    detail: dict

    def as_dict(self) -> dict:
        return {"name": self.name, "round": self.round,
                "seconds": self.seconds, **self.detail}

    @classmethod
    def from_dict(cls, d: dict) -> "PassStats":
        """Inverse of ``as_dict`` (detail is the non-header remainder)."""
        d = dict(d)
        return cls(d.pop("name"), d.pop("round"), d.pop("seconds"), d)


@dataclasses.dataclass
class CompileStats:
    level: int
    rounds: int
    passes: list[PassStats]
    neurons_before: int
    neurons_after: int
    table_entries_before: int
    table_entries_after: int
    table_bytes_before: int
    table_bytes_after: int
    lut_cost_before: int
    lut_cost_after: int
    # synthesize_netlist() stats dict when optimize(..., synth=True) ran
    # (covered/fallback neuron counts, literal/term totals, seconds);
    # None when synthesis was not requested.
    synth: dict | None = None

    @property
    def dont_care_entries(self) -> int:
        return sum(p.detail.get("dont_care_entries", 0)
                   for p in self.passes if p.round == 0)

    @property
    def features_recoded(self) -> int:
        """Re-encoding *events* over all rounds: a feature narrowed again
        in a later round (its reachable set shrank further) counts once per
        round.  For a round-count-independent magnitude use ``bits_saved``,
        which telescopes (3->2 then 2->1 bits sums to the same 2 bits as a
        single 3->1 narrowing)."""
        return sum(p.detail.get("features_recoded", 0) for p in self.passes)

    @property
    def bits_saved(self) -> int:
        """Bus bits dropped by re-encoding (sum of old-new widths; exactly
        the original-to-final width delta regardless of round count)."""
        return sum(p.detail.get("bits_saved", 0) for p in self.passes)

    def as_dict(self) -> dict:
        return {
            "level": self.level,
            "rounds": self.rounds,
            "neurons_before": self.neurons_before,
            "neurons_after": self.neurons_after,
            "table_entries_before": self.table_entries_before,
            "table_entries_after": self.table_entries_after,
            "table_bytes_before": self.table_bytes_before,
            "table_bytes_after": self.table_bytes_after,
            "lut_cost_before": self.lut_cost_before,
            "lut_cost_after": self.lut_cost_after,
            "dont_care_entries": self.dont_care_entries,
            "features_recoded": self.features_recoded,
            "bits_saved": self.bits_saved,
            "synth": self.synth,
            "passes": [p.as_dict() for p in self.passes],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CompileStats":
        """Inverse of ``as_dict``: rebuild from a JSON record (derived
        properties — ``dont_care_entries`` etc. — are recomputed, not
        read).  The serving engine stores compile stats in its artifact
        metadata this way, so a loaded ``CompiledLUTNet`` reports the
        stats of the build that produced its slabs."""
        return cls(
            level=d["level"], rounds=d["rounds"],
            passes=[PassStats.from_dict(p) for p in d["passes"]],
            neurons_before=d["neurons_before"],
            neurons_after=d["neurons_after"],
            table_entries_before=d["table_entries_before"],
            table_entries_after=d["table_entries_after"],
            table_bytes_before=d["table_bytes_before"],
            table_bytes_after=d["table_bytes_after"],
            lut_cost_before=d["lut_cost_before"],
            lut_cost_after=d["lut_cost_after"],
            synth=d.get("synth"),
        )


@dataclasses.dataclass
class OptimizeResult:
    """Optimized network in every consumer's native representation."""

    cnet: CNet
    stats: CompileStats

    @property
    def tables(self) -> list[LayerTruthTable]:
        """Uniform per-layer tables for table_infer / the LUT kernels."""
        if self._tables is None:
            self._tables = self.cnet.to_tables()
        return self._tables

    @property
    def mixed_tables(self) -> list[MixedLayerTables]:
        """Compact per-neuron tables for the fused mixed-width kernel.

        Unlike ``tables`` nothing is padded back to a uniform element
        width: the fused kernel's slabs built from this lowering cost
        exactly the bytes ``cnet.table_bytes()`` accounts for.
        """
        if self._mixed is None:
            self._mixed = self.cnet.to_mixed_tables()
        return self._mixed

    @property
    def netlist(self) -> Netlist:
        """Exact per-neuron netlist (with don't-care masks) for Verilog."""
        if self._netlist is None:
            self._netlist = self.cnet.to_netlist()
        return self._netlist

    def __post_init__(self) -> None:
        self._tables: list[LayerTruthTable] | None = None
        self._mixed: list[MixedLayerTables] | None = None
        self._netlist: Netlist | None = None


def _as_cnet(netlist, in_features: int | None) -> CNet:
    if isinstance(netlist, CNet):
        return netlist
    if isinstance(netlist, Netlist):
        return CNet.from_netlist(netlist)
    return CNet.from_tables(list(netlist), in_features)


def _shape_signature(net: CNet) -> tuple:
    return tuple((lay.out_features,
                  tuple(n.fan_in for n in lay.neurons),
                  tuple(-1 if n.out_width is None else n.out_width
                        for n in lay.neurons),
                  sum(int(n.table.sum()) for n in lay.neurons))
                 for lay in net.layers)


def optimize(netlist, level: int = 2, *,
             synth: bool = False,
             in_features: int | None = None) -> OptimizeResult:
    """Run the pass pipeline; see module docstring for the level ladder.

    ``netlist`` is a ``list[LayerTruthTable]``, a ``Netlist`` (from
    ``build_netlist``), or a ``CNet``.  The optimized network computes the
    same function as the input on every reachable input, bit-exactly —
    per-layer, fused-kernel and Verilog lowerings included.

    ``synth=True`` (or ``level=4``, an alias for ``level=3, synth=True``)
    appends the two-level synthesis stage: ``repro_torch.synth`` minimizes each
    neuron's table into an SOP cover attached to ``result.netlist``, with
    the stats recorded in ``result.stats.synth``.
    """
    if level == 4:
        level, synth = 3, True
    if not 0 <= level <= 3:
        raise ValueError(f"optimize level must be in [0, 4], got {level}")
    net = _as_cnet(netlist, in_features)
    net.validate()

    before_neurons = net.n_neurons
    before_entries = net.n_table_entries
    before_bytes = net.table_bytes()
    before_lut = net.lut_cost()

    pass_stats: list[PassStats] = []

    t_opt = time.perf_counter()

    def run(name: str, fn, rnd: int) -> dict:
        t0 = time.perf_counter()
        detail = fn(net)
        seconds = time.perf_counter() - t0
        pass_stats.append(PassStats(name, rnd, seconds, detail))
        _M_PASS_RUNS.labels(**{"pass": name}).inc()
        _M_PASS_SECONDS.labels(**{"pass": name}).inc(seconds)
        return detail

    rounds = 0
    if level == 0:
        # analysis-only: reachability stats with no rewriting at all
        run("reachability",
            lambda n: reachability.analyze_and_canonicalize(
                n, rewrite=False), 0)
    else:
        max_rounds = MAX_ROUNDS if level >= 3 else 1
        for rnd in range(max_rounds):
            sig = _shape_signature(net)
            run("reachability", reachability.analyze_and_canonicalize, rnd)
            if level >= 2:
                run("prune_dead_inputs", passes.prune_dead_inputs, rnd)
                run("cse", passes.cse, rnd)
            if level >= 3:
                # after pruning/CSE so reachable sets are final for the
                # round; narrowed features then unlock further pruning in
                # the next round (singleton -> element removed), which is
                # why the round iterates to a fixpoint
                run("reencode", reencode.reencode, rnd)
            run("fold_and_eliminate", passes.fold_and_eliminate, rnd)
            rounds = rnd + 1
            if _shape_signature(net) == sig:
                break
    net.validate()
    _M_OPT_RUNS.labels(level=str(level)).inc()
    _M_OPT_SECONDS.observe(time.perf_counter() - t_opt)

    stats = CompileStats(
        level=level, rounds=rounds, passes=pass_stats,
        neurons_before=before_neurons, neurons_after=net.n_neurons,
        table_entries_before=before_entries,
        table_entries_after=net.n_table_entries,
        table_bytes_before=before_bytes, table_bytes_after=net.table_bytes(),
        lut_cost_before=before_lut,
        lut_cost_after=net.lut_cost(),
    )
    result = OptimizeResult(net, stats)
    if synth:
        # the synthesis stage runs on the lowered netlist (the exact
        # per-neuron view the Verilog backend consumes) so covers line
        # up with the emitted modules bit-for-bit
        from repro_torch.synth import synthesize_netlist

        t0 = time.perf_counter()
        detail = synthesize_netlist(result.netlist)
        seconds = time.perf_counter() - t0
        pass_stats.append(PassStats("synth", rounds, seconds, dict(detail)))
        _M_PASS_RUNS.labels(**{"pass": "synth"}).inc()
        _M_PASS_SECONDS.labels(**{"pass": "synth"}).inc(seconds)
        stats.synth = {**detail, "seconds": seconds}
    return result


def optimize_tables(tables: list[LayerTruthTable], level: int = 2, *,
                    in_features: int | None = None
                    ) -> list[LayerTruthTable]:
    """Convenience: tables in, optimized uniform tables out."""
    return optimize(tables, level, in_features=in_features).tables


def tables_from_triples(layers) -> list[LayerTruthTable]:
    """``(indices, table, bw_in)`` triples -> ``LayerTruthTable`` list.

    Output bit-widths are inferred (the next layer's ``bw_in``; widest
    code for the last layer) since triples don't carry them; they only
    affect storage accounting, not the computed function.  Shared by
    ``optimize_triples`` and ``engine.compile_network``'s compiler rung.
    """
    triples = [(np.asarray(i), np.asarray(t), int(b)) for i, t, b in layers]
    tables = []
    for li, (idx, tab, bw) in enumerate(triples):
        if li + 1 < len(triples):
            bw_out = triples[li + 1][2]
        else:
            bw_out = max(1, int(tab.max(initial=0)).bit_length())
        tables.append(LayerTruthTable(tab.astype(np.int32),
                                      idx.astype(np.int32), bw, bw_out))
    return tables


def optimize_triples(layers, level: int = 2, *,
                     in_features: int | None = None) -> list[tuple]:
    """``(indices, table, bw_in)`` triples in/out — the engine's
    wire format (uniform lowering; see ``OptimizeResult.mixed_tables`` /
    ``optimize_mixed_tables`` for the compact mixed-width lowering the
    fused kernel consumes directly)."""
    opt = optimize(tables_from_triples(layers), level,
                   in_features=in_features).tables
    return [(tt.indices, tt.table, tt.bw_in) for tt in opt]


def optimize_mixed_tables(tables, level: int = 2, *,
                          in_features: int | None = None
                          ) -> list[MixedLayerTables]:
    """Convenience: tables in, compact mixed-width tables out.

    The lowering ``kernels.lut_network.build_mixed_network_slabs`` packs
    into the fused kernel's exact-footprint slabs."""
    return optimize(tables, level, in_features=in_features).mixed_tables


def raw_stats(tables: list[LayerTruthTable],
              in_features: int | None = None) -> dict:
    """Storage/cost accounting of an *unoptimized* table stack (for the
    bench JSON's raw-vs-optimized comparison)."""
    net = CNet.from_tables(tables, in_features)
    return {"neurons": net.n_neurons,
            "table_entries": net.n_table_entries,
            "table_bytes": net.table_bytes(),
            "lut_cost": net.lut_cost()}


def summarize(stats: CompileStats) -> str:
    """One-line human summary (the bench prints it next to timings)."""
    s = stats

    def pct(a, b):
        return 100.0 * (1.0 - a / b) if b else 0.0
    recoded = (f" recoded={s.features_recoded}feat/-{s.bits_saved}bits"
               if s.features_recoded else "")
    return (f"level={s.level} rounds={s.rounds} "
            f"neurons {s.neurons_before}->{s.neurons_after} "
            f"entries {s.table_entries_before}->{s.table_entries_after} "
            f"bytes {s.table_bytes_before}->{s.table_bytes_after} "
            f"(-{pct(s.table_bytes_after, s.table_bytes_before):.1f}%) "
            f"LUTs {s.lut_cost_before}->{s.lut_cost_after}{recoded}")


__all__ = ["optimize", "optimize_tables", "optimize_triples",
           "optimize_mixed_tables", "tables_from_triples",
           "raw_stats", "summarize",
           "OptimizeResult", "CompileStats", "PassStats", "MAX_ROUNDS"]
