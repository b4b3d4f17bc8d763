"""Quine–McCluskey / espresso-style two-level minimization.

The paper's tool-flow hands every neuron's full truth table to Vivado
and lets its logic synthesis find the minimized circuit; this module is
that step done in-repo, over exactly the don't-care information the
compile pipeline already harvests:

* the **on-set** of each output bit is read from the neuron's table,
  restricted to *reachable* entries (the reachability pass's mask);
* every **unreachable** entry is a don't-care, free to be absorbed into
  whichever prime implicant shrinks the cover most;
* prime implicants come from iterative cube merging (two same-mask
  cubes differing in one cared bit merge into one cube with that bit
  dropped), then an essential-prime + greedy irredundant cover of the
  on-set.

Budgets make wide fan-ins degrade gracefully: a neuron whose input
width exceeds ``max_bits``, or whose merge frontier outgrows
``max_cubes``, *falls back to the unminimized table* (``minimize_table``
returns None) — downstream consumers emit the plain case-statement
module and price the neuron at the worst-case ``lut_cost`` bound, so
synthesis can never make a build fail, only decline to improve it.

>>> import numpy as np
>>> table = np.array([0, 1, 1, 1])          # OR of two inputs
>>> cover = minimize_table(table, n_in=2, out_bits=1)
>>> cover.table().tolist()
[0, 1, 1, 1]
>>> cover.n_terms, cover.n_literals        # two 1-literal cubes: a | b
(2, 2)
"""

from __future__ import annotations

import numpy as np

from repro_torch.synth.sop import Cube, SopCover

# fall back to the unminimized table beyond these sizes: 2^14 minterms
# is where exact QM stops being interactive, and the merge frontier cap
# bounds the pathological middle levels on dense functions
DEFAULT_MAX_BITS = 14
DEFAULT_MAX_CUBES = 8192


def _prime_implicants(minterms: set[int], n_in: int,
                      max_cubes: int) -> set[Cube] | None:
    """All prime implicants of ``minterms`` (on-set ∪ dc-set).

    Iterative merging: two cubes with the same mask whose values differ
    in exactly one cared bit combine into one cube without that bit.
    Cubes that never merge at any level are prime.  Returns None when a
    level's cube count exceeds ``max_cubes`` (budget exceeded).
    """
    full = (1 << n_in) - 1
    current: set[Cube] = {Cube(full, m) for m in minterms}
    primes: set[Cube] = set()
    while current:
        if len(current) > max_cubes:
            return None
        by_mask: dict[int, set[int]] = {}
        for c in current:
            by_mask.setdefault(c.mask, set()).add(c.value)
        merged: set[Cube] = set()
        nxt: set[Cube] = set()
        for mask, vals in by_mask.items():
            bits = [1 << i for i in range(n_in) if mask >> i & 1]
            for v in vals:
                for b in bits:
                    if v & b:
                        continue
                    if (v | b) in vals:
                        nxt.add(Cube(mask & ~b, v))
                        merged.add(Cube(mask, v))
                        merged.add(Cube(mask, v | b))
        primes |= current - merged
        current = nxt
    return primes


def _cube_minterms(cube: Cube, on_set: set[int]) -> frozenset[int]:
    """On-set minterms a cube covers (don't-cares excluded on purpose:
    the cover must contain the on-set; it never owes the dc-set)."""
    return frozenset(m for m in on_set if cube.covers(m))


def _select_cover(primes: set[Cube], on_set: set[int]) -> tuple[Cube, ...]:
    """Essential primes, then greedy set cover of the remaining on-set.

    Deterministic: ties break toward fewer literals, then the smallest
    ``(mask, value)`` pair, so identical tables always synthesize
    identical covers (CSE/golden-file friendly).
    """
    coverage = {p: _cube_minterms(p, on_set) for p in sorted(primes)}
    coverage = {p: c for p, c in coverage.items() if c}
    chosen: list[Cube] = []
    uncovered = set(on_set)

    # essential primes: an on-set minterm covered by exactly one prime
    by_minterm: dict[int, list[Cube]] = {m: [] for m in on_set}
    for p, cov in coverage.items():
        for m in cov:
            by_minterm[m].append(p)
    for m, ps in sorted(by_minterm.items()):
        if len(ps) == 1 and ps[0] not in chosen:
            chosen.append(ps[0])
            uncovered -= coverage[ps[0]]

    # greedy: the prime covering the most uncovered minterms wins
    while uncovered:
        best = max(
            coverage,
            key=lambda p: (len(coverage[p] & uncovered),
                           -p.n_literals, -p.mask, -p.value))
        if not coverage[best] & uncovered:   # pragma: no cover - safety
            raise AssertionError("prime implicants failed to cover on-set")
        chosen.append(best)
        uncovered -= coverage[best]

    # irredundant pass: drop any chosen cube whose on-set contribution
    # is contained in the union of the others (greedy order can strand
    # essential-then-superseded picks)
    kept: list[Cube] = []
    for i, p in enumerate(chosen):
        others = [q for j, q in enumerate(chosen) if j != i
                  and (q in kept or j > i)]
        rest = set().union(*(coverage[q] for q in others)) if others else set()
        if not coverage[p] <= rest:
            kept.append(p)
    return tuple(sorted(kept))


def minimize_bit(on_set: set[int], dc_set: set[int], n_in: int, *,
                 max_cubes: int = DEFAULT_MAX_CUBES
                 ) -> tuple[Cube, ...] | None:
    """Minimized cover of one output bit; None when over budget.

    ``on_set`` / ``dc_set`` are disjoint sets of input words.  Constant
    bits short-circuit: empty on-set -> ``()`` (constant 0); on-set ∪
    dc-set = everything -> the tautology cube (constant 1).
    """
    if not on_set:
        return ()
    n_words = 1 << n_in
    if len(on_set) + len(dc_set) == n_words:
        return (Cube(0, 0),)
    primes = _prime_implicants(on_set | dc_set, n_in, max_cubes)
    if primes is None:
        return None
    return _select_cover(primes, on_set)


def minimize_table(table, n_in: int, out_bits: int, reachable=None, *,
                   max_bits: int = DEFAULT_MAX_BITS,
                   max_cubes: int = DEFAULT_MAX_CUBES) -> SopCover | None:
    """Minimize one neuron's truth table into a :class:`SopCover`.

    ``table`` has ``2^n_in`` output codes; ``reachable`` (optional bool
    mask of the same length) marks which entries can occur at runtime —
    everything else is a don't-care.  Returns None when the neuron
    exceeds the budget (``n_in > max_bits``, or any output bit's merge
    frontier outgrows ``max_cubes``): the caller keeps the unminimized
    table.  The result is exact on every reachable entry (asserted) and
    unconstrained on don't-cares.
    """
    table = np.asarray(table, dtype=np.int64)
    if table.shape[0] != 1 << n_in:
        raise ValueError(
            f"table has {table.shape[0]} entries; n_in={n_in} requires "
            f"2^{n_in}")
    if n_in > max_bits:
        return None
    if reachable is None:
        reach = np.ones(table.shape[0], dtype=bool)
    else:
        reach = np.asarray(reachable, dtype=bool)
    dc_set = set(np.flatnonzero(~reach).tolist())
    reach_words = np.flatnonzero(reach)
    covers = []
    for b in range(out_bits):
        on = set(reach_words[(table[reach_words] >> b & 1) == 1].tolist())
        cover = minimize_bit(on, dc_set, n_in, max_cubes=max_cubes)
        if cover is None:
            return None
        covers.append(cover)
    result = SopCover(n_in=n_in, out_bits=out_bits, bits=tuple(covers))
    # exactness contract: reachable entries must round-trip bit-for-bit
    got = result.evaluate(reach_words)
    want = table[reach_words] & ((1 << out_bits) - 1)
    if not np.array_equal(got, want):   # pragma: no cover - invariant
        raise AssertionError("minimized cover diverged from the on-set")
    return result


def synthesize_netlist(netlist, *, max_bits: int = DEFAULT_MAX_BITS,
                       max_cubes: int = DEFAULT_MAX_CUBES) -> dict:
    """Attach minimized covers to every neuron of a ``Netlist`` in place.

    Each :class:`~repro_torch.core.netlist.NeuronHBB` gains ``sop`` (its
    :class:`SopCover`, or None on budget fallback), using the neuron's
    ``reachable`` mask — the compile pipeline's don't-care harvest — as
    the dc-set.  Returns the synthesis statistics dict the bench/CI
    stats artifact records:

    ``neurons`` / ``covered_neurons`` / ``fallback_neurons``, plus the
    literal/term accounting before (reachable on-set minterms priced as
    full cubes — the two-level cost of the unminimized table) and after
    minimization.
    """
    neurons = covered = 0
    terms_before = literals_before = 0
    terms_after = literals_after = 0
    for layer in netlist.layers:
        for n in layer:
            neurons += 1
            n_in = len(n.input_bits)
            table = np.asarray(n.table, dtype=np.int64)
            if n.reachable is None:
                reach = np.ones(table.shape[0], dtype=bool)
            else:
                reach = np.asarray(n.reachable, dtype=bool)
            words = np.flatnonzero(reach)
            for b in range(n.out_bits):
                on = int(np.count_nonzero(table[words] >> b & 1))
                terms_before += on
                literals_before += on * n_in
            cover = minimize_table(table, n_in, n.out_bits, reach,
                                   max_bits=max_bits, max_cubes=max_cubes)
            n.sop = cover
            if cover is not None:
                covered += 1
                terms_after += cover.n_terms
                literals_after += cover.n_literals
            else:
                # fallback keeps the table: price it like the on-set
                for b in range(n.out_bits):
                    on = int(np.count_nonzero(table[words] >> b & 1))
                    terms_after += on
                    literals_after += on * n_in
    return {
        "neurons": neurons,
        "covered_neurons": covered,
        "fallback_neurons": neurons - covered,
        "terms_before": terms_before,
        "literals_before": literals_before,
        "terms_after": terms_after,
        "literals_after": literals_after,
        "max_bits": max_bits,
        "max_cubes": max_cubes,
    }


__all__ = ["DEFAULT_MAX_BITS", "DEFAULT_MAX_CUBES", "minimize_bit",
           "minimize_table", "synthesize_netlist"]
