"""Pass 1: reachable-code analysis + don't-care canonicalization.

A generated truth table enumerates all ``2^(fan_in*bw_in)`` input codes,
but the previous layer can only *emit* the codes that actually appear in
its own tables — every other entry of a downstream table is a don't-care
the paper's FPGA flow leaves to the logic synthesizer.  This pass computes,
layer by layer, the set of codes each bus feature can carry, derives a
per-entry reachability mask for every neuron, and **canonicalizes** the
don't-care entries: each unreachable code of an input element is remapped
to that element's smallest reachable code, and the table value copied from
the resulting reachable entry.

After canonicalization the table is constant across every unreachable
digit value (by construction), which is what lets the later passes operate
on whole tables with plain equality:

  * dead-input pruning only has to test independence across *reachable*
    codes of an element;
  * CSE compares canonical tables byte-for-byte, so two neurons that agree
    on reachable inputs but differed on don't-cares now merge;
  * a neuron constant on reachable entries becomes a globally constant
    table.

Behaviour on reachable inputs is untouched — the whole-network function is
bit-identical for any input the network can actually see.  With
``rewrite=False`` the dataflow runs analysis-only (level 0): statistics
are computed but no neuron is mutated.
"""

from __future__ import annotations

import numpy as np

from repro_torch.compile.ir import (ENTRY_CHUNK, CNet, CNeuron, entry_digits,
                              entry_widths_offsets)


def scan_neuron(n: CNeuron, elem_widths: np.ndarray,
                feat_codes: list[np.ndarray],
                rewrite: bool) -> tuple[np.ndarray, int]:
    """One chunked sweep over the neuron's entries.

    ``elem_widths`` is the per-element input code width (mixed once the
    re-encoding pass has narrowed upstream features).  Computes the
    per-entry reachability mask and — when ``rewrite`` — canonicalizes
    don't-cares in the same pass (the digit decomposition is the dominant
    cost for wide fan-ins, so it is done exactly once).  Canonical map, per
    element k reading feature f: a reachable code maps to itself, an
    unreachable one to ``min(reachable codes of f)``; the new table value
    at entry e is the old value at the element-wise mapped entry, so
    unreachable entries become exact copies of reachable ones.  Returns
    ``(mask, n_dont_care)``.
    """
    offs = entry_widths_offsets(elem_widths)
    elem_ok, code_maps = [], []
    for k, f in enumerate(n.indices):
        n_codes = 1 << int(elem_widths[k])
        reach = feat_codes[int(f)]
        ok = np.isin(np.arange(n_codes), reach)
        elem_ok.append(ok)
        cmap = np.arange(n_codes, dtype=np.int64)
        cmap[~ok] = int(reach.min())
        code_maps.append(cmap)

    mask = np.ones(n.n_entries, dtype=bool)
    old = n.table.copy() if rewrite else n.table
    for start in range(0, n.n_entries, ENTRY_CHUNK):
        ids = np.arange(start, min(start + ENTRY_CHUNK, n.n_entries),
                        dtype=np.int64)
        digits = entry_digits(ids, elem_widths)
        canon = np.zeros_like(ids)
        for k in range(n.fan_in):
            mask[ids] &= elem_ok[k][digits[:, k]]
            if rewrite:
                canon |= code_maps[k][digits[:, k]] << int(offs[k])
        if rewrite:
            n.table[ids] = old[canon]
    if rewrite:
        n.reachable = mask
    return mask, int(n.n_entries - mask.sum())


def analyze_and_canonicalize(net: CNet, rewrite: bool = True) -> dict:
    """Run the forward dataflow over the whole net.

    With ``rewrite`` (the default) don't-cares are canonicalized in place
    and reachability masks attached; without it the net is left untouched
    (analysis-only, the level-0 mode).  Returns stats: total/unreachable
    entry counts and the per-layer list of per-feature reachable-code
    counts (the quantity the ROADMAP's reachable-set-aware-training
    follow-on would regularize).
    """
    # network inputs: every code of the input quantizer can occur
    feat_codes: list[np.ndarray] = [
        np.arange(1 << net.layers[0].bw_in, dtype=np.int64)
        for _ in range(net.in_features)]
    dont_care = 0
    reach_counts: list[list[int]] = []
    for li, lay in enumerate(net.layers):
        widths = net.input_widths(li)
        next_codes = []
        for n in lay.neurons:
            mask, n_dc = scan_neuron(n, widths[n.indices], feat_codes,
                                     rewrite)
            dont_care += n_dc
            next_codes.append(np.unique(n.table[mask]))
        reach_counts.append([len(c) for c in next_codes])
        feat_codes = next_codes
    return {
        "total_entries": net.n_table_entries,
        "dont_care_entries": dont_care,
        "reachable_code_counts": reach_counts,
    }
