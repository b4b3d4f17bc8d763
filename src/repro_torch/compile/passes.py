"""Passes 2-4: neuron CSE, dead-input pruning, constant-fold / DCE.

All passes mutate the ``CNet`` in place and return a small stats dict; all
are behaviour-preserving on reachable inputs (the contract the pipeline's
property tests enforce end-to-end).  They assume the reachability pass ran
first in the same round — canonicalized tables are what make whole-table
equality checks sound (see reachability.py).
"""

from __future__ import annotations

import numpy as np

from repro_torch.compile.ir import CNet, CNeuron


def _remap_consumers(net: CNet, layer: int, remap: np.ndarray) -> None:
    """Rewrite layer ``layer + 1``'s feature indices through ``remap``."""
    if layer + 1 < len(net.layers):
        for n in net.layers[layer + 1].neurons:
            n.indices = remap[n.indices].astype(np.int32)


# ---------------------------------------------------------------------------
# Pass 2: common-subexpression elimination (neuron dedup)
# ---------------------------------------------------------------------------

def cse(net: CNet) -> dict:
    """Rewire consumers of identical (fan-in signature, table) neurons.

    Duplicates are *not* deleted here — consumers are simply redirected to
    the first representative, which leaves the duplicate unconsumed for the
    DCE pass to collect.  The final layer is the network's output bus, so
    its neurons are never merged (arity and order are the output contract).
    Re-encoded neurons carry their own output width, so the width is part
    of the merge key: redirecting a consumer must not change the encoding
    of the feature it reads.
    """
    merged = 0
    for li in range(len(net.layers) - 1):
        lay = net.layers[li]
        seen: dict[bytes, int] = {}
        remap = np.arange(lay.out_features, dtype=np.int32)
        merged_here = 0
        for j, n in enumerate(lay.neurons):
            key = (n.indices.tobytes() + b"|" + n.table.tobytes()
                   + b"|" + str(lay.out_width_of(j)).encode())
            if key in seen:
                remap[j] = seen[key]
                merged_here += 1
            else:
                seen[key] = j
        if merged_here:
            _remap_consumers(net, li, remap)
        merged += merged_here
    return {"merged": merged}


# ---------------------------------------------------------------------------
# Pass 3: dead-input pruning
# ---------------------------------------------------------------------------

def _reachable_feat_codes(net: CNet) -> list[list[np.ndarray]]:
    """Per layer, the reachable code set of each *input* feature."""
    per_layer = []
    feat_codes = [np.arange(1 << net.layers[0].bw_in, dtype=np.int64)
                  for _ in range(net.in_features)]
    for lay in net.layers:
        per_layer.append(feat_codes)
        feat_codes = [np.unique(n.table if n.reachable is None
                                else n.table[n.reachable])
                      for n in lay.neurons]
    return per_layer


def _try_prune_element(n: CNeuron, k: int, elem_widths: np.ndarray,
                       reach: np.ndarray) -> bool:
    """Remove element k if the table is independent of it across ``reach``.

    The table is viewed as an array over digits (element 0 is the packed
    entry's LSB group, i.e. the *last* reshape axis; axis extents follow
    the per-element widths); independence need only hold across the
    element's reachable codes — canonicalization already made every
    unreachable digit value a copy of a reachable one.
    """
    fan_in = n.fan_in
    shape = tuple(1 << int(w) for w in elem_widths[::-1])
    t = n.table.reshape(shape)
    ax = fan_in - 1 - k
    codes = [int(c) for c in reach]
    ref = np.take(t, codes[0], axis=ax)
    for c in codes[1:]:
        if not np.array_equal(np.take(t, c, axis=ax), ref):
            return False
    n.table = np.ascontiguousarray(ref).reshape(-1)
    n.indices = np.delete(n.indices, k)
    if n.reachable is not None:
        r = n.reachable.reshape(shape)
        n.reachable = np.ascontiguousarray(
            np.take(r, codes[0], axis=ax)).reshape(-1)
    return True


def prune_dead_inputs(net: CNet) -> dict:
    """Drop fan-in elements with no influence on the (reachable) output.

    Each pruned element shrinks the neuron's table by ``2^bw_in`` (2x per
    pruned input bit).  Covers constant-input folding for free: an element
    whose feature carries a single reachable code is always independent.
    Neurons keep at least one element so every lowering target stays
    well-formed (a fully-pruned neuron is just a constant 2^bw-entry table
    that DCE or the consumers' own pruning will handle).
    """
    pruned = 0
    folded = 0
    feat_codes_per_layer = _reachable_feat_codes(net)
    for li, (lay, feat_codes) in enumerate(zip(net.layers,
                                               feat_codes_per_layer)):
        widths = net.input_widths(li)
        for n in lay.neurons:
            changed = True
            while changed and n.fan_in > 1:
                changed = False
                for k in range(n.fan_in):
                    reach = feat_codes[int(n.indices[k])]
                    if n.fan_in > 1 and _try_prune_element(
                            n, k, widths[n.indices], reach):
                        pruned += 1
                        changed = True
                        break
            # a single remaining element whose reachable codes all map to
            # one value means the neuron is a constant: materialize it as
            # a literal table wired to feature 0 (some wire is required by
            # every lowering target), releasing its producer to DCE
            if n.fan_in == 1:
                reach = feat_codes[int(n.indices[0])]
                vals = {int(n.table[int(c)]) for c in reach}
                if len(vals) == 1:
                    v = vals.pop()
                    w0 = int(widths[0])
                    already = (int(n.indices[0]) == 0
                               and n.n_entries == 1 << w0
                               and bool((n.table == v).all()))
                    if not already:
                        folded += 1
                        n.indices = np.zeros(1, dtype=np.int32)
                        n.table = np.full(1 << w0, v, dtype=np.int32)
                        n.reachable = np.ones(1 << w0, dtype=bool)
    return {"pruned_elements": pruned, "folded_constants": folded}


# ---------------------------------------------------------------------------
# Pass 4: constant folding / dead-neuron elimination
# ---------------------------------------------------------------------------

def fold_and_eliminate(net: CNet) -> dict:
    """Count reachable-constant neurons and delete unconsumed ones.

    Constants are *detected* here (their consumers' table entries collapse
    via pass 3, since a constant producer has a singleton reachable set) and
    removal happens once nothing reads them.  Sweeping from the output layer
    backwards cascades a whole chain of dead neurons in one pass.  The final
    layer is the output contract and is never touched.
    """
    constants = 0
    for lay in net.layers:
        for n in lay.neurons:
            vals = n.table if n.reachable is None else n.table[n.reachable]
            constants += int(vals.size > 0 and
                             int(vals.min()) == int(vals.max()))
    removed = 0
    for li in range(len(net.layers) - 2, -1, -1):
        lay = net.layers[li]
        consumed = set()
        for n in net.layers[li + 1].neurons:
            consumed.update(int(f) for f in n.indices)
        keep = [j for j in range(lay.out_features) if j in consumed]
        if len(keep) == lay.out_features:
            continue
        if not keep:
            # pathological (nothing consumed): keep one neuron so layer
            # shapes stay non-degenerate for every lowering target
            keep = [0]
        remap = np.zeros(lay.out_features, dtype=np.int32)
        for new_j, old_j in enumerate(keep):
            remap[old_j] = new_j
        removed += lay.out_features - len(keep)
        lay.neurons = [lay.neurons[j] for j in keep]
        _remap_consumers(net, li, remap)
    return {"constants": constants, "removed_neurons": removed}
