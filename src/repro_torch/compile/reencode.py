"""Pass 5: cross-layer code re-encoding (level 3).

The table size of a neuron doubles with every input *bit*, so the bits a
feature actually needs is the strongest compression lever the netlist has:
a bus feature whose reachable code set holds k < 2^bw distinct values only
carries ``ceil(log2 k)`` bits of information, yet every consumer still
indexes its table with the full bw-bit container.  This pass re-codes such
features into the compact width with coordinated producer/consumer
rewrites:

  * the **producer**'s table values are replaced by the rank of each code
    in its sorted reachable set — the neuron now emits the compact code —
    and its ``out_width`` is set to the new width (``CNet.input_widths``
    derives every consumer's element widths from it);
  * every **consumer**'s table is re-indexed under the new encoding: the
    rebuilt table is dense over the compact element widths, entry values
    gathered from the old table at the decoded (old-code) entry.  Compact
    digit values >= k (present when k is not a power of two) can never
    arrive; they decode to compact code 0's old code, so the rebuilt table
    stays canonical (unreachable digits copy reachable columns) and the
    per-entry reachability masks are rebuilt alongside.

The final layer's *output* bus is the network's output contract and is
never re-encoded (the identity-preserving exception); its inputs — like
any layer's — may be.  The network input bus is the input quantizer's
contract and is likewise untouched (``CNet.input_widths`` pins layer 0 to
the uniform ``bw_in``).

A single-code feature (k == 1) clamps to the 1-bit minimum width — the
"width 0" case — emitting constant code 0; the dead-input pruning pass in
the same fixpoint round then removes the element from every consumer (a
singleton reachable set is always independent), which is exactly the
zero-bit outcome.  Re-encoding is idempotent: a compact feature carries
the dense set {0..k-1}, so it is only re-coded again if a later round's
pruning shrinks k itself — which is why the pipeline iterates the round to
a fixpoint at level 3.

Requires the reachability pass to have run in the same round (tables
canonicalized, masks attached): canonicalization guarantees every table
value appears in the reachable value set, so the producer rank-map covers
don't-care entries too.
"""

from __future__ import annotations

import numpy as np

from repro_torch.compile.ir import ENTRY_CHUNK, CNet, entry_digits


def reencode(net: CNet) -> dict:
    """Narrow every intermediate bus feature to its information content.

    Mutates the net in place; behaviour on reachable inputs is preserved
    bit-exactly (the whole-network function is unchanged — consumers are
    re-indexed in lockstep with their producers).  Returns stats:
    ``features_recoded``, ``bits_saved`` (bus bits dropped across all
    recoded features) and before/after packed table bytes.
    """
    features_recoded = 0
    bits_saved = 0
    bytes_before = net.table_bytes()
    for li in range(len(net.layers) - 1):
        lay = net.layers[li]
        nxt = net.layers[li + 1]
        old_w = net.input_widths(li + 1)        # current widths of lay's bus
        new_w = old_w.copy()
        decode: list[np.ndarray | None] = [None] * lay.out_features
        for j, n in enumerate(lay.neurons):
            vals = np.unique(n.table if n.reachable is None
                             else n.table[n.reachable])
            # ceil(log2 k) bits hold k codes; clamp at the 1-bit minimum so
            # every lowering target keeps a well-formed wire (k == 1 is
            # finished off by dead-input pruning, see module docstring)
            w_new = max(1, int(len(vals) - 1).bit_length())
            if w_new >= int(old_w[j]):
                continue
            new_w[j] = w_new
            decode[j] = vals.astype(np.int64)
            n.table = np.searchsorted(vals, n.table).astype(np.int32)
            features_recoded += 1
            bits_saved += int(old_w[j]) - w_new
        if all(d is None for d in decode):
            continue
        for m in nxt.neurons:
            if all(decode[int(f)] is None for f in m.indices):
                continue
            ew_old = old_w[m.indices]
            ew_new = new_w[m.indices]
            n_new = 1 << int(ew_new.sum())
            new_table = np.empty(n_new, dtype=m.table.dtype)
            new_mask = np.empty(n_new, dtype=bool)
            old_mask = m.reachable
            # chunked like reachability's sweep: wide fan-ins never
            # materialize the full (entries, fan_in) digit matrix at once
            for start in range(0, n_new, ENTRY_CHUNK):
                ids = np.arange(start, min(start + ENTRY_CHUNK, n_new),
                                dtype=np.int64)
                dig = entry_digits(ids, ew_new)
                old_entry = np.zeros_like(ids)
                valid = np.ones(ids.shape, dtype=bool)
                off = 0
                for k, f in enumerate(m.indices):
                    d = dig[:, k]
                    dec = decode[int(f)]
                    if dec is not None:
                        ok = d < len(dec)
                        valid &= ok
                        d = dec[np.where(ok, d, 0)]
                    old_entry |= d.astype(np.int64) << off
                    off += int(ew_old[k])
                new_table[ids] = m.table[old_entry]
                new_mask[ids] = (valid if old_mask is None
                                 else old_mask[old_entry] & valid)
            m.table = new_table
            m.reachable = new_mask
        # materialize every width so tightening the layer's uniform
        # container below cannot silently re-widen untouched neurons
        for j in range(lay.out_features):
            lay.neurons[j].out_width = int(new_w[j])
        lay.bw_out = nxt.bw_in = int(new_w.max(initial=1))
    return {"features_recoded": features_recoded,
            "bits_saved": bits_saved,
            "table_bytes_before": bytes_before,
            "table_bytes_after": net.table_bytes()}
