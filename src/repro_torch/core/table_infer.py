"""Truth-table functional verification (paper §4.2 'use_table' forward):
the port of ``repro.core.table_infer``.

Runs a network through its generated tables: pack each neuron's selected
input codes into a table index and read the output code there.  Must
match the quantized float forward bit for bit.  On CUDA codes the
per-layer chain launches the ``lut_lookup`` kernel and ``fused=True`` a
whole-network kernel (through ``kernels.ops.lut_network``, the engine's
memo: the mixed one after the compiler, else the uniform one when the
slabs fit); on CPU codes both run their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lut_cost import code_width
from repro_torch.core.truth_table import LayerTruthTable
from repro_torch.kernels.lut_lookup import lut_lookup, pack_fan_in_entries


def pack_codes(codes: torch.Tensor, indices, bw_in: int) -> torch.Tensor:
    """(batch, in_features) codes + (O, fi) indices -> (batch, O) table ids.

    Element k of a neuron's fan-in list lands at bits [bw_in*k, bw_in*(k+1)).
    """
    idx = torch.as_tensor(np.asarray(indices, np.int32), device=codes.device)
    return pack_fan_in_entries(codes, idx, bw_in).T


def layer_table_forward(tt: LayerTruthTable,
                        codes: torch.Tensor) -> torch.Tensor:
    """One sparse layer via its truth table: (batch, I) -> (batch, O) codes."""
    dev = codes.device
    idx = torch.from_numpy(np.ascontiguousarray(tt.indices, np.int32)).to(dev)
    table = torch.from_numpy(np.ascontiguousarray(tt.table, np.int32)).to(dev)
    return lut_lookup(codes.to(torch.int32).contiguous(), idx, table,
                      tt.bw_in)


def network_table_forward(tables: list[LayerTruthTable],
                          in_codes: torch.Tensor, fused: bool = False,
                          optimize_level: int | None = None) -> torch.Tensor:
    """Full sparse-stack forward on integer codes, on ``in_codes``' device.

    ``fused=True`` runs the tables through ``kernels.ops.lut_network``, a
    thin wrapper over the engine's identity-keyed memo
    (``repro_torch.engine.cached_compile``): the first call with a set of
    tables compiles them into a ``CompiledLUTNet``, and later calls with the
    same table arrays reuse it (no compiler run, no slab build).
    ``fused=False`` chains :func:`layer_table_forward`.  A serving loop
    should compile once and keep the artifact instead.

    ``optimize_level`` (0-3, or 4) first runs the truth-table compiler
    (``repro_torch.compile``) over the stack; the output stays bit-identical
    on every reachable input.  With ``fused=True`` the engine runs the
    compiler and serves its compact mixed-width lowering (the mixed fused
    kernel) when its slabs fit; with ``fused=False`` the per-layer kernel
    runs the compiler's uniform lowering.
    """
    if fused:
        from repro_torch.kernels.ops import lut_network
        return lut_network(in_codes,
                           [(tt.indices, tt.table, tt.bw_in)
                            for tt in tables], fused=True,
                           optimize_level=optimize_level)
    if optimize_level is not None:
        from repro_torch.compile import optimize_tables
        tables = optimize_tables(list(tables), optimize_level,
                                 in_features=in_codes.shape[-1])
    c = in_codes
    for tt in tables:
        c = layer_table_forward(tt, c)
    return c


def table_memory_bytes(tables: list[LayerTruthTable]) -> int:
    """Table 5.1-style storage accounting (packed to minimal int width)."""
    return sum(tt.out_features * tt.n_entries * code_width(tt.bw_out)
               for tt in tables)
