"""LogicNets LUT-layer inference: the per-layer kernel and its helpers.

``lut_lookup`` is one LUT layer, ``(B, I) -> (B, O)``: gather each
neuron's fan-in codes, pack them into a table entry, read the neuron's
truth table there.  On a CUDA tensor it launches ``lut_layer_forward``
(``csrc/lut_kernels.cu``), which replaces the Pallas
``repro.kernels.lut_lookup.lut_lookup_pallas``; on a CPU tensor it runs
``lut_lookup_plain``, the same arithmetic in plain torch.  Both keep the
Pallas kernel's one-hot semantics: a fan-in index outside the input bus
reads 0, and an entry outside the table yields 0.

The packing helpers are shared with the fused network forwards
(``repro_torch.kernels.lut_network``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# The engine's default batch bucket, as in the reference (an artifact's
# ExecutionPlan carries its own block_b).
DEFAULT_BLOCK_B = 128

_INT32_MAX = 2 ** 31 - 1


def gather_fan_in_codes(codes: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """(bb, I) codes + (bo, FI) indices -> (bo, FI, bb) gathered codes.

    An index outside ``[0, I)`` gathers 0, as the Pallas kernels' one-hot
    contraction does.
    """
    n_in = codes.shape[1]
    valid = (idx >= 0) & (idx < n_in)
    g = codes[:, idx.clamp(0, max(n_in - 1, 0)).long()]     # (bb, bo, FI)
    g = torch.where(valid, g, torch.zeros((), dtype=g.dtype,
                                          device=g.device))
    return g.permute(1, 2, 0)


def pack_fan_in_entries(codes: torch.Tensor, idx: torch.Tensor,
                        bw_in: int) -> torch.Tensor:
    """(bb, I) codes + (bo, FI) indices -> (bo, bb) packed table entries:
    ``entry = sum_k code[idx[o, k]] << (bw_in * k)``."""
    fan_in = idx.shape[1]
    g = gather_fan_in_codes(codes, idx)                     # (bo, FI, bb)
    shifts = bw_in * torch.arange(fan_in, dtype=torch.int32,
                                  device=codes.device)
    return (g << shifts[None, :, None]).sum(1, dtype=torch.int32)


def pack_fan_in_entries_mixed(codes: torch.Tensor, idx: torch.Tensor,
                              shifts: torch.Tensor,
                              widths: torch.Tensor) -> torch.Tensor:
    """Mixed-width packing: per-(neuron, element) shifts and widths.

    Element k of neuron j lands at bits ``[shifts[j,k], shifts[j,k] +
    widths[j,k])`` of its entry; a width of 0 marks a padded element,
    whose mask zeroes its contribution.
    """
    g = gather_fan_in_codes(codes, idx)                     # (bo, FI, bb)
    mask = (torch.ones_like(widths) << widths) - 1
    g = g & mask[:, :, None]
    return (g << shifts[:, :, None]).sum(1, dtype=torch.int32)


def gather_entries(table: torch.Tensor, entry: torch.Tensor) -> torch.Tensor:
    """``out[b, o] = table[o, entry[b, o]]`` for (O, E) tables, 0 where the
    entry lies outside ``[0, E)``."""
    n_e = table.shape[1]
    ok = (entry >= 0) & (entry < n_e)
    val = table.gather(1, entry.clamp(0, n_e - 1).T.long()).T
    return torch.where(ok, val, torch.zeros((), dtype=val.dtype,
                                            device=val.device))


def lut_lookup_plain(codes: torch.Tensor, idx: torch.Tensor,
                     table: torch.Tensor, bw_in: int) -> torch.Tensor:
    """Plain-torch version of the per-layer kernel: (B, I) -> (B, O)."""
    return gather_entries(table, pack_fan_in_entries(codes, idx, bw_in).T)


def require(t: torch.Tensor, name: str, dtypes, ndim: int,
            device: torch.device) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; expected one of "
                        f"{tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() > _INT32_MAX:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         f"take int32 sizes")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lut_lookup(codes: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
               bw_in: int) -> torch.Tensor:
    """(batch, I) int32 codes -> (batch, O) int32 codes, one LUT layer.

    ``idx`` is ``(O, FI)`` int32, ``table`` ``(O, E)`` int32.  CUDA tensors
    launch the per-layer kernel (``launches`` counts those launches); CPU
    tensors run :func:`lut_lookup_plain`.
    """
    dev = codes.device
    if dev.type == "cpu":
        return lut_lookup_plain(codes, idx, table, bw_in)
    if dev.type != "cuda":
        raise ValueError(f"lut_lookup runs on cuda or cpu, not {dev}")
    i32 = (torch.int32,)
    require(codes, "codes", i32, 2, dev)
    require(idx, "idx", i32, 2, dev)
    require(table, "table", i32, 2, dev)
    batch, n_in = codes.shape
    n_out, fan_in = idx.shape
    if table.shape[0] != n_out:
        raise ValueError(f"table has {table.shape[0]} rows for {n_out} "
                         f"neurons")
    out = torch.empty((batch, n_out), dtype=torch.int32, device=dev)
    if batch == 0 or n_out == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.lut_layer_forward(
            codes.data_ptr(), batch, n_in, idx.data_ptr(), n_out, fan_in,
            table.data_ptr(), table.shape[1], int(bw_in), out.data_ptr(),
            stream_of(dev))
    _build.check(err, "lut_layer_forward")
    lut_lookup.launches += 1
    return out


lut_lookup.launches = 0
