"""Fused whole-network LogicNets LUT inference: slabs, builders, forwards.

The port of ``repro.kernels.lut_network``.  A sparse stack is packed into
slabs once (host numpy) and served by one kernel launch per batch, with
the activations of a batch tile kept in shared memory from the network's
input to its output (``csrc/lut_kernels.cu``).  Two layouts, as in the
reference:

* **uniform** (:class:`NetworkSlabs`) — row-stacked ``(sum O, FI_max)``
  fan-in indices and ``(sum O, E_max)`` tables (int8 when every code fits
  an unsigned byte), entry ``sum_k code[idx[o,k]] << (bw_in * k)``.
  :func:`lut_network` launches ``lut_uniform_forward`` on CUDA tensors.
* **mixed** (:class:`MixedNetworkSlabs`) — the compiler-exact layout:
  per-(neuron, element) indices, shifts and widths, every neuron's table
  back to back in one flat slab (optionally row-deduped through static
  per-neuron offsets), neurons grouped by entry count within a layer and
  the final layer's group sort undone by ``out_perm``.
  :func:`lut_network_mixed` launches ``lut_mixed_forward``.

The slab dataclasses hold torch tensors plus static metadata, exactly the
reference's fields, so ``repro_torch.engine`` saves and loads artifacts
that ``repro.engine`` reads and wrote.  On construction each derives, from
its metadata alone, the small int32 tables its kernel reads (per-layer
rows and shapes; for the mixed layout every neuron's flat table offset
and entry count) and checks that every read the kernel can make lies
inside the slabs.

On CPU tensors the wrappers run the plain-torch forwards, which repeat
the kernels' arithmetic and keep the Pallas kernels' one-hot semantics:
an out-of-range fan-in index reads 0 and an out-of-range entry yields 0.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.lut_lookup import (gather_entries,
                                            pack_fan_in_entries,
                                            pack_fan_in_entries_mixed,
                                            require, stream_of)

# The fused kernels keep two (tile_b, bus width) int32 activation buffers
# in shared memory and cap them at the 48 KiB a block gets without an
# opt-in attribute; the slab budget (kernels.plan) is what is left.
ACT_SMEM_BYTES = 48 * 1024
FUSED_TILE_B = 32


def fused_tile_b(bus_width: int) -> int:
    """Batch rows per CTA of the fused kernels for a given widest bus."""
    tile = min(FUSED_TILE_B, ACT_SMEM_BYTES // (2 * 4 * bus_width))
    if tile < 1:
        raise ValueError(
            f"a bus of {bus_width} codes does not fit the fused kernels' "
            f"{ACT_SMEM_BYTES}-byte activation tile; use the per-layer "
            f"layout (fused=False)")
    return tile


def _widen(codes: torch.Tensor, packed: bool) -> torch.Tensor:
    """Codes read from an int8-packed table are unsigned bytes: widen them
    with ``& 0xFF``."""
    return (codes.to(torch.int32) & 0xFF) if packed else codes


def _check_slab(t: torch.Tensor, name: str, dtype: torch.dtype,
                shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}; expected "
                         f"{dtype} {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class LayerMeta(NamedTuple):
    """Static per-layer shape metadata of the uniform layout."""

    n_out: int
    fan_in: int
    n_entries: int
    bw_in: int


@dataclasses.dataclass(frozen=True)
class NetworkSlabs:
    """A whole sparse stack packed for one fused kernel (uniform layout)."""

    idx_slab: torch.Tensor     # (sum_l O_l, FI_max) int32
    table_slab: torch.Tensor   # (sum_l O_l, E_max) int32 | int8 (packed)
    meta: tuple[LayerMeta, ...]
    packed: bool
    # derived: (n_layers, 5) int32 row0, n_out, fan_in, n_entries, bw_in
    layer_meta: torch.Tensor = dataclasses.field(init=False, repr=False)
    # derived: (n_out,) int32 identity, the kernel's output order
    perm: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if not self.meta:
            raise ValueError("fused network needs at least one layer")
        o_sum = sum(m.n_out for m in self.meta)
        fi_max = self.idx_slab.shape[1] if self.idx_slab.dim() == 2 else -1
        e_max = self.table_slab.shape[1] if self.table_slab.dim() == 2 else -1
        _check_slab(self.idx_slab, "idx_slab", torch.int32, (o_sum, fi_max))
        _check_slab(self.table_slab, "table_slab",
                    torch.int8 if self.packed else torch.int32,
                    (o_sum, e_max))
        rows, row = [], 0
        for m in self.meta:
            if not (0 <= m.fan_in <= fi_max and 0 < m.n_entries <= e_max):
                raise ValueError(f"layer {m} does not fit slabs of "
                                 f"FI_max={fi_max}, E_max={e_max}")
            rows.append((row, m.n_out, m.fan_in, m.n_entries, m.bw_in))
            row += m.n_out
        dev = self.idx_slab.device
        object.__setattr__(self, "layer_meta", torch.tensor(
            rows, dtype=torch.int32, device=dev))
        object.__setattr__(self, "perm", torch.arange(
            self.n_out, dtype=torch.int32, device=dev))

    @property
    def n_layers(self) -> int:
        return len(self.meta)

    @property
    def n_out(self) -> int:
        return self.meta[-1].n_out

    def slab_breakdown(self) -> dict:
        """Per-slab bytes (the reference's ``vmem_breakdown`` keys)."""
        idx = self.idx_slab.numel() * self.idx_slab.element_size()
        tab = self.table_slab.numel() * self.table_slab.element_size()
        return {"idx_slab_bytes": idx, "table_slab_bytes": tab,
                "total_bytes": idx + tab, "packed_int8": self.packed}


def estimate_slab_bytes(layers: Sequence[tuple],
                        pack: bool | None = None) -> tuple[int, bool, bool]:
    """Projected uniform-slab bytes, int8-pack and f32-exact eligibility.

    From shapes plus one min/max pass over the tables; returns ``(bytes,
    pack, f32_exact)``.  ``f32_exact`` (every code in ``[0, 2^24)``) is the
    reference kernels' limit; the port keeps it so both packages choose
    the same layout and every artifact stays servable by both.
    """
    o_sum = sum(np.asarray(t).shape[0] for _, t, _ in layers)
    fi_max = max(np.asarray(i).shape[1] for i, _, _ in layers)
    e_max = max(np.asarray(t).shape[1] for _, t, _ in layers)
    lo_hi = [(int(np.min(t, initial=0)), int(np.max(t, initial=0)))
             for _, t, _ in layers]
    byte_ok = all(lo >= 0 and hi < 256 for lo, hi in lo_hi)
    f32_exact = all(lo >= 0 and hi < 1 << 24 for lo, hi in lo_hi)
    use_pack = _resolve_pack(byte_ok, pack)
    table_itemsize = 1 if use_pack else 4
    return (o_sum * fi_max * 4
            + o_sum * e_max * table_itemsize), use_pack, f32_exact


def _resolve_pack(byte_ok: bool, pack: bool | None) -> bool:
    """None auto-packs when every code fits an unsigned byte; an explicit
    True outside that range raises (the uint8 store would wrap codes)."""
    if pack is None:
        return byte_ok
    if pack and not byte_ok:
        raise ValueError(
            "pack=True stores table codes as unsigned bytes; these tables "
            "hold codes outside [0, 256) — use pack=None (auto) or "
            "pack=False")
    return pack


def _check_f32_exact(lo: int, hi: int) -> None:
    if hi >= 1 << 24 or lo < 0:
        raise ValueError(
            "fused slabs hold output codes in [0, 2^24) (the reference "
            "kernels' exact range, kept so artifacts serve in both "
            "packages) — use the per-layer path (fused=False) for wider "
            "codes")


def build_network_slabs(layers: Sequence[tuple], *, pack: bool | None = None,
                        device=None) -> NetworkSlabs:
    """Pack ``(indices, table, bw_in)`` triples into uniform fused slabs."""
    if not layers:
        raise ValueError("fused network needs at least one layer")
    dev = resolve_device(device)
    metas, idx_np, tab_np = [], [], []
    for indices, table, bw_in in layers:
        idx = np.asarray(indices, dtype=np.int32)
        tab = np.asarray(table, dtype=np.int32)
        m = LayerMeta(tab.shape[0], idx.shape[1], tab.shape[1], int(bw_in))
        if m.n_entries != 1 << (m.fan_in * m.bw_in):
            raise ValueError(
                f"table has {m.n_entries} entries; fan_in={m.fan_in} at "
                f"bw_in={m.bw_in} requires 2^{m.fan_in * m.bw_in}")
        _check_f32_exact(int(tab.min(initial=0)), int(tab.max(initial=0)))
        metas.append(m)
        idx_np.append(idx)
        tab_np.append(tab)
    o_sum = sum(m.n_out for m in metas)
    fi_max = max(m.fan_in for m in metas)
    e_max = max(m.n_entries for m in metas)

    idx_slab = np.zeros((o_sum, fi_max), dtype=np.int32)
    pack = _resolve_pack(
        all(int(t.max(initial=0)) < 256 and int(t.min(initial=0)) >= 0
            for t in tab_np), pack)
    table_slab = np.zeros((o_sum, e_max),
                          dtype=np.int8 if pack else np.int32)
    row = 0
    for idx, tab, m in zip(idx_np, tab_np, metas):
        idx_slab[row:row + m.n_out, :m.fan_in] = idx
        table_slab[row:row + m.n_out, :m.n_entries] = (
            tab.astype(np.uint8).view(np.int8) if pack else tab)
        row += m.n_out
    return NetworkSlabs(torch.from_numpy(idx_slab).to(dev),
                        torch.from_numpy(table_slab).to(dev),
                        tuple(metas), bool(pack))


def lut_network_plain(codes: torch.Tensor,
                      slabs: NetworkSlabs) -> torch.Tensor:
    """Plain-torch version of the uniform fused kernel."""
    h = codes
    row = 0
    for m in slabs.meta:
        idx = slabs.idx_slab[row:row + m.n_out, :m.fan_in]
        tab = slabs.table_slab[row:row + m.n_out, :m.n_entries]
        entry = pack_fan_in_entries(h, idx, m.bw_in).T      # (bb, O)
        h = _widen(gather_entries(tab, entry), slabs.packed)
        row += m.n_out
    return h


def _fused_args(codes: torch.Tensor, slabs) -> tuple:
    """Shared checks of both fused wrappers -> (out, tile_b, bus width)."""
    dev = codes.device
    require(codes, "codes", (torch.int32,), 2, dev)
    if slabs.idx_slab.device != dev:
        raise ValueError(f"codes are on {dev}, slabs on "
                         f"{slabs.idx_slab.device}")
    ld = max(codes.shape[1], *(m.n_out for m in slabs.meta))
    out = torch.empty((codes.shape[0], slabs.n_out), dtype=torch.int32,
                      device=dev)
    return out, fused_tile_b(ld), ld


def lut_network(codes: torch.Tensor, slabs: NetworkSlabs) -> torch.Tensor:
    """Whole sparse stack, uniform slabs: (batch, I0) -> (batch, O_last).

    CUDA tensors launch the fused uniform kernel (``launches`` counts those
    launches); CPU tensors run :func:`lut_network_plain`.
    """
    dev = codes.device
    if dev.type == "cpu":
        return lut_network_plain(codes, slabs)
    if dev.type != "cuda":
        raise ValueError(f"lut_network runs on cuda or cpu, not {dev}")
    out, tile_b, ld = _fused_args(codes, slabs)
    if codes.shape[0] == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.lut_uniform_forward(
            codes.data_ptr(), codes.shape[0], codes.shape[1],
            slabs.idx_slab.data_ptr(), slabs.idx_slab.shape[1],
            slabs.table_slab.data_ptr(), slabs.table_slab.shape[1],
            int(slabs.packed), slabs.layer_meta.data_ptr(), slabs.n_layers,
            slabs.perm.data_ptr(), slabs.n_out,
            tile_b, ld, out.data_ptr(), stream_of(dev))
    _build.check(err, "lut_uniform_forward")
    lut_network.launches += 1
    return out


lut_network.launches = 0


# ---------------------------------------------------------------------------
# Mixed-width layout: compiler-exact slabs
# ---------------------------------------------------------------------------


class MixedGroupMeta(NamedTuple):
    """One equal-entry-count neuron group inside a layer (static).

    ``offs`` holds each neuron's entry offset into the flat table slab when
    row dedup shared storage across neurons; None means the group's tables
    sit back to back at the running flat offset.
    """

    n_out: int
    entry_bits: int
    offs: tuple[int, ...] | None = None


class MixedLayerMeta(NamedTuple):
    """Static per-layer shape metadata of the mixed layout."""

    n_out: int
    fan_in: int
    groups: tuple[MixedGroupMeta, ...]


@dataclasses.dataclass(frozen=True)
class MixedNetworkSlabs:
    """A sparse stack packed at its exact compiled table footprint.

    ``out_perm`` undoes the final layer's group sort:
    ``result[:, j] == bus[:, out_perm[j]]`` (None when it is the identity).
    Intermediate layers need no fixup: the builder rewired each layer's
    fan-in indices against its producer's sorted bus.
    """

    idx_slab: torch.Tensor     # (sum_l O_l, FI_max) int32
    shift_slab: torch.Tensor   # (sum_l O_l, FI_max) int32
    width_slab: torch.Tensor   # (sum_l O_l, FI_max) int32
    table_slab: torch.Tensor   # (1, sum_j 2^entry_bits_j) int32 | int8
    meta: tuple[MixedLayerMeta, ...]
    out_perm: tuple[int, ...] | None
    packed: bool
    # table entries elided by build-time row dedup
    dedup_entries_saved: int = 0
    # derived: (n_layers, 3) int32 row0, n_out, fan_in
    layer_meta: torch.Tensor = dataclasses.field(init=False, repr=False)
    # derived: (sum O, 2) int32 flat table offset, n_entries per neuron
    row_meta: torch.Tensor = dataclasses.field(init=False, repr=False)
    # derived: (n_out,) int32 out_perm (the identity when None)
    perm: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if not self.meta:
            raise ValueError("fused network needs at least one layer")
        o_sum = sum(m.n_out for m in self.meta)
        fi_max = self.idx_slab.shape[1] if self.idx_slab.dim() == 2 else -1
        for name in ("idx_slab", "shift_slab", "width_slab"):
            _check_slab(getattr(self, name), name, torch.int32,
                        (o_sum, fi_max))
        t_total = self.table_slab.numel()
        _check_slab(self.table_slab, "table_slab",
                    torch.int8 if self.packed else torch.int32,
                    (1, t_total))
        layers, rows = [], []
        row = flat = 0
        for m in self.meta:
            if not 0 <= m.fan_in <= fi_max:
                raise ValueError(f"layer fan_in {m.fan_in} does not fit "
                                 f"FI_max={fi_max}")
            if sum(g.n_out for g in m.groups) != m.n_out:
                raise ValueError(f"layer groups do not cover its "
                                 f"{m.n_out} neurons")
            layers.append((row, m.n_out, m.fan_in))
            row += m.n_out
            for g in m.groups:
                n_e = 1 << g.entry_bits
                if g.offs is None:
                    offs = [flat + i * n_e for i in range(g.n_out)]
                    flat += g.n_out * n_e
                elif len(g.offs) == g.n_out:
                    offs = list(g.offs)
                else:
                    raise ValueError("group offs must name every neuron")
                for off in offs:
                    if not 0 <= off <= t_total - n_e:
                        raise ValueError(
                            f"neuron table [{off}, {off + n_e}) lies "
                            f"outside the {t_total}-entry table slab")
                    rows.append((off, n_e))
        n_out = self.meta[-1].n_out
        perm = list(range(n_out)) if self.out_perm is None \
            else list(self.out_perm)
        if sorted(perm) != list(range(n_out)):
            raise ValueError(f"out_perm is not a permutation of {n_out}")
        dev = self.idx_slab.device
        for name, val in (("layer_meta", layers), ("row_meta", rows),
                          ("perm", perm)):
            object.__setattr__(self, name, torch.tensor(
                val, dtype=torch.int32, device=dev))

    @property
    def n_layers(self) -> int:
        return len(self.meta)

    @property
    def n_out(self) -> int:
        return self.meta[-1].n_out

    def slab_breakdown(self) -> dict:
        """Per-slab bytes (the reference's ``vmem_breakdown`` keys).

        With ``packed_int8`` the table slab costs one byte per stored entry,
        exactly the compiler's per-neuron table accounting.
        """
        def size(t):
            return t.numel() * t.element_size()
        idx, sh, wd, tab = (size(self.idx_slab), size(self.shift_slab),
                            size(self.width_slab), size(self.table_slab))
        return {"idx_slab_bytes": idx, "shift_slab_bytes": sh,
                "width_slab_bytes": wd, "table_slab_bytes": tab,
                "total_bytes": idx + sh + wd + tab,
                "packed_int8": self.packed, "layout": "mixed"}


def _table_entries(L) -> int:
    return int(sum(np.asarray(t).shape[0] for t in L.tables))


def _mixed_lo_hi(layers) -> tuple[int, int]:
    lo = min((int(np.min(t)) for L in layers for t in L.tables
              if np.size(t)), default=0)
    hi = max((int(np.max(t)) for L in layers for t in L.tables
              if np.size(t)), default=0)
    return lo, hi


def estimate_mixed_slab_bytes(layers,
                              pack: bool | None = None
                              ) -> tuple[int, bool, bool]:
    """Projected mixed-slab bytes, int8-pack and f32-exact eligibility.

    ``layers`` is a sequence of the compiler's mixed-width layer tables
    (fields ``indices``, ``shifts``, ``elem_widths``, ``entry_bits``,
    ``tables``).  A pre-dedup upper bound: row dedup can only shrink the
    table slab below it.
    """
    o_sum = sum(L.indices.shape[0] for L in layers)
    fi_max = max(L.indices.shape[1] for L in layers)
    entries = sum(_table_entries(L) for L in layers)
    lo, hi = _mixed_lo_hi(layers)
    use_pack = _resolve_pack(lo >= 0 and hi < 256, pack)
    f32_exact = lo >= 0 and hi < 1 << 24
    return (3 * o_sum * fi_max * 4
            + entries * (1 if use_pack else 4)), use_pack, f32_exact


def build_mixed_network_slabs(layers, *, pack: bool | None = None,
                              dedup: bool = True,
                              device=None) -> MixedNetworkSlabs:
    """Pack the compiler's mixed-width layer tables into fused slabs.

    Host-side numpy, the same algorithm as the reference: within each layer
    neurons are stably sorted by entry count so equal-size tables form
    contiguous groups; the next layer's indices are rewritten against the
    sorted bus and only the final layer's permutation is kept
    (``out_perm``).  ``dedup=True`` stores byte-identical tables once and
    records every neuron's flat offset — only when a duplicate exists, so a
    dup-free build is byte-identical to ``dedup=False``.
    """
    layers = list(layers)
    if not layers:
        raise ValueError("fused network needs at least one layer")
    dev = resolve_device(device)
    lo, hi = _mixed_lo_hi(layers)
    _check_f32_exact(lo, hi)
    pack = _resolve_pack(lo >= 0 and hi < 256, pack)

    fi_max = max(L.indices.shape[1] for L in layers)
    layer_meta_rows = []
    idx_rows, shift_rows, width_rows, flat_parts = [], [], [], []
    seen: dict[tuple[int, bytes], int] = {}
    next_off = 0
    entries_total = 0
    any_dup = False
    inv_prev: np.ndarray | None = None   # prev bus: old feature -> new pos
    for L in layers:
        o, fi = L.indices.shape
        idx = np.asarray(L.indices, dtype=np.int32)
        if inv_prev is not None:
            idx = inv_prev[idx].astype(np.int32)
        eb = np.asarray(L.entry_bits, dtype=np.int64)
        order = np.argsort(eb, kind="stable")
        idx = idx[order]
        shifts = np.asarray(L.shifts, dtype=np.int32)[order]
        widths = np.asarray(L.elem_widths, dtype=np.int32)[order]
        eb = eb[order]
        bounds = []
        start = 0
        for j in range(1, o + 1):
            if j == o or eb[j] != eb[start]:
                bounds.append((start, j, int(eb[start])))
                start = j
        offs = []
        for j, src in enumerate(order):
            t = np.asarray(L.tables[src], dtype=np.int32)
            if t.shape[0] != 1 << int(eb[j]):
                raise ValueError(
                    f"neuron table has {t.shape[0]} entries; its element "
                    f"widths sum to {int(eb[j])} bits and require "
                    f"2^{int(eb[j])}")
            entries_total += t.shape[0]
            off = seen.get((t.shape[0], t.tobytes())) if dedup else None
            if off is None:
                off = next_off
                if dedup:
                    seen[(t.shape[0], t.tobytes())] = off
                flat_parts.append(t)
                next_off += t.shape[0]
            else:
                any_dup = True
            offs.append(off)
        pad = np.zeros((o, fi_max - fi), dtype=np.int32)
        idx_rows.append(np.concatenate([idx, pad], axis=1))
        shift_rows.append(np.concatenate([shifts, pad], axis=1))
        width_rows.append(np.concatenate([widths, pad], axis=1))
        layer_meta_rows.append((o, fi, bounds, offs))
        inv_prev = np.argsort(order)
    metas = tuple(
        MixedLayerMeta(o, fi, tuple(
            MixedGroupMeta(e - s, ebits,
                           tuple(offs[s:e]) if any_dup else None)
            for s, e, ebits in bounds))
        for o, fi, bounds, offs in layer_meta_rows)
    flat = np.concatenate(flat_parts)
    if pack:
        flat = flat.astype(np.uint8).view(np.int8)
    out_perm = (None if np.array_equal(inv_prev, np.arange(len(inv_prev)))
                else tuple(int(p) for p in inv_prev))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return MixedNetworkSlabs(
        t(np.concatenate(idx_rows)), t(np.concatenate(shift_rows)),
        t(np.concatenate(width_rows)), t(flat[None, :]),
        metas, out_perm, bool(pack),
        dedup_entries_saved=entries_total - next_off)


def lut_network_mixed_plain(codes: torch.Tensor,
                            slabs: MixedNetworkSlabs) -> torch.Tensor:
    """Plain-torch version of the mixed fused kernel."""
    h = codes
    table = slabs.table_slab.reshape(-1)
    off, n_e = slabs.row_meta[:, 0], slabs.row_meta[:, 1]
    row = 0
    for m in slabs.meta:
        rows = slice(row, row + m.n_out)
        entry = pack_fan_in_entries_mixed(
            h, slabs.idx_slab[rows, :m.fan_in],
            slabs.shift_slab[rows, :m.fan_in],
            slabs.width_slab[rows, :m.fan_in]).T            # (bb, O)
        ne = n_e[rows]
        ok = (entry >= 0) & (entry < ne)
        pos = off[rows] + torch.minimum(entry.clamp(min=0), ne - 1)
        h = torch.where(ok, _widen(table[pos.long()], slabs.packed),
                        torch.zeros((), dtype=torch.int32, device=h.device))
        row += m.n_out
    return h if slabs.out_perm is None else h[:, slabs.perm.long()]


def lut_network_mixed(codes: torch.Tensor,
                      slabs: MixedNetworkSlabs) -> torch.Tensor:
    """Whole sparse stack, mixed slabs: (batch, I0) -> (batch, O_last).

    CUDA tensors launch the fused mixed kernel (``launches`` counts those
    launches); CPU tensors run :func:`lut_network_mixed_plain`.
    """
    dev = codes.device
    if dev.type == "cpu":
        return lut_network_mixed_plain(codes, slabs)
    if dev.type != "cuda":
        raise ValueError(f"lut_network_mixed runs on cuda or cpu, not {dev}")
    out, tile_b, ld = _fused_args(codes, slabs)
    if codes.shape[0] == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.lut_mixed_forward(
            codes.data_ptr(), codes.shape[0], codes.shape[1],
            slabs.idx_slab.data_ptr(), slabs.shift_slab.data_ptr(),
            slabs.width_slab.data_ptr(), slabs.idx_slab.shape[1],
            slabs.table_slab.data_ptr(), int(slabs.packed),
            slabs.row_meta.data_ptr(), slabs.layer_meta.data_ptr(),
            slabs.n_layers, slabs.perm.data_ptr(), slabs.n_out, tile_b, ld,
            out.data_ptr(), stream_of(dev))
    _build.check(err, "lut_mixed_forward")
    lut_network_mixed.launches += 1
    return out


lut_network_mixed.launches = 0
