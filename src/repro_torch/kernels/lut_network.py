"""Fused whole-network LogicNets LUT inference: slabs, builders, forwards.

The port of ``repro.kernels.lut_network``.  A sparse stack is packed into
slabs once (host numpy) and served by one kernel launch per batch, with
the activations of a batch tile kept in shared memory from the network's
input to its output.  Two layouts, as in the reference:

* **uniform** (:class:`NetworkSlabs`) — row-stacked ``(sum O, FI_max)``
  fan-in indices and ``(sum O, E_max)`` tables (int8 when every code fits
  an unsigned byte), entry ``sum_k code[idx[o,k]] << (bw_in * k)``.
  :func:`lut_network` launches ``lut_uniform_forward`` on CUDA tensors.
* **mixed** (:class:`MixedNetworkSlabs`) — the compiler-exact layout:
  per-(neuron, element) indices, shifts and widths, every neuron's table
  back to back in one flat slab (optionally row-deduped through static
  per-neuron offsets), neurons grouped by entry count within a layer and
  the final layer's group sort undone by ``out_perm``.
  :func:`lut_network_mixed` launches it.

Each layout has two kernels on CUDA tensors, chosen by the pure
:func:`lut_fused_route` from the slabs' shared-memory layout
(:func:`fused_smem_layout`, computed once per slabs object and input
width, and cached on the slabs):

* ``"smem"`` (``csrc/lut_fused_smem.cu``, ``lut_mixed_smem_forward`` /
  ``lut_uniform_smem_forward``): the whole network's read-only state is
  copied into each block's shared memory (1-D bulk copies, one mbarrier a
  stage of layers) and persistent blocks walk the batch tiles; every call
  whose layout fits :data:`SMEM_PER_BLOCK_BYTES`;
* ``"global"`` (``csrc/lut_kernels.cu``, ``lut_mixed_forward`` /
  ``lut_uniform_forward``, the first design): slabs read from global
  memory, for slabs no layout fits.

``launches`` on each wrapper counts its launches and
``launches_by_route`` each route's.  A failed build or launch raises; no
route falls back to another.

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
import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.lut_lookup import (_sm_count, gather_entries,
                                            pack_fan_in_entries,
                                            pack_fan_in_entries_mixed,
                                            require, stream_of)

# The fused kernels keep two (tile_b, bus width) int32 activation buffers
# in shared memory.  The first design (route "global") caps them at the
# 48 KiB a block gets without an opt-in attribute; the slab budget
# (kernels.plan) is what is left of a block's shared memory on an H100.
ACT_SMEM_BYTES = 48 * 1024
FUSED_TILE_B = 32
SMEM_PER_BLOCK_BYTES = 232_448
# The smem route: batch rows a tile and threads a block (from
# tools/lut_smem_sweep.py on the card, PERF.md), and the most mbarriers
# (stages of layers) a layout uses; the kernel's limit, kMaxStages.
SMEM_TILE_B = 32
SMEM_THREADS = 512
SMEM_MIN_TILE_ROWS = 4
SMEM_MAX_STAGES = 8
# regions of the smem layout, in the order of the kernel's arrays
SMEM_ARRAYS = ("elems", "row_meta", "table", "layers", "perm")
_LAYER_COLS = 5          # row0, n_out, fan_in, n_entries, stage


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
    # the smem route's layout and operands by input width (_smem_state)
    _smem: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

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
    # the smem route's layout and operands by input width (_smem_state)
    _smem: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

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
        row = 0
        for m, tables in zip(self.meta, _neuron_tables(self.meta)):
            if not 0 <= m.fan_in <= fi_max:
                raise ValueError(f"layer fan_in {m.fan_in} does not fit "
                                 f"FI_max={fi_max}")
            if sum(g.n_out for g in m.groups) != m.n_out:
                raise ValueError(f"layer groups do not cover its "
                                 f"{m.n_out} neurons")
            layers.append((row, m.n_out, m.fan_in))
            row += m.n_out
            for off, n_e in tables:
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


def _neuron_tables(meta) -> list[list[tuple[int, int]]]:
    """Every neuron's (flat table offset, entry count), layer by layer,
    from the mixed layout's static metadata alone."""
    out, flat = [], 0
    for m in meta:
        tables = []
        for g in m.groups:
            n_e = 1 << g.entry_bits
            if g.offs is None:
                tables += [(flat + i * n_e, n_e) for i in range(g.n_out)]
                flat += g.n_out * n_e
            elif len(g.offs) == g.n_out:
                tables += [(int(off), n_e) for off in g.offs]
            else:
                raise ValueError("group offs must name every neuron")
        out.append(tables)
    return out


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


# ---------------------------------------------------------------------------
# The smem route's layout
# ---------------------------------------------------------------------------


def _round16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class SmemLayout:
    """Where the smem kernels keep a network in a block's shared memory.

    ``regions`` maps ``"barriers"``, each of :data:`SMEM_ARRAYS` and
    ``"act"`` (the two activation buffers) to its ``(offset, bytes)``
    reserved, 16-byte aligned and disjoint; an array's region holds its
    staged bytes (``sizes``) plus 15 bytes, as the kernel shifts the array
    to agree with its source modulo 16 (the alignment padding).
    ``stages[s]`` maps each array to the byte range ``[begin, end)`` that
    stage ``s`` copies (on mbarrier ``s``), and ``wait[l]`` is the last
    stage layer ``l`` must wait on.  ``tile_b`` is the most batch rows a
    tile holds (shrunk until the layout fits; :func:`smem_tile_rows` picks
    a call's rows up to it), ``ld`` the activation row stride (the widest
    bus plus the zero column), ``total_bytes`` the dynamic shared memory a
    block takes; ``fits`` says whether that is within
    :data:`SMEM_PER_BLOCK_BYTES`.  ``plan`` is the same layout as the
    kernel's int32 host array.
    """

    fits: bool
    total_bytes: int
    tile_b: int
    ld: int
    regions: dict
    sizes: dict
    stages: tuple
    wait: tuple
    plan: np.ndarray = dataclasses.field(repr=False, compare=False)


def _layer_tables_hi(slabs) -> list[int]:
    """Per layer, the end (in table entries) of the furthest table range
    any of its neurons reads."""
    if isinstance(slabs, MixedNetworkSlabs):
        return [max((off + n_e for off, n_e in tables), default=0)
                for tables in _neuron_tables(slabs.meta)]
    e_max = slabs.table_slab.shape[1]
    ends, row = [], 0
    for m in slabs.meta:
        row += m.n_out
        ends.append(row * e_max)
    return ends


def fused_smem_layout(slabs, n_in: int) -> SmemLayout:
    """The smem kernels' shared-memory layout of ``slabs`` for codes of
    ``n_in`` columns: a pure function of the slabs' shapes and static
    metadata (no device read).

    Staged: one packed int32 word per (neuron, element) (``elems``), the
    mixed layout's ``row_meta`` (8 bytes a neuron), the table slab as
    stored up to the furthest entry any neuron reads, the per-layer table
    (``layers``, 20 bytes a layer) and ``perm``; then the mbarriers (8 bytes
    a stage) and two ``(tile_b, ld)`` int32 activation buffers.  Layers
    form ``min(n_layers, SMEM_MAX_STAGES)`` stages of consecutive layers;
    stage ``s`` copies its layers' rows of ``elems`` and ``row_meta``, the
    table bytes from where stage ``s - 1`` stopped up to the furthest any
    of its layers reads (a deduplicated neuron may read an earlier
    layer's rows, which an earlier stage copied), the layer table (stage
    0) and ``perm`` (the last stage); a layer waits on its own stage.

    Against ``fused_plan``'s slab estimate the staged arrays add at most
    ``4 n_out + 20 n_layers`` bytes (``elems`` costs 4 bytes an element
    where the estimate counts 12 for a mixed slab and 4 for a uniform
    one, and the 8 bytes of ``row_meta`` a neuron come out of the other
    8), plus 8 a stage and at most 150 of alignment padding; ``tile_b``
    shrinks until the activation buffers fit what is left.  Every slab the
    plan admits fits at ``tile_b`` >= 1 when ``12 ld + 28 n_layers + 160
    <= 49 152`` (the 48 KiB the plan leaves), e.g. every bus of up to
    4 000 codes at 30 layers.
    """
    mixed = isinstance(slabs, MixedNetworkSlabs)
    meta = slabs.meta
    n_layers = len(meta)
    fi_max = slabs.idx_slab.shape[1]
    isz = slabs.table_slab.element_size()
    ld = max(n_in, *(m.n_out for m in meta)) + 1
    n_stages = min(n_layers, SMEM_MAX_STAGES)
    wait = tuple(l * n_stages // n_layers for l in range(n_layers))
    hi = _layer_tables_hi(slabs)
    rows = list(itertools.accumulate((m.n_out for m in meta), initial=0))
    stages = []
    table_end = 0
    for st in range(n_stages):
        ls = [l for l in range(n_layers) if wait[l] == st]
        r0, r1 = rows[ls[0]], rows[ls[-1] + 1]
        begin = table_end
        table_end = max(table_end, *(hi[l] * isz for l in ls))
        stages.append({
            "elems": (r0 * fi_max * 4, r1 * fi_max * 4),
            "row_meta": (r0 * 8, r1 * 8) if mixed else (0, 0),
            "table": (begin, table_end),
            "layers": (0, n_layers * _LAYER_COLS * 4) if st == 0 else (0, 0),
            "perm": ((0, slabs.n_out * 4) if st == n_stages - 1
                     else (0, 0)),
        })
    sizes = {a: max(st[a][1] for st in stages) for a in SMEM_ARRAYS}
    regions = {"barriers": (0, 8 * n_stages)}
    off = _round16(8 * n_stages)
    for a in SMEM_ARRAYS:
        size = _round16(sizes[a] + 15) if sizes[a] else 0
        regions[a] = (off, size)
        off += size
    room = (SMEM_PER_BLOCK_BYTES - off) // (2 * 4 * ld)
    tile_b = max(0, min(SMEM_TILE_B, room))
    regions["act"] = (off, 2 * 4 * tile_b * ld)
    total = off + regions["act"][1]
    fits = (tile_b >= 1 and total <= SMEM_PER_BLOCK_BYTES
            and ld <= 0xFFFF)
    plan = [n_layers, n_stages, fi_max,
            0 if mixed else slabs.table_slab.shape[1], ld, tile_b, off,
            total, slabs.n_out, *(regions[a][0] for a in SMEM_ARRAYS)]
    for st in stages:
        for a in SMEM_ARRAYS:
            plan += st[a]
    return SmemLayout(fits, total, tile_b, ld, regions, sizes,
                      tuple(stages), wait, np.asarray(plan, dtype=np.int32))


def smem_tile_rows(batch: int, tile_b: int, sms: int) -> int:
    """Batch rows a tile of the smem kernels: enough tiles to give each of
    ``sms`` SMs one, but at least ``SMEM_MIN_TILE_ROWS`` rows and at most
    the layout's ``tile_b`` (on an H100, batch 16: 4 tiles of 4; 1000:
    125 of 8; 4096: 128 of 32)."""
    return max(1, min(tile_b, max(SMEM_MIN_TILE_ROWS, -(-batch // sms))))


def lut_fused_route(layout: SmemLayout) -> str:
    """Which kernel a CUDA call takes: ``"smem"`` when the slabs' layout
    fits a block's shared memory, else ``"global"`` (the first design)."""
    return "smem" if layout.fits else "global"


class SmemOperands(NamedTuple):
    """The smem kernels' derived device tables (built once per layout)."""

    elems: torch.Tensor     # (sum O, FI_max) int32 packed words
    layers: torch.Tensor    # (n_layers, 5) int32 row0, n_out, fan_in,
    #                         n_entries (uniform; 0 mixed), stage


def smem_operands(slabs, n_in: int, layout: SmemLayout) -> SmemOperands:
    """Pack, on the slabs' device, one int32 word per (neuron, element):
    bits 0-15 the fan-in index (``ld - 1``, a column that stays 0, where
    the index lies outside the layer's input bus), bits 16-20 the shift
    and bits 24-29 the width (32: every bit; a shift outside [0, 32) is
    stored as shift 0, width 0), so the kernel reads one word an element
    and checks no bound; and the per-layer table."""
    mixed = isinstance(slabs, MixedNetworkSlabs)
    idx = slabs.idx_slab.to(torch.int64)
    dev, (o_sum, fi_max) = idx.device, idx.shape
    buses = [n_in] + [m.n_out for m in slabs.meta[:-1]]
    bus = torch.tensor([b for b, m in zip(buses, slabs.meta)
                        for _ in range(m.n_out)], dtype=torch.int64,
                       device=dev)[:, None]
    src = torch.where((idx >= 0) & (idx < bus), idx, layout.ld - 1)
    if mixed:
        shift = slabs.shift_slab.to(torch.int64)
        width = slabs.width_slab.to(torch.int64)
    else:
        bw = torch.tensor([m.bw_in for m in slabs.meta
                           for _ in range(m.n_out)], dtype=torch.int64,
                          device=dev)
        shift = bw[:, None] * torch.arange(fi_max, device=dev)[None, :]
        width = torch.full((o_sum, fi_max), 32, dtype=torch.int64,
                           device=dev)
    width = torch.where((width >= 0) & (width < 32), width, 32)
    ok = (shift >= 0) & (shift < 32)
    word = (src | (torch.where(ok, shift, 0) << 16)
            | (torch.where(ok, width, 0) << 24))
    rows, row = [], 0
    for m, st in zip(slabs.meta, layout.wait):
        rows.append((row, m.n_out, m.fan_in,
                     0 if mixed else m.n_entries, st))
        row += m.n_out
    return SmemOperands(word.to(torch.int32).contiguous(),
                        torch.tensor(rows, dtype=torch.int32, device=dev))


class SmemState(NamedTuple):
    """A slabs object's smem route at one input width: its layout, and
    where it fits, the derived tables, the kernel's entry point and its
    operands after ``n_in`` (pointers and the plan, fixed for the slabs
    object), so a call converts only the codes, the output and the
    launch shape."""

    layout: SmemLayout
    ops: SmemOperands | None
    entry: str
    operands: tuple


def _smem_state(slabs, n_in: int) -> SmemState:
    """The :class:`SmemState` of ``slabs`` at input width ``n_in``,
    computed at the first call and cached on the slabs object."""
    state = slabs._smem.get(n_in)
    if state is None:
        layout = fused_smem_layout(slabs, n_in)
        ops, entry, operands = None, "", ()
        if layout.fits:
            ops = smem_operands(slabs, n_in, layout)
            mixed = isinstance(slabs, MixedNetworkSlabs)
            entry = ("lut_mixed_smem_forward" if mixed
                     else "lut_uniform_smem_forward")
            rows = (slabs.row_meta.data_ptr(),) if mixed else ()
            operands = (ops.elems.data_ptr(), *rows,
                        slabs.table_slab.data_ptr(), int(slabs.packed),
                        ops.layers.data_ptr(), slabs.perm.data_ptr(),
                        layout.plan.ctypes.data)
        state = slabs._smem[n_in] = SmemState(layout, ops, entry, operands)
    return state


# ---------------------------------------------------------------------------
# The fused forwards
# ---------------------------------------------------------------------------


def _fused_args(codes: torch.Tensor, slabs, name: str):
    """Shared checks of both fused wrappers -> the output, or None on the
    CPU (the caller runs the plain version)."""
    dev = codes.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    require(codes, "codes", (torch.int32,), 2, dev)
    if slabs.idx_slab.device != dev:
        raise ValueError(f"codes are on {dev}, slabs on "
                         f"{slabs.idx_slab.device}")
    return torch.empty((codes.shape[0], slabs.n_out), dtype=torch.int32,
                       device=dev)


def _launch_global(codes: torch.Tensor, slabs, out: torch.Tensor) -> None:
    """The first design (``csrc/lut_kernels.cu``) on checked operands."""
    dev = codes.device
    ld = max(codes.shape[1], *(m.n_out for m in slabs.meta))
    tile_b = fused_tile_b(ld)
    lib = _build.library()
    with torch.cuda.device(dev):
        if isinstance(slabs, MixedNetworkSlabs):
            name = "lut_mixed_forward"
            err = lib.lut_mixed_forward(
                codes.data_ptr(), codes.shape[0], codes.shape[1],
                slabs.idx_slab.data_ptr(), slabs.shift_slab.data_ptr(),
                slabs.width_slab.data_ptr(), slabs.idx_slab.shape[1],
                slabs.table_slab.data_ptr(), int(slabs.packed),
                slabs.row_meta.data_ptr(), slabs.layer_meta.data_ptr(),
                slabs.n_layers, slabs.perm.data_ptr(), slabs.n_out, tile_b,
                ld, out.data_ptr(), stream_of(dev))
        else:
            name = "lut_uniform_forward"
            err = lib.lut_uniform_forward(
                codes.data_ptr(), codes.shape[0], codes.shape[1],
                slabs.idx_slab.data_ptr(), slabs.idx_slab.shape[1],
                slabs.table_slab.data_ptr(), slabs.table_slab.shape[1],
                int(slabs.packed), slabs.layer_meta.data_ptr(),
                slabs.n_layers, slabs.perm.data_ptr(), slabs.n_out,
                tile_b, ld, out.data_ptr(), stream_of(dev))
    _build.check(err, name)


def _launch_smem(codes: torch.Tensor, out: torch.Tensor,
                 state: SmemState, *, threads: int | None = None,
                 tile_rows: int | None = None, bulk: bool = True) -> None:
    """The smem kernel (``csrc/lut_fused_smem.cu``) on checked operands
    (``out`` contiguous) in a layout that fits; ``threads``, ``tile_rows``
    and ``bulk=False`` (one barrier, 16-byte loads by every thread) are
    for the design sweep."""
    dev = codes.device
    batch, n_in = codes.shape
    layout = state.layout
    rows = tile_rows or smem_tile_rows(batch, layout.tile_b,
                                       _sm_count(dev.index))
    with torch.cuda.device(dev):
        err = getattr(_build.library(), state.entry)(
            codes.data_ptr(), batch, n_in, *state.operands,
            threads or SMEM_THREADS, rows, int(bulk), out.data_ptr(),
            stream_of(dev))
    _build.check(err, state.entry)


def _fused_forward(wrapper, codes: torch.Tensor, slabs,
                   out: torch.Tensor) -> torch.Tensor:
    if codes.shape[0] == 0:
        return out
    state = _smem_state(slabs, codes.shape[1])
    route = lut_fused_route(state.layout)
    if route == "smem":
        _launch_smem(codes, out, state)
    else:
        _launch_global(codes, slabs, out)
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1
    return out


def lut_network(codes: torch.Tensor, slabs: NetworkSlabs) -> torch.Tensor:
    """Whole sparse stack, uniform slabs: (batch, I0) -> (batch, O_last).

    CUDA tensors launch the route :func:`lut_fused_route` picks
    (``launches`` and ``launches_by_route`` count them); CPU tensors run
    :func:`lut_network_plain`.
    """
    out = _fused_args(codes, slabs, "lut_network")
    if out is None:
        return lut_network_plain(codes, slabs)
    return _fused_forward(lut_network, codes, slabs, out)


def lut_network_mixed(codes: torch.Tensor,
                      slabs: MixedNetworkSlabs) -> torch.Tensor:
    """Whole sparse stack, mixed slabs: (batch, I0) -> (batch, O_last).

    CUDA tensors launch the route :func:`lut_fused_route` picks
    (``launches`` and ``launches_by_route`` count them); CPU tensors run
    :func:`lut_network_mixed_plain`.
    """
    out = _fused_args(codes, slabs, "lut_network_mixed")
    if out is None:
        return lut_network_mixed_plain(codes, slabs)
    return _fused_forward(lut_network_mixed, codes, slabs, out)


for _wrapper in (lut_network, lut_network_mixed):
    _wrapper.launches = 0
    _wrapper.launches_by_route = {"smem": 0, "global": 0}
