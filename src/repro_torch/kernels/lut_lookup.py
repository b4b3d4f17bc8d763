"""LogicNets LUT-layer inference: the per-layer kernel and its helpers.

``lut_lookup`` is one LUT layer, ``(B, I) -> (B, O)``: gather each
neuron's fan-in codes, pack them into a table entry, read the neuron's
truth table there.  On a CUDA tensor it launches
``lut_layer_smem_forward`` (``csrc/lut_layer_smem.cu``), which replaces
the Pallas ``repro.kernels.lut_lookup.lut_lookup_pallas``, as a
programmatic dependent launch, on one of two routes that the pure
:func:`lut_layer_route` picks from the shapes and the batch:

* ``"smem"`` (batches up to :data:`LAYER_SMEM_MAX_BATCH`): a block
  stages its neuron tile's tables in shared memory (one 1-D bulk copy,
  issued before the launch waits for the previous layer, so it hides
  under that layer) and walks batch tiles;
* ``"direct"`` (larger batches, a neuron whose table alone passes
  :data:`LAYER_SMEM_BYTES`, or a wide input bus, where every neuron tile
  staging the whole batch's codes costs more than the table reads it
  saves): tables are read in place.

``launches`` counts the launches and ``launches_by_route`` each route's.
On a CPU tensor ``lut_lookup`` runs ``lut_lookup_plain``, the same
arithmetic in plain torch.  All keep the Pallas kernel's one-hot
semantics: a fan-in index outside the input bus reads 0, and an entry
outside the table yields 0.

The packing helpers are shared with the fused network forwards
(``repro_torch.kernels.lut_network``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# The engine's default batch bucket, as in the reference (an artifact's
# ExecutionPlan carries its own block_b).
DEFAULT_BLOCK_B = 128

_INT32_MAX = 2 ** 31 - 1

# The per-layer kernel's geometry (tools/lut_layer_sweep.py on the card,
# PERF.md).  A block takes at most half of an SM's 232 448 bytes of shared
# memory, so a layer's blocks and the next layer's, which launch while it
# runs, fit one SM together; where a batch tile of codes alone passes
# that, a block may take all of it.
LAYER_THREADS = 256
LAYER_SMEM_BYTES = 232_448 // 2
LAYER_MAX_SMEM_BYTES = 232_448
# route smem up to this batch: its tables' copy hides under the previous
# layer and its reads come from shared memory; above it, staging a layer's
# tables in every block group costs more than it saves
LAYER_SMEM_MAX_BATCH = 256
# rows a batch tile of route smem: enough tiles for every SM, within
# these bounds
LAYER_MIN_ROWS = 16
LAYER_SMEM_TILE_B = 128
# neurons a tile (at most): route smem, route direct (which takes more
# on a wide input bus: see LAYER_SECTOR_BYTES)
LAYER_SMEM_TILE_O = 16
LAYER_DIRECT_TILE_O = 32
# bytes of a table read in place, for one output: an L2 sector.  Each
# neuron tile's blocks stage every batch row's n_in codes (4 bytes each),
# so a direct tile takes at least n_in * 4 / LAYER_SECTOR_BYTES neurons
# (to a power of two): the codes it stages then cost no more than the
# sectors its outputs read (tools/lut_layer_sweep.py at the MNIST widths,
# 784 and 2048 inputs: 128 and 256 neurons a tile, 2.2-4.1x faster than
# 32 at 4096 rows)
LAYER_SECTOR_BYTES = 32
# route direct: one output a thread, two where that grid would pass this
# many blocks an SM
LAYER_DIRECT_BLOCKS_PER_SM = 4


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


class LayerRoute(NamedTuple):
    """A call's route and launch geometry: block ``(x, y)`` of the
    ``(grid_o, grid_b)`` grid serves neurons ``[x tile_o, (x + 1)
    tile_o)`` and batch tiles ``y, y + grid_b, ...`` of ``tile_b`` rows,
    with ``threads`` threads and ``smem_bytes`` of dynamic shared
    memory."""

    route: str
    tile_o: int
    tile_b: int
    grid_o: int
    grid_b: int
    threads: int
    smem_bytes: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def layer_smem_bytes(n_in: int, fan_in: int, n_entries: int, tile_o: int,
                     tile_b: int, stage: bool, n_buf: int = 1,
                     elem: int = 4) -> int:
    """A block's dynamic shared memory (the kernel's ``layout``): three
    mbarriers (32 bytes), the staged table rows (route smem, ``elem`` bytes
    an entry), the tile's indices and ``n_buf`` buffers of a batch tile's
    codes, each staged range with 15 bytes of room for its source's offset
    within 16 bytes."""
    table = _round16(elem * tile_o * n_entries + 15) if stage else 0
    return (32 + table + _round16(4 * tile_o * fan_in)
            + n_buf * _round16(4 * tile_b * n_in + 15))


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def staged_codes_bytes(geom: LayerRoute, batch: int, n_in: int) -> int:
    """Bytes of codes a launch at ``geom`` copies into shared memory after
    its wait, summed over its blocks: every neuron tile's blocks stage
    every batch row's ``n_in`` codes."""
    return geom.grid_o * batch * n_in * 4


def _geometry(route: str, batch: int, n_in: int, n_out: int, fan_in: int,
              n_entries: int, sms: int, elem: int, tile_o: int | None,
              tile_b: int | None) -> LayerRoute | None:
    """A route's geometry (see :func:`lut_layer_route`), or None where no
    block of it fits."""
    stage = route == "smem"
    threads = LAYER_THREADS
    cap = tile_o or (LAYER_SMEM_TILE_O if stage else max(
        LAYER_DIRECT_TILE_O, _pow2_at_least(-(-4 * n_in
                                              // LAYER_SECTOR_BYTES))))
    to = min(n_out, threads, cap)
    grid_o = -(-n_out // to)
    to = -(-n_out // grid_o)
    if tile_b:
        tb = tile_b
    elif stage:
        tb = min(LAYER_SMEM_TILE_B, max(LAYER_MIN_ROWS,
                                        -(-batch * grid_o // sms)))
    else:
        tb = max(1, threads // to)
        if -(-batch // tb) * grid_o > LAYER_DIRECT_BLOCKS_PER_SM * sms:
            tb *= 2
    tb = min(tb, batch)

    def fit(to, tb):
        """(grid_b, n_buf, bytes) at these tiles."""
        grid_o = -(-n_out // to)
        n_tiles = -(-batch // tb)
        grid_b = min(n_tiles, max(1, sms // grid_o) if stage else 65535)
        n_buf = 2 if n_tiles > grid_b else 1
        return grid_b, n_buf, layer_smem_bytes(n_in, fan_in, n_entries, to,
                                               tb, stage, n_buf, elem)

    budget = LAYER_SMEM_BYTES
    # the staged tables shrink with the neurons a tile, the codes with the
    # rows: shrink the larger first
    while fit(to, tb)[2] > budget:
        if to > 1 and (stage or tb == 1):
            to = -(-to // 2)
        elif tb > 1:
            tb = -(-tb // 2)
        elif not stage and budget < LAYER_MAX_SMEM_BYTES:
            budget = LAYER_MAX_SMEM_BYTES
        else:
            return None
    grid_b, _, size = fit(to, tb)
    return LayerRoute(route, to, tb, -(-n_out // to), grid_b, threads, size)


@functools.lru_cache(maxsize=None)
def lut_layer_route(batch: int, n_in: int, n_out: int, fan_in: int,
                    n_entries: int, sms: int, elem: int = 4, *,
                    route: str | None = None,
                    tile_o: int | None = None,
                    tile_b: int | None = None) -> LayerRoute:
    """The per-layer kernel's route and geometry for a ``(batch, n_in)``
    call on ``(n_out, fan_in)`` indices and ``(n_out, n_entries)`` tables of
    ``elem``-byte entries on a card of ``sms`` SMs: a pure function of
    those integers, cached, so each (table shape, batch bucket) is worked
    out once.

    Route: ``"smem"`` up to :data:`LAYER_SMEM_MAX_BATCH` rows where its
    block fits and the codes it stages after its wait
    (:func:`staged_codes_bytes`) are no more than route direct's plus one
    table sector (:data:`LAYER_SECTOR_BYTES`) an output, which direct
    reads after its wait and smem staged before it; else ``"direct"``
    (``tools/lut_layer_sweep.py`` on models A and D: staging wins by
    4-10 % at batches 16 to 256, reading in place by 1-17 % at 1000 and
    4096; at the MNIST widths, 784 and 2048 inputs, staging cuts smem's
    neuron tile to 1 where its codes do not fit beside the tables, and
    lost by 14x at 16 rows and 26x at 256).

    Geometry: neurons a tile up to :data:`LAYER_SMEM_TILE_O` (smem) or
    :data:`LAYER_DIRECT_TILE_O` (direct; more on a wide input bus, see
    :data:`LAYER_SECTOR_BYTES`), split evenly; rows a batch tile
    ``ceil(batch grid_o / sms)`` within [:data:`LAYER_MIN_ROWS`,
    :data:`LAYER_SMEM_TILE_B`] (smem), or ``threads // tile_o``, one output
    a thread, doubled where that grid would pass
    :data:`LAYER_DIRECT_BLOCKS_PER_SM` blocks an SM (direct); both shrunk
    until a block fits :data:`LAYER_SMEM_BYTES` (a direct block whose one
    row of codes does not may take :data:`LAYER_MAX_SMEM_BYTES`).  Route
    smem launches ``sms // grid_o`` batch groups (at least one), each
    staging its tables once and walking its batch tiles (two codes buffers
    where it walks more than one); route direct one block a tile.

    ``route``, ``tile_o`` and ``tile_b`` override the rule (for the sweep
    and the tests).  Raises where the route asked for has no block that
    fits.
    """
    if batch < 1 or n_out < 1:
        raise ValueError(f"no launch for batch {batch}, {n_out} neurons")
    if route not in (None, "smem", "direct"):
        raise ValueError(f"unknown route {route!r}")
    args = (batch, n_in, n_out, fan_in, n_entries, sms, elem, tile_o, tile_b)
    if route is None:
        smem = (_geometry("smem", *args)
                if batch <= LAYER_SMEM_MAX_BATCH else None)
        direct = _geometry("direct", *args)
        if smem is not None and (
                direct is None or staged_codes_bytes(smem, batch, n_in)
                <= staged_codes_bytes(direct, batch, n_in)
                + batch * n_out * LAYER_SECTOR_BYTES):
            return smem
        route = "direct"
    geom = _geometry(route, *args)
    if geom is None:
        raise ValueError(
            f"no {route} block fits {LAYER_MAX_SMEM_BYTES} bytes of shared "
            f"memory: {n_in} codes a row, fan-in {fan_in}, {n_entries} "
            f"entries a table")
    return geom


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _layer_args(codes: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
                name: str) -> torch.Tensor | None:
    """Shared checks of the per-layer launches -> the output, or None on
    the CPU (the caller runs the plain version)."""
    dev = codes.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    i32 = (torch.int32,)
    require(codes, "codes", i32, 2, dev)
    require(idx, "idx", i32, 2, dev)
    require(table, "table", i32, 2, dev)
    if table.shape[0] != idx.shape[0]:
        raise ValueError(f"table has {table.shape[0]} rows for "
                         f"{idx.shape[0]} neurons")
    return torch.empty((codes.shape[0], idx.shape[0]), dtype=torch.int32,
                       device=dev)


def _launch_layer(codes: torch.Tensor, idx: torch.Tensor,
                  table: torch.Tensor, bw_in: int, out: torch.Tensor,
                  geom: LayerRoute) -> None:
    """``csrc/lut_layer_smem.cu`` on checked operands at ``geom`` (from
    :func:`lut_layer_route` at ``table.element_size()``), uncounted: a
    programmatic dependent launch whose dependents launch once its wait is
    over.  ``table`` may also be a uint8 copy of an int32 table whose
    entries all lie in ``[0, 256)``, widened as unsigned: the sweep's
    comparison (``tools/lut_layer_sweep.py``); no route takes it."""
    dev = codes.device
    with torch.cuda.device(dev):
        err = _build.library().lut_layer_smem_forward(
            codes.data_ptr(), codes.shape[0], codes.shape[1],
            idx.data_ptr(), idx.shape[0], idx.shape[1], table.data_ptr(),
            table.shape[1], int(table.dtype == torch.uint8), int(bw_in),
            out.data_ptr(), int(geom.route == "smem"), geom.tile_o,
            geom.tile_b, geom.grid_b, geom.threads, stream_of(dev))
    _build.check(err, "lut_layer_smem_forward")


def lut_lookup(codes: torch.Tensor, idx: torch.Tensor, table: torch.Tensor,
               bw_in: int) -> torch.Tensor:
    """(batch, I) int32 codes -> (batch, O) int32 codes, one LUT layer.

    ``idx`` is ``(O, FI)`` int32, ``table`` ``(O, E)`` int32.  CUDA tensors
    launch the route :func:`lut_layer_route` picks (``launches`` and
    ``launches_by_route`` count those launches); CPU tensors run
    :func:`lut_lookup_plain`.  The launch may begin before the previous
    kernel on the stream ends and reads ``idx`` and ``table`` before it
    waits for that kernel: neither may be written by a kernel still
    queued or running (the engine builds both once).
    """
    out = _layer_args(codes, idx, table, "lut_lookup")
    if out is None:
        return lut_lookup_plain(codes, idx, table, bw_in)
    batch, n_in = codes.shape
    n_out, fan_in = idx.shape
    if batch == 0 or n_out == 0:
        return out
    geom = lut_layer_route(batch, n_in, n_out, fan_in, table.shape[1],
                           _sm_count(codes.device.index))
    _launch_layer(codes, idx, table, bw_in, out, geom)
    lut_lookup.launches += 1
    lut_lookup.launches_by_route[geom.route] += 1
    return out


lut_lookup.launches = 0
lut_lookup.launches_by_route = {"smem": 0, "direct": 0}
