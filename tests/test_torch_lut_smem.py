"""The smem route of the fused LUT kernels, on the CPU.

``fused_smem_layout`` (where a network lives in a block's shared memory,
and which stage's mbarrier brings each byte) and ``smem_operands`` (the
packed (neuron, element) words and the layer table) are pure Python and
torch; the kernel itself (``csrc/lut_fused_smem.cu``) runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here a numpy model
of the kernel reads only what the layout stages, stage by stage as each
layer waits on its barrier, from a shared-memory image whose other bytes
are poison, and must equal the plain versions bit for bit (tolerance 0:
integer codes) on the edge cases of ``test_torch_kernels.py``: width-0
padding, ``out_perm``, boundary codes 0 / 255, deduplicated offsets, a
compiled stack, out-of-range entries and fan-in indices, packed and
unpacked tables and a table slab at an odd byte offset.  The layout is
also held to its contract: 16-byte aligned, disjoint regions within
232 448 bytes for model A's slabs and for slabs at exactly the plan's
budget, shrinking ``tile_b`` where it must, a barrier schedule that
covers every neuron's table range, and ``lut_fused_route`` a function of
the layout alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import (ARTIFACT, MIXED_CASES, budget_stack,  # noqa: F401
                             codes, load_mixed_cases, load_ref,
                             mixed_case_arrays, mixed_cases,
                             one_torch_thread, random_stack, ref_triples,
                             with_table_offset)

from repro_torch import engine
from repro_torch.kernels import lut_network as P
from repro_torch.kernels import plan as pplan

SMEM = 232_448
POISON = 0xAB


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).reshape(-1).numpy()


def _sources(slabs, ops):
    mixed = isinstance(slabs, P.MixedNetworkSlabs)
    return {"elems": ops.elems,
            "row_meta": slabs.row_meta if mixed else ops.elems[:0],
            "table": slabs.table_slab, "layers": ops.layers,
            "perm": slabs.perm}


def smem_model(x: np.ndarray, slabs, layout=None) -> np.ndarray:
    """What the smem kernel computes, read from a shared-memory image that
    holds only the bytes of the stages a layer has waited on (each array
    shifted by its source's address modulo 16, as the kernel places it)."""
    n_in = x.shape[1]
    layout = layout or P.fused_smem_layout(slabs, n_in)
    assert layout.fits
    ops = P.smem_operands(slabs, n_in, layout)
    src = _sources(slabs, ops)
    mem = np.full(layout.total_bytes + 16, POISON, np.uint8)
    base = {a: layout.regions[a][0] + (src[a].data_ptr() & 15)
            for a in P.SMEM_ARRAYS}
    landed = set()

    def wait(stage):
        for s in range(stage + 1):
            if s in landed:
                continue
            landed.add(s)
            for a, (b, e) in layout.stages[s].items():
                mem[base[a] + b:base[a] + e] = _bytes(src[a])[b:e]

    def read(a, dtype, n):
        raw = mem[base[a]:base[a] + n * np.dtype(dtype).itemsize].copy()
        return raw.view(dtype)

    mixed = isinstance(slabs, P.MixedNetworkSlabs)
    o_sum, fi_max = slabs.idx_slab.shape
    ld, n_layers = layout.ld, len(slabs.meta)
    h = np.zeros((x.shape[0], ld), np.int64)
    h[:, :n_in] = x
    wait(0)
    lt = read("layers", np.int32, n_layers * 5).reshape(n_layers, 5)
    for row0, lo, fi, n_e_layer, stage in lt:
        wait(stage)
        words = read("elems", np.uint32, o_sum * fi_max).reshape(
            o_sum, fi_max)[row0:row0 + lo, :fi].astype(np.int64)
        col, sh, wd = words & 0xFFFF, (words >> 16) & 31, words >> 24
        code = h[:, col] & 0xFFFFFFFF                     # (B, lo, fi)
        keep = np.where(wd >= 32, 0xFFFFFFFF, (1 << wd) - 1)
        entry = (((code & keep) << sh) & 0xFFFFFFFF).sum(-1) & 0xFFFFFFFF
        rows = np.arange(row0, row0 + lo)
        if mixed:
            rm = read("row_meta", np.int32, o_sum * 2).reshape(o_sum, 2)
            off, n_e = rm[rows, 0], rm[rows, 1]
        else:
            off = rows * slabs.table_slab.shape[1]
            n_e = np.full(lo, n_e_layer)
        isz = slabs.table_slab.element_size()
        table = read("table", np.uint8 if slabs.packed else np.int32,
                     layout.sizes["table"] // isz).astype(np.int64)
        ok = entry < n_e
        pos = off + np.where(ok, entry, 0)
        g = np.zeros_like(h)
        g[:, :lo] = np.where(ok, table[np.minimum(pos, len(table) - 1)], 0)
        h = g
    wait(len(layout.stages) - 1)
    perm = read("perm", np.int32, slabs.n_out)
    return h[:, perm].astype(np.int32)


def _plain(x, slabs):
    fn = (P.lut_network_mixed_plain if isinstance(slabs, P.MixedNetworkSlabs)
          else P.lut_network_plain)
    return fn(torch.from_numpy(x), slabs).numpy()


def _mixed(name, **build):
    n_in, layers = load_mixed_cases()[name]
    return n_in, P.build_mixed_network_slabs(layers, device="cpu", **build)


MIXED = [(name, build) for name in ("het", "boundary", "dedup", "compiled")
         for build in ({}, {"pack": False}, {"dedup": False})]


def test_mixed_cases_fixture_matches_the_reference():
    """The committed lowering of the edge cases equals the reference
    compiler's, array for array."""
    fresh = mixed_case_arrays(mixed_cases())
    with np.load(MIXED_CASES) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in z.files:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)


@pytest.mark.parametrize("name,build", MIXED)
@pytest.mark.parametrize("odd", [False, True])
def test_smem_model_mixed_matches_plain(name, build, odd):
    n_in, slabs = _mixed(name, **build)
    if odd:
        slabs = with_table_offset(slabs)
    x = codes(n_in, 37, hi=8, seed=len(name))     # codes past 2 bits too
    np.testing.assert_array_equal(smem_model(x, slabs), _plain(x, slabs))


@pytest.mark.parametrize("pack", [None, False])
@pytest.mark.parametrize("widths,fan_ins,bws,hi,odd", [
    ((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), 4, False),
    ((10, 12, 9, 7), (2, 3, 1), (2, 2, 3), 4, True),
    # codes up to 15 at bw_in 2: entries past the tables give 0
    ((8, 10, 6), (2, 2), (2, 2), 16, False),
])
def test_smem_model_uniform_matches_plain(widths, fan_ins, bws, hi, odd,
                                          pack):
    slabs = P.build_network_slabs(random_stack(widths, fan_ins, bws, seed=5),
                                  pack=pack, device="cpu")
    if odd:
        slabs = with_table_offset(slabs)
    x = codes(widths[0], 29, hi=hi, seed=6)
    np.testing.assert_array_equal(smem_model(x, slabs), _plain(x, slabs))


def test_smem_model_out_of_range_words():
    """Fan-in indices past the bus or negative read the zero column;
    shifts of 32 or more or negative give 0; widths past 31 keep every
    bit: the packed words encode the first design's semantics."""
    n_in, slabs = _mixed("het", pack=False)
    idx = slabs.idx_slab.clone()
    shift = slabs.shift_slab.clone()
    width = slabs.width_slab.clone()
    idx[0, 0], idx[1, 0], idx[-1, 0] = 10_000, -3, 99
    shift[2, 0], shift[3, 0] = 40, -1
    width[4, 0], width[5, 0] = 33, -2
    fields = {f.name: getattr(slabs, f.name)
              for f in dataclasses.fields(slabs) if f.init}
    bad = P.MixedNetworkSlabs(**{**fields, "idx_slab": idx,
                                 "shift_slab": shift, "width_slab": width})
    x = codes(n_in, 23, hi=8, seed=3)
    np.testing.assert_array_equal(smem_model(x, bad), _plain(x, bad))


def _model_a():
    ref = load_ref()
    return (ref["codes"], engine.load(ARTIFACT, device="cpu").slabs,
            P.build_network_slabs(ref_triples(ref), device="cpu"))


def test_smem_model_model_a_matches_reference_outputs():
    x, mixed, uniform = _model_a()
    ref = load_ref()
    np.testing.assert_array_equal(smem_model(x[:300], mixed),
                                  ref["out_mixed"][:300])
    np.testing.assert_array_equal(smem_model(x[:300], uniform),
                                  ref["out_uniform"][:300])


def _check_regions(layout):
    spans = sorted((off, off + size) for off, size in
                   layout.regions.values() if size)
    for off, size in layout.regions.values():
        assert off % 16 == 0
    for (_, e0), (b1, _) in zip(spans, spans[1:]):
        assert e0 <= b1
    for a in P.SMEM_ARRAYS:
        off, size = layout.regions[a]
        assert size >= layout.sizes[a] + 15 or layout.sizes[a] == 0
    assert layout.regions["barriers"][1] == 8 * len(layout.stages)
    act_off, act = layout.regions["act"]
    assert act == 2 * 4 * layout.tile_b * layout.ld
    assert layout.total_bytes == act_off + act
    assert layout.fits == (layout.total_bytes <= SMEM
                           and layout.tile_b >= 1)


def test_layout_of_model_a_fits():
    """Model A's slabs fit with the full tile: the level-3 artifact as the
    reference loads it and the raw tables as the reference packs them (the
    sizes read from the reference's own slabs, not written here)."""
    from repro import engine as jengine
    from repro.kernels import lut_network as J

    _, mixed, uniform = _model_a()
    jnet = jengine.load(ARTIFACT)
    js = J.build_network_slabs(ref_triples(load_ref()))
    assert mixed.slab_breakdown()["total_bytes"] == \
        jnet.vmem_breakdown()["total_bytes"]
    assert uniform.slab_breakdown() == js.vmem_breakdown()
    for slabs, n_in in ((mixed, jnet.n_in), (uniform, jnet.n_in)):
        layout = P.fused_smem_layout(slabs, n_in)
        _check_regions(layout)
        assert layout.fits and layout.tile_b == P.SMEM_TILE_B
        assert layout.sizes["table"] == slabs.table_slab.numel() * (
            slabs.table_slab.element_size())
        assert P.lut_fused_route(layout) == "smem"


@pytest.mark.parametrize("mixed", [True, False])
def test_layout_at_exact_plan_budget_fits_by_shrinking_tile_b(mixed):
    layers = budget_stack(mixed)
    build = (P.build_mixed_network_slabs if mixed
             else P.build_network_slabs)
    slabs = build(layers, device="cpu")
    plan = pplan.fused_plan(layers)
    assert plan.fused and plan.slab_bytes == pplan.FUSED_SMEM_BUDGET_BYTES
    layout = P.fused_smem_layout(slabs, 716)
    _check_regions(layout)
    assert layout.fits and 1 <= layout.tile_b < P.SMEM_TILE_B
    assert P.lut_fused_route(layout) == "smem"
    x = codes(716, 9, hi=2, seed=1)
    np.testing.assert_array_equal(smem_model(x, slabs, layout),
                                  _plain(x, slabs))


def test_layout_past_the_limit_takes_global():
    """int32 tables of 200 neurons x 512 entries (400 KB): no layout fits,
    so the route is the first design's."""
    slabs = P.build_network_slabs(
        random_stack((16, 100, 100), (3, 3), (3, 3), seed=1, hi=1000),
        device="cpu")
    layout = P.fused_smem_layout(slabs, 16)
    assert not slabs.packed and not layout.fits and layout.tile_b == 0
    assert P.lut_fused_route(layout) == "global"


@pytest.mark.parametrize("name,build", MIXED)
def test_barrier_schedule_covers_every_table_range(name, build):
    """Each layer's wait stage, and every stage before it, copy every
    neuron's table range of that layer (deduplicated offsets pointing at
    earlier layers' rows included), its elems and row_meta rows; the
    layer table lands with stage 0 and perm with the last."""
    n_in, slabs = _mixed(name, **build)
    layout = P.fused_smem_layout(slabs, n_in)
    isz = slabs.table_slab.element_size()
    fi_max = slabs.idx_slab.shape[1]
    rm = slabs.row_meta.numpy()
    assert list(layout.wait) == sorted(layout.wait)
    assert layout.stages[0]["layers"] == (0, 20 * len(slabs.meta))
    assert layout.stages[-1]["perm"] == (0, 4 * slabs.n_out)

    def covered(a, stage):
        got = set()
        for st in layout.stages[:stage + 1]:
            got |= set(range(*st[a]))
        return got

    row = 0
    for m, stage in zip(slabs.meta, layout.wait):
        table = covered("table", stage)
        for off, n_e in rm[row:row + m.n_out]:
            assert set(range(off * isz, (off + n_e) * isz)) <= table
        assert (set(range(row * fi_max * 4, (row + m.n_out) * fi_max * 4))
                <= covered("elems", stage))
        assert (set(range(row * 8, (row + m.n_out) * 8))
                <= covered("row_meta", stage))
        row += m.n_out
    if name == "dedup" and "dedup" not in build:
        assert slabs.dedup_entries_saved > 0


def test_stages_group_layers_past_the_barrier_limit():
    """Eleven layers share SMEM_MAX_STAGES barriers in order; every stage
    has a layer and the model still matches the plain version."""
    layers = random_stack((6,) * 12, (2,) * 11, (2,) * 11, seed=4)
    slabs = P.build_network_slabs(layers, device="cpu")
    layout = P.fused_smem_layout(slabs, 6)
    assert len(layout.stages) == P.SMEM_MAX_STAGES
    assert sorted(set(layout.wait)) == list(range(P.SMEM_MAX_STAGES))
    assert list(layout.wait) == sorted(layout.wait)
    x = codes(6, 11, seed=2)
    np.testing.assert_array_equal(smem_model(x, slabs, layout),
                                  _plain(x, slabs))


def test_route_is_a_pure_function_of_the_layout():
    _, mixed, _ = _model_a()
    layout = P.fused_smem_layout(mixed, 16)
    again = P.fused_smem_layout(mixed, 16)
    assert layout == again
    assert P.lut_fused_route(layout) == P.lut_fused_route(again) == "smem"
    assert P.lut_fused_route(dataclasses.replace(layout, fits=False)) \
        == "global"


def test_layout_is_cached_once_per_slabs_and_width():
    _, mixed, _ = _model_a()
    a = P._smem_state(mixed, 16)
    assert P._smem_state(mixed, 16) is a
    assert P._smem_state(mixed, 17) is not a
    assert set(mixed._smem) == {16, 17}


def test_cpu_calls_count_no_launch():
    x, mixed, uniform = _model_a()
    before = (P.lut_network_mixed.launches, P.lut_network.launches,
              dict(P.lut_network_mixed.launches_by_route),
              dict(P.lut_network.launches_by_route))
    P.lut_network_mixed(torch.from_numpy(x[:5]), mixed)
    P.lut_network(torch.from_numpy(x[:5]), uniform)
    assert before == (P.lut_network_mixed.launches, P.lut_network.launches,
                      P.lut_network_mixed.launches_by_route,
                      P.lut_network.launches_by_route)


def test_tile_rows_rule():
    """Enough tiles for every SM, at least 4 rows, at most the layout's
    tile (132 SMs: an H100's)."""
    assert P.smem_tile_rows(16, 32, 132) == 4
    assert P.smem_tile_rows(1, 32, 132) == 4
    assert P.smem_tile_rows(600, 32, 132) == 5
    assert P.smem_tile_rows(1000, 32, 132) == 8
    assert P.smem_tile_rows(2000, 32, 132) == 16
    assert P.smem_tile_rows(4096, 32, 132) == 32
    assert P.smem_tile_rows(100_000, 32, 132) == 32
    assert P.smem_tile_rows(4096, 3, 132) == 3        # a shrunk layout
