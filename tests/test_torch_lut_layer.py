"""The per-layer LUT kernel's routes, on the CPU.

``lut_layer_route`` (route ``smem`` or ``direct`` and the launch geometry)
and ``layer_smem_bytes`` are pure Python; the kernel itself
(``csrc/lut_layer_smem.cu``) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here the geometry is
held to its contract (every neuron and every batch row served by exactly
one block, a block within its shared-memory budget, the bulk copy's
region 16-byte aligned), and a numpy model of the kernel, which reads
only what a block holds (its neuron tile's indices, its staged table
bytes from a shared-memory image whose other bytes are poison, or the
table in place, and its batch tile's codes), must equal
``lut_lookup_plain`` bit for bit (tolerance 0: integer codes) on model
A's and model D's tables, ragged shapes, out-of-range indices, entries
and shifts, and E = 4096.  The port's per-layer forward on model D must
equal the reference's outputs (``tests/fixtures/torch_port/
model_d_ref.npz`` and a fresh chain of ``lut_lookup_pallas`` in interpret
mode), and the port's engine must send model D to the per-layer kernel
where the reference's, with its 8 MiB budget, picks the uniform layout.
"""

import importlib.util
import os

import numpy as np
import pytest

from torch_port_util import (FIXTURE_DIR, ROOT, codes,  # noqa: F401
                             one_torch_thread, random_stack, t)

from repro_torch import engine
from repro_torch.kernels import lut_lookup as L

MODEL_D = os.path.join(FIXTURE_DIR, "model_d_ref.npz")
REF_A = os.path.join(FIXTURE_DIR, "model_a_ref.npz")
SMS = 132
POISON = 0xAB


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _triples(ref):
    return [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
            for i in range(len(ref["bws"]))]


def copy_split(addr: int, nbytes: int) -> tuple[int, int]:
    """The kernel's split of a staged range at byte address ``addr``: its
    16-byte aligned middle ``[lo, hi)`` goes by bulk copy, the head and the
    tail by threads."""
    shift = addr & 15
    lo = min(nbytes, (16 - shift) & 15)
    return lo, max(lo, ((shift + nbytes) & ~15) - shift)


def layer_model(x, idx, tab, bw, geom, table_addr=0):
    """What ``lut_layer_smem.cu`` computes at ``geom``, block by block,
    reading only what a block holds.  ``tab`` is int32 or uint8;
    ``table_addr`` is its byte address modulo 16 (the staged copy's
    alignment follows it)."""
    batch, n_in = x.shape
    n_out, fan_in = idx.shape
    n_e = tab.shape[1]
    elem = tab.dtype.itemsize
    stage = geom.route == "smem"
    tab_bytes = np.ascontiguousarray(tab).view(np.uint8).reshape(-1)
    out = np.zeros((batch, n_out), np.int64)
    served = np.zeros((batch, n_out), np.int64)
    n_tiles = -(-batch // geom.tile_b)
    assert geom.grid_b <= n_tiles
    for bx in range(geom.grid_o):
        o0 = bx * geom.tile_o
        to = min(geom.tile_o, n_out - o0)
        assert to >= 1
        if stage:
            src = table_addr + elem * o0 * n_e
            nbytes = elem * to * n_e
            shift = src & 15
            lo, hi = copy_split(src, nbytes)
            assert (src + lo) % 16 == 0 and (hi - lo) % 16 == 0
            assert lo < 16 and nbytes - hi < 16
            mem = np.full(geom.smem_bytes, POISON, np.uint8)
            base = 32 + shift
            # the table's region ends where the indices' begins
            assert base + nbytes <= 32 + -(-(elem * geom.tile_o * n_e + 15)
                                           // 16) * 16
            part = tab_bytes[elem * o0 * n_e:elem * (o0 * n_e) + nbytes]
            mem[base + lo:base + hi] = part[lo:hi]
            mem[base:base + lo] = part[:lo]
            mem[base + hi:base + nbytes] = part[hi:]
            rows = mem[base:base + nbytes].view(tab.dtype).reshape(to, n_e)
        else:
            rows = tab[o0:o0 + to]
        sub = idx[o0:o0 + to].astype(np.int64)
        k = np.arange(fan_in)
        ok = (sub >= 0) & (sub < n_in) & (bw * k < 32) & (bw * k >= 0)
        sidx = np.where(ok, sub, n_in)
        for by in range(geom.grid_b):
            for tile in range(by, n_tiles, geom.grid_b):
                b0 = tile * geom.tile_b
                h = x[b0:b0 + geom.tile_b].astype(np.int64) & 0xFFFFFFFF
                hz = np.concatenate([h, np.zeros((len(h), 1), np.int64)], 1)
                code = hz[:, sidx]                         # (rows, to, FI)
                entry = ((code << ((bw * k) & 31)) & 0xFFFFFFFF).sum(
                    -1) & 0xFFFFFFFF
                hit = entry < n_e
                v = np.where(hit, rows[np.arange(to), np.where(
                    hit, entry, 0)].astype(np.int64), 0)
                out[b0:b0 + len(h), o0:o0 + to] = v
                served[b0:b0 + len(h), o0:o0 + to] += 1
    assert (served == 1).all()
    return out.astype(np.int32)


def _plain(x, idx, tab, bw):
    return L.lut_lookup_plain(t(x), t(idx), t(tab), bw).numpy()


# (n_in, n_out, fan_in, n_entries): model A's and model D's layers, ragged
# widths, E = 4096, a table too large to stage, a wide bus
SHAPES = [(16, 64, 3, 512), (64, 64, 3, 512), (16, 64, 5, 1024),
          (64, 32, 5, 1024), (32, 32, 5, 1024), (32, 5, 6, 4096),
          (7, 13, 2, 9), (300, 333, 4, 64), (12, 3, 1, 1 << 15),
          (30_000, 8, 2, 16)]
BATCHES = (1, 15, 16, 17, 1000, 4096)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("route", [None, "smem", "direct"])
@pytest.mark.parametrize("elem", [4, 1])
def test_route_geometry_contract(shape, route, elem):
    """Every neuron in one tile, every batch tile walked by one block
    group, a block within its budget (the whole SM only for a direct
    block whose one row of codes passes half of it), for int32 and uint8
    tables."""
    n_in, n_out, fan_in, n_e = shape
    for batch in BATCHES:
        try:
            g = L.lut_layer_route(batch, n_in, n_out, fan_in, n_e, SMS, elem,
                                  route=route)
        except ValueError:
            assert route == "smem" and L.layer_smem_bytes(
                n_in, fan_in, n_e, 1, 1, True, 1, elem) > L.LAYER_SMEM_BYTES
            continue
        assert route in (None, g.route)
        assert (g.grid_o - 1) * g.tile_o < n_out <= g.grid_o * g.tile_o
        assert 1 <= g.tile_o <= g.threads and g.tile_b <= batch
        n_tiles = -(-batch // g.tile_b)
        assert 1 <= g.grid_b <= min(n_tiles, 65535)
        if g.route == "smem":
            assert g.grid_b * g.grid_o <= max(SMS, g.grid_o)
        n_buf = 2 if n_tiles > g.grid_b else 1
        assert n_buf == 1 or g.route == "smem" or n_tiles > 65535
        assert g.smem_bytes == L.layer_smem_bytes(
            n_in, fan_in, n_e, g.tile_o, g.tile_b, g.route == "smem", n_buf,
            elem)
        if g.route == "direct" and not route:
            # one output a thread, or two in a grid of many blocks
            assert g.tile_b * g.tile_o <= 2 * g.threads or g.tile_b == 1
        limit = (L.LAYER_SMEM_BYTES if g.route == "smem"
                 or L.layer_smem_bytes(n_in, fan_in, n_e, 1, 1, False)
                 <= L.LAYER_SMEM_BYTES else L.LAYER_MAX_SMEM_BYTES)
        assert g.smem_bytes <= limit
        if g.route == "smem":
            assert g.smem_bytes % 4 == 0


def test_route_rule_choices():
    """Up to LAYER_SMEM_MAX_BATCH rows the tables are staged (their copy
    hides under the previous layer), above it read in place; a neuron
    whose table alone passes the budget is always read in place."""
    route = L.lut_layer_route
    for batch in (1, 16, L.LAYER_SMEM_MAX_BATCH):
        assert route(batch, 64, 64, 3, 512, SMS).route == "smem"
        assert route(batch, 32, 5, 6, 4096, SMS).route == "smem"
    for batch in (L.LAYER_SMEM_MAX_BATCH + 1, 1000, 4096):
        assert route(batch, 64, 64, 3, 512, SMS).route == "direct"
    assert route(16, 12, 3, 1, 1 << 15, SMS).route == "direct"
    with pytest.raises(ValueError, match="no smem block"):
        route(16, 12, 3, 1, 1 << 15, SMS, route="smem")
    with pytest.raises(ValueError, match="no launch"):
        route(0, 12, 3, 1, 16, SMS)
    with pytest.raises(ValueError, match="unknown route"):
        route(16, 12, 3, 1, 16, SMS, route="global")


def test_route_is_cached():
    """Worked out once a (table shape, batch) and reused."""
    L.lut_layer_route(4096, 64, 64, 3, 512, SMS)
    hits = L.lut_layer_route.cache_info().hits
    assert L.lut_layer_route(4096, 64, 64, 3, 512, SMS) is \
        L.lut_layer_route(4096, 64, 64, 3, 512, SMS)
    assert L.lut_layer_route.cache_info().hits == hits + 2


@pytest.mark.parametrize("shift", [0, 4, 8, 12])
@pytest.mark.parametrize("nbytes", [0, 4, 8, 12, 16, 20, 36, 2048, 65540])
def test_bulk_copy_region_alignment(shift, nbytes):
    addr = 4096 + shift
    lo, hi = copy_split(addr, nbytes)
    assert 0 <= lo <= hi <= nbytes and lo < 16 and nbytes - hi < 16
    assert (addr + lo) % 16 == 0 or lo == hi == nbytes
    assert (hi - lo) % 16 == 0 and lo % 4 == 0 and hi % 4 == 0


def _check_model(x, idx, tab, bw, batches=(1, 17, 300), geoms=None,
                 addrs=(0, 4)):
    """The model at several geometries, table addresses and (where every
    entry fits a byte) a uint8 copy of the table (the sweep's comparison),
    against the plain version on the int32 table."""
    n_out, fan_in = idx.shape
    tabs = [tab]
    if tab.min() >= 0 and tab.max() < 256:
        tabs.append(tab.astype(np.uint8))
    for b in batches:
        xb = x[:b]
        want = _plain(xb, idx, tab, bw)
        for tb in tabs:
            for kw in geoms or ({}, {"route": "smem"}, {"route": "direct"},
                                {"route": "smem", "tile_o": 3, "tile_b": 5},
                                {"route": "direct", "tile_o": 7,
                                 "tile_b": 2}):
                g = L.lut_layer_route(b, x.shape[1], n_out, fan_in,
                                      tb.shape[1], SMS, tb.itemsize, **kw)
                for addr in addrs + (1, 7) if tb.itemsize == 1 else addrs:
                    if g.route != "smem" and addr:
                        continue
                    np.testing.assert_array_equal(
                        layer_model(xb, idx, tb, bw, g, addr), want,
                        err_msg=f"batch {b} {g} {tb.dtype} table at {addr} "
                                f"mod 16")


@pytest.mark.parametrize("which", ["A", "D"])
def test_model_matches_plain_on_models(which):
    ref = _load(REF_A if which == "A" else MODEL_D)
    x = ref["codes"]
    for idx, tab, bw in _triples(ref):
        _check_model(x, idx, tab, bw, addrs=(0, 4, 8, 12))
        x = _plain(x[:300], idx, tab, bw)


@pytest.mark.parametrize("n_in,n_out,fan_in,bw,n_e,hi", [
    (7, 13, 2, 2, 16, 4),          # ragged tiles
    (10, 33, 3, 2, 64, 16),        # codes past 2 bits: entries past E
    (12, 5, 6, 2, 4096, 4),        # E = 4096
    (9, 7, 3, 2, 50, 4),           # E not a power of two
    (9, 40, 5, 8, 4096, 256),      # k = 4 shifts by 32: gives 0
])
def test_model_matches_plain_on_edges(n_in, n_out, fan_in, bw, n_e, hi):
    rng = np.random.default_rng(n_in * n_out)
    idx = np.stack([np.sort(rng.choice(n_in, fan_in, replace=False))
                    for _ in range(n_out)]).astype(np.int32)
    tab = rng.integers(0, 1000, (n_out, n_e), dtype=np.int32)
    x = codes(n_in, 300, hi=hi, seed=4)
    _check_model(x, idx, tab, bw)


def test_model_out_of_range_indices_and_negative_codes():
    (idx, tab, bw), = random_stack((10, 20), (3,), (2,), seed=8)
    idx = idx.copy()
    idx[0, 0], idx[1, 1], idx[2, 2], idx[3, 0] = 10, -1, 99, -(1 << 30)
    x = codes(10, 300, hi=4, seed=2)
    x[5, 3], x[6, 0] = -1, 1 << 20
    _check_model(x, idx, tab, bw)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    (idx, tab, bw), = random_stack((10, 20), (3,), (2,), seed=1)
    x = codes(10, 16, seed=0)
    before = (L.lut_lookup.launches, dict(L.lut_lookup.launches_by_route))
    got = L.lut_lookup(t(x), t(idx), t(tab), bw)
    np.testing.assert_array_equal(got.numpy(), _plain(x, idx, tab, bw))
    assert (L.lut_lookup.launches,
            dict(L.lut_lookup.launches_by_route)) == before


def test_port_per_layer_model_d_matches_reference_fixture():
    """The port's engine on model D's tables: per_layer by its own choice,
    its outputs the reference's (both layouts) on 4096 seeded rows."""
    ref = _load(MODEL_D)
    net = engine.compile_network(_triples(ref), block_b=16, device="cpu")
    assert net.layout == "per_layer"
    assert net.plan.variant.cost.reason == "slab_exceeds_smem_budget"
    got = net(ref["codes"]).numpy()
    np.testing.assert_array_equal(got, ref["out_per_layer"])
    np.testing.assert_array_equal(got, ref["out_uniform"])
    for b in (1, 17):
        np.testing.assert_array_equal(net(ref["codes"][:b]).numpy(),
                                      ref["out_uniform"][:b])


def test_port_per_layer_model_d_matches_fresh_reference_chain():
    """The same tables through the reference's own CPU route: its Pallas
    per-layer kernel in interpret mode, chained, on 40 seeded rows."""
    import jax.numpy as jnp

    from repro.kernels.lut_lookup import lut_lookup_pallas

    ref = _load(MODEL_D)
    x = codes(16, 40, hi=4, seed=11)
    want, got = jnp.asarray(x), t(x)
    for idx, tab, bw in _triples(ref):
        want = lut_lookup_pallas(want, jnp.asarray(idx), jnp.asarray(tab),
                                 bw, interpret=True)
        got = L.lut_lookup(got, t(idx), t(tab), bw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engines_choose_layouts_for_model_d():
    """The reference fuses model D (uniform slabs in its 8 MiB VMEM
    budget); the port's plan sees 547 960 bytes against its 183 296-byte
    shared-memory budget and sends it to the per-layer kernel."""
    from repro import engine as ref_engine

    triples = _triples(_load(MODEL_D))
    assert ref_engine.compile_network(triples, block_b=16).layout == \
        "uniform"
    net = engine.compile_network(triples, block_b=16, device="cpu")
    cost = net.plan.variant.cost
    assert (net.layout, cost.reason, cost.slab_bytes,
            cost.vmem_budget_bytes) == ("per_layer",
                                        "slab_exceeds_smem_budget",
                                        547_960, 183_296)


def test_model_d_fixture_matches_fresh_reference_generation():
    """Regenerate model D with the reference: the committed
    ``model_d_ref.npz`` equals it array for array."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fresh = tool.build_model_d()
    committed = _load(MODEL_D)
    assert fresh.keys() == committed.keys()
    for k in committed:
        assert fresh[k].dtype == committed[k].dtype, k
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
    assert [tb.shape for tb in (committed[f"table_{i}"] for i in range(4))] \
        == [(64, 1024), (32, 1024), (32, 1024), (5, 4096)]
