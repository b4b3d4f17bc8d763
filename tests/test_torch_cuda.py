"""The port's CUDA kernels on the card: ``PYTHONPATH=src python -m pytest
-m cuda tests/test_torch_cuda.py`` (torch and numpy only, so it runs where
JAX is not installed).  Without a CUDA device every test here skips.

Each LUT kernel must be bit-exact (tolerance 0: integer codes) with its
plain version on the same CUDA tensors, count one launch per call, and
refuse tensors it cannot take; both routes of the fused kernels (``smem``
and ``global``), on the reference compiler's edge cases
(``tests/fixtures/torch_port/lut_mixed_cases.npz``), table slabs at odd
byte offsets, slabs whose layout shrinks its tile and one past every
layout (``global``), at batches 1, 15, 16, 17 and 4096; and both routes
of the per-layer kernel (``smem`` and ``direct``, ``csrc/
lut_layer_smem.cu``), forced at the rule's geometry and at small tiles,
as programmatic dependent launches and with tables 4 bytes past a
16-byte boundary, on model A's and model D's layers and edge cases, and
a queued chain of 48 dependent launches against the plain chain; and the mixed
kernel's two routes on what the port's own compiler makes at level 3
(models A and D, and three seeded random stacks).  The masked
matmul is held to its plain
version within float32 atol 1e-4 / rtol 1e-5 (another summation order)
and bfloat16 atol 5e-2 / rtol 1e-3 plus exactly one bfloat16 step of the
plain output (the reference's tolerance; the step because both round a
float32 sum taken in another order); training on the card
is held to the same steps on the CPU within rtol 1e-3.  The flash-attention
kernel is held to its plain version within float32 atol 1e-5 / rtol 1e-5
(the same float32 arithmetic in another summation order) and bfloat16
atol 3e-2 (the reference's) plus exactly one bfloat16 step of the plain
output.  Both kernels have two routes, the SIMT kernels and the
tensor-core (wgmma) kernels, and each a third for float32: the masked
matmul's CUDA-core ``ffma`` kernel, whose output must also equal the first
SIMT design's (``masked_matmul_forward``, the order oracle) bit for bit,
and flash attention's ``tf32x3`` kernel (three TF32 tensor-core products
a product, held to the float32 tolerance above and, at qwen3-1.7b's
prefill shape, to the SIMT kernel on the same inputs); each case asserts
which route ran from the wrappers' ``launches_by_route`` counters, at the
same tolerances.  The bfloat16 tensor-core flash route is also held to a
second gate beside that one, 1e-3 plus two bfloat16 steps of the plain
output, tight enough to reject a stale K/V stage.  Training attention's
kernels (``flash_attention_train``: the training forward and the two
backward launches) are held to the float64 gradients of the same
bfloat16 inputs within one bfloat16 step plus ``TRAIN_GRAD_REL`` of each
gradient's largest element, and at both train cells' shapes to float32
autograd through ``_chunked_attention`` within two steps plus the same;
the forward gives the prefill kernel's output bit for bit and the
backward gives the same bits run to run.  At the cells' shapes at most
``TRAIN_ROUNDED_SHARE`` of each gradient's elements may differ from the
float64 gradient rounded to nearest bfloat16, which a backward with P and
dS rounded to bfloat16 (no lo halves) would miss twenty times over.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_port_util import (ARTIFACT, FIXTURE_DIR, REF, ROOT, budget_stack,
                             codes, load_mixed_cases, load_ref, load_train,
                             random_stack, with_table_offset)

from repro_torch import engine
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import lut_lookup as L
from repro_torch.kernels import lut_network as P
from repro_torch.kernels import masked_matmul as MM
from repro_torch.configs import fpga4hep
from repro_torch.core import logicnet as LN
from repro_torch.core.train import train_logicnet
from repro_torch.data import jet_substructure_data
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_route)
from repro_torch.kernels.lut_lookup import lut_lookup, lut_lookup_plain
from repro_torch.kernels.masked_matmul import (MaskedMatmulFn, masked_matmul,
                                               masked_matmul_plain,
                                               masked_matmul_route)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _check(wrapper, kernel, plain, x):
    before = wrapper.launches
    got = kernel(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (1 if x.shape[0] else 0)
    assert got.dtype == torch.int32 and got.device == x.device
    assert torch.equal(got, plain(x))
    return got


@pytest.mark.parametrize("batch", [1, 33, 1000])
def test_kernels_match_plain_versions(dev, batch):
    ms = engine.load(ARTIFACT, device=dev).slabs
    layers = random_stack((10, 12, 9, 7), (2, 3, 1), (2, 2, 3), seed=5)
    us = P.build_network_slabs(layers, device=dev)
    wide = random_stack((12, 20), (3,), (2,), seed=1, hi=1000)
    idx, tab = _on(dev, *wide[0][:2])
    bw = wide[0][2]
    x16 = _on(dev, codes(16, batch, hi=8, seed=batch))[0]
    x10 = _on(dev, codes(10, batch, hi=4, seed=batch))[0]
    x12 = _on(dev, codes(12, batch, hi=8, seed=batch))[0]   # some entries
    _check(P.lut_network_mixed, lambda c: P.lut_network_mixed(c, ms),
           lambda c: P.lut_network_mixed_plain(c, ms), x16)
    _check(P.lut_network, lambda c: P.lut_network(c, us),
           lambda c: P.lut_network_plain(c, us), x10)
    out = _check(lut_lookup, lambda c: lut_lookup(c, idx, tab, bw),
                 lambda c: lut_lookup_plain(c, idx, tab, bw), x12)
    assert int(out.max()) >= 256          # int32 tables, wide codes


def test_model_a_matches_reference_outputs(dev):
    ref = load_ref()
    x = _on(dev, ref["codes"])[0]
    net = engine.load(ARTIFACT, device=dev)
    assert torch.equal(net(x).cpu(), torch.from_numpy(ref["out_mixed"]))
    triples = [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
               for i in range(3)]
    for kw, name in (({}, "uniform"), ({"fused": False}, "per_layer")):
        net = engine.compile_network(triples, block_b=16, device=dev, **kw)
        assert net.layout == name
        assert torch.equal(net(x).cpu(),
                           torch.from_numpy(ref[f"out_{name}"]))


def test_batch_zero_launches_nothing(dev):
    ms = engine.load(ARTIFACT, device=dev).slabs
    before = P.lut_network_mixed.launches
    out = P.lut_network_mixed(torch.zeros((0, 16), dtype=torch.int32,
                                          device=dev), ms)
    assert out.shape == (0, 64) and P.lut_network_mixed.launches == before


def test_wrappers_refuse_what_the_kernels_cannot_take(dev):
    idx, tab, bw = random_stack((8, 6), (2,), (2,))[0]
    idx_d, tab_d = _on(dev, idx, tab)
    x = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        lut_lookup(x.long(), idx_d, tab_d, bw)
    with pytest.raises(ValueError, match="contiguous"):
        lut_lookup(torch.zeros((8, 4), dtype=torch.int32, device=dev).T,
                   idx_d, tab_d, bw)
    with pytest.raises(ValueError, match="expected"):
        lut_lookup(x, idx_d.cpu(), tab_d, bw)
    us = P.build_network_slabs([(idx, tab, bw)], device="cpu")
    with pytest.raises(ValueError, match="slabs on"):
        P.lut_network(x, us)



LUT_BATCHES = (1, 15, 16, 17, 4096)


def _fused_routes(slabs, x, route="smem"):
    """The routed call counts one launch on ``route``; it and both routes
    called directly equal the plain version bit for bit."""
    mixed = isinstance(slabs, P.MixedNetworkSlabs)
    wrapper = P.lut_network_mixed if mixed else P.lut_network
    plain = P.lut_network_mixed_plain if mixed else P.lut_network_plain
    state = P._smem_state(slabs, x.shape[1])
    assert P.lut_fused_route(state.layout) == route
    before = dict(wrapper.launches_by_route)
    got = wrapper(x, slabs)
    torch.cuda.synchronize()
    assert wrapper.launches_by_route == {
        r: n + (r == route) for r, n in before.items()}
    want = plain(x, slabs)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    direct = torch.empty_like(got)
    P._launch_global(x, slabs, direct)
    torch.cuda.synchronize()
    assert torch.equal(direct, want)
    if state.layout.fits:
        for bulk in (True, False):
            direct = torch.empty_like(got)
            P._launch_smem(x, direct, state, bulk=bulk)
            torch.cuda.synchronize()
            assert torch.equal(direct, want)


@pytest.mark.parametrize("name", ["het", "boundary", "dedup", "compiled"])
@pytest.mark.parametrize("build", [{"pack": True}, {"pack": False},
                                   {"dedup": False}])
@pytest.mark.parametrize("odd", [False, True])
def test_mixed_smem_route_matches_plain(dev, name, build, odd):
    """The reference compiler's edge cases (width-0 padding and out_perm,
    boundary codes 0 / 255, dedup offsets, a level-3 stack), packed and
    not, the table slab 16-byte aligned or at an odd byte offset."""
    n_in, layers = load_mixed_cases()[name]
    slabs = P.build_mixed_network_slabs(layers, device=dev, **build)
    if odd:
        slabs = with_table_offset(slabs)
    for batch in LUT_BATCHES:
        x = _on(dev, codes(n_in, batch, hi=8, seed=batch))[0]
        _fused_routes(slabs, x)


@pytest.mark.parametrize("pack", [None, False])
@pytest.mark.parametrize("widths,fan_ins,bws,hi,odd", [
    ((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), 4, False),
    ((10, 12, 9, 7), (2, 3, 1), (2, 2, 3), 4, True),
    # codes up to 15 at bw_in 2: entries past the tables give 0
    ((8, 10, 6), (2, 2), (2, 2), 16, False),
])
def test_uniform_smem_route_matches_plain(dev, widths, fan_ins, bws, hi,
                                          odd, pack):
    slabs = P.build_network_slabs(random_stack(widths, fan_ins, bws, seed=5),
                                  pack=pack, device=dev)
    if odd:
        slabs = with_table_offset(slabs)
    for batch in LUT_BATCHES:
        x = _on(dev, codes(widths[0], batch, hi=hi, seed=batch))[0]
        _fused_routes(slabs, x)


def test_model_a_smem_route_matches_reference(dev):
    ref = load_ref()
    x = _on(dev, ref["codes"])[0]
    mixed = engine.load(ARTIFACT, device=dev).slabs
    uniform = P.build_network_slabs(
        [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
         for i in range(3)], device=dev)
    for slabs, name in ((mixed, "mixed"), (uniform, "uniform")):
        _fused_routes(slabs, x)
        fn = P.lut_network_mixed if name == "mixed" else P.lut_network
        assert torch.equal(fn(x, slabs).cpu(),
                           torch.from_numpy(ref[f"out_{name}"]))


@pytest.mark.parametrize("mixed", [True, False])
def test_smem_route_with_shrunk_tile(dev, mixed):
    """Slabs at exactly the plan's budget: the layout shrinks tile_b."""
    build = P.build_mixed_network_slabs if mixed else P.build_network_slabs
    slabs = build(budget_stack(mixed), device=dev)
    assert P._smem_state(slabs, 716).layout.tile_b < P.SMEM_TILE_B
    for batch in LUT_BATCHES:
        _fused_routes(slabs, _on(dev, codes(716, batch, hi=2,
                                            seed=batch))[0])


def test_slab_past_the_limit_takes_global(dev):
    """400 KB of int32 tables: no layout fits; the first design serves."""
    slabs = P.build_network_slabs(
        random_stack((16, 100, 100), (3, 3), (3, 3), seed=1, hi=1000),
        device=dev)
    for batch in LUT_BATCHES:
        _fused_routes(slabs, _on(dev, codes(16, batch, hi=8,
                                            seed=batch))[0], route="global")


def test_fused_batch_zero_launches_nothing(dev):
    ref = load_ref()
    uniform = P.build_network_slabs(
        [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
         for i in range(3)], device=dev)
    mixed = engine.load(ARTIFACT, device=dev).slabs
    for fn, slabs in ((P.lut_network_mixed, mixed),
                      (P.lut_network, uniform)):
        before = (fn.launches, dict(fn.launches_by_route))
        out = fn(torch.zeros((0, 16), dtype=torch.int32, device=dev), slabs)
        assert out.shape == (0, 64)
        assert (fn.launches, fn.launches_by_route) == before


# -- the per-layer kernel (csrc/lut_layer_smem.cu): routes smem and direct

MODEL_D = os.path.join(FIXTURE_DIR, "model_d_ref.npz")


def _fixture_layers(path):
    """Each layer of a fixture's model as (codes into it, idx, table, bw):
    the codes are the plain chain's on the fixture's 4096 rows."""
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    x, out = ref["codes"], []
    for i in range(len(ref["bws"])):
        idx, tab, bw = ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i])
        out.append((x, idx, tab, bw))
        x = lut_lookup_plain(*(torch.from_numpy(a) for a in (x, idx, tab)),
                             bw).numpy()
    return out


def _edge_layer(n_in, n_out, fan_in, bw, n_e, hi, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(n_in, min(fan_in, n_in),
                                       replace=False))
                    for _ in range(n_out)]).astype(np.int32)
    tab = rng.integers(0, 1000, (n_out, n_e), dtype=np.int32)
    return codes(n_in, 4096, hi=hi, seed=seed), idx, tab, bw


@functools.lru_cache(maxsize=1)
def _layer_cases():
    cases = {f"A{i}": c for i, c in enumerate(_fixture_layers(REF))}
    cases.update({f"D{i}": c for i, c in enumerate(_fixture_layers(MODEL_D))})
    x, idx, tab, bw = _edge_layer(10, 40, 3, 2, 64, 4, seed=1)
    idx[0, 0], idx[1, 1], idx[2, 2] = 10, -1, 1 << 20   # outside the bus
    cases.update({
        "out_of_range_idx": (x, idx, tab, bw),
        "ragged": _edge_layer(7, 13, 2, 2, 16, 4, seed=2),
        "past_entries": _edge_layer(10, 33, 3, 2, 64, 16, seed=3),
        "e4096": _edge_layer(12, 5, 6, 2, 4096, 4, seed=4),
        "shift32": _edge_layer(9, 40, 5, 8, 4096, 256, seed=5),
        "e_not_pow2": _edge_layer(9, 7, 3, 2, 50, 4, seed=6),
        "wide": _edge_layer(300, 333, 4, 1, 16, 2, seed=7),
    })
    return cases


# model A's three layers, model D's four, and the edges of _layer_cases
LAYER_CASES = ("A0", "A1", "A2", "D0", "D1", "D2", "D3", "out_of_range_idx",
               "ragged", "past_entries", "e4096", "shift32", "e_not_pow2",
               "wide")


def _shifted(t):
    """``t`` as a view one element past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    view = buf[1:].reshape(t.shape)
    assert view.data_ptr() % 16 == t.element_size()
    return view


def _layer_direct(x, idx, tab, bw, route, **kw):
    geom = L.lut_layer_route(x.shape[0], x.shape[1], idx.shape[0],
                             idx.shape[1], tab.shape[1],
                             L._sm_count(x.device.index), tab.element_size(),
                             route=route, **kw)
    out = torch.empty((x.shape[0], idx.shape[0]), dtype=torch.int32,
                      device=x.device)
    L._launch_layer(x, idx, tab, bw, out, geom)
    return out


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_routes_match_plain(dev, case):
    """Both routes (forced, at the rule's geometry and at others) and the
    routed wrapper, as programmatic dependent launches, with the table 4
    bytes past a 16-byte boundary, and on a uint8 copy of the table (also 1
    byte past one; the sweep's comparison) where every entry fits a byte:
    bit for bit the plain version."""
    x_all, idx, tab, bw = _layer_cases()[case]
    idx_d, tab_d = _on(dev, idx, tab)
    tables = {"": tab_d, " shifted": _shifted(tab_d)}
    if tab.min() >= 0 and tab.max() < 256:
        tab8 = tab_d.to(torch.uint8)
        tables.update({" uint8": tab8, " uint8 shifted": _shifted(tab8)})
    torch.cuda.synchronize()
    for batch in LUT_BATCHES + (1000,):
        x = _on(dev, x_all[:batch])[0]
        want = lut_lookup_plain(x, idx_d, tab_d, bw)
        _check(lut_lookup, lambda c: lut_lookup(c, idx_d, tab_d, bw),
               lambda c: lut_lookup_plain(c, idx_d, tab_d, bw), x)
        outs = {"wrapper shifted": lut_lookup(x, idx_d, tables[" shifted"],
                                              bw)}
        for route in ("smem", "direct"):
            if route == "smem" and L.layer_smem_bytes(
                    x.shape[1], idx.shape[1], tab.shape[1], 1, 1,
                    True) > L.LAYER_SMEM_BYTES:
                continue
            for name, t in tables.items():
                outs[f"{route}{name}"] = _layer_direct(x, idx_d, t, bw,
                                                       route)
            # small tiles: blocks walk several batch tiles (smem)
            outs[f"{route} small tiles"] = _layer_direct(
                x, idx_d, tab_d, bw, route, tile_o=3, tile_b=5)
        torch.cuda.synchronize()
        for name, out in outs.items():
            assert torch.equal(out, want), (case, batch, name)


def test_layer_smem_bytes_agree_with_the_kernel(dev):
    from repro_torch.kernels import _build
    lib = _build.library()
    for n_in, fan_in, n_e, tile_o, tile_b in (
            (16, 3, 512, 16, 32), (64, 5, 1024, 21, 7), (32, 6, 4096, 5, 32),
            (7, 2, 9, 13, 1), (300, 4, 0, 1, 3)):
        for stage in (0, 1):
            for n_buf in (1, 2):
                for elem in (1, 4):
                    assert lib.lut_layer_smem_bytes(
                        n_in, fan_in, n_e, elem, tile_o, tile_b, stage,
                        n_buf) == L.layer_smem_bytes(
                            n_in, fan_in, n_e, tile_o, tile_b, bool(stage),
                            n_buf, elem)


@pytest.mark.parametrize("batch", [17, 4096])
def test_layer_chain_of_dependent_launches(dev, batch):
    """A queued chain of 48 layers of random widths, every launch
    programmatically dependent on the one before, intermediates dropped
    as they go (so the caching allocator hands a layer's output the memory
    its predecessor is still reading): an early read of codes or an early
    write would show against the plain chain."""
    rng = np.random.default_rng(batch)
    widths = [16] + [int(w) for w in rng.integers(4, 200, 48)]
    layers = []
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        fi = int(rng.integers(1, min(5, n_in) + 1))
        idx = rng.integers(0, n_in, (n_out, fi), dtype=np.int32)
        tab = rng.integers(0, 4, (n_out, 4 ** fi), dtype=np.int32)
        layers.append(tuple(_on(dev, idx, tab)) + (2,))
    x = _on(dev, codes(16, batch, hi=4, seed=1))[0]
    want = x
    for idx, tab, bw in layers:
        want = lut_lookup_plain(want, idx, tab, bw)
    routes = ("smem", "direct", None)
    for rep in range(3):
        c = x
        for i, (idx, tab, bw) in enumerate(layers):
            route = routes[(i + rep) % 3]
            c = (lut_lookup(c, idx, tab, bw) if route is None
                 else _layer_direct(c, idx, tab, bw, route))
        torch.cuda.synchronize()
        assert torch.equal(c, want), rep


def test_layer_launch_counters(dev):
    """The wrapper counts each launch once, on the route the rule picks:
    model A's middle layer at batch 16 stages its tables, at 4096 reads
    them in place."""
    x_all, idx, tab, bw = _layer_cases()["A1"]
    idx_d, tab_d = _on(dev, idx, tab)
    for batch, route in ((16, "smem"), (4096, "direct")):
        x = _on(dev, x_all[:batch])[0]
        before = (lut_lookup.launches, dict(lut_lookup.launches_by_route))
        lut_lookup(x, idx_d, tab_d, bw)
        assert lut_lookup.launches == before[0] + 1
        assert lut_lookup.launches_by_route == {
            r: n + (r == route) for r, n in before[1].items()}


# the layers of Table 7.1's widest MNIST MLP: (n_in, n_out, fan_in, entries)
MNIST_LAYERS = ((784, 2048, 5, 1024), (2048, 2048, 5, 1024))


@pytest.mark.parametrize("n_in,n_out,fan_in,n_e", MNIST_LAYERS)
def test_layer_routes_at_mnist_widths(dev, n_in, n_out, fan_in, n_e):
    """The routed wrapper and each route forced at its own geometry, at
    the MNIST MLP's widths and batches 1, 16, 256 and 4096: bit for bit
    the plain version."""
    x_all, idx, tab, bw = _edge_layer(n_in, n_out, fan_in, 2, n_e, 4,
                                      seed=n_in)
    idx_d, tab_d = _on(dev, idx, tab)
    for batch in (1, 16, 256, 4096):
        x = _on(dev, x_all[:batch])[0]
        want = lut_lookup_plain(x, idx_d, tab_d, bw)
        _check(lut_lookup, lambda c: lut_lookup(c, idx_d, tab_d, bw),
               lambda c: lut_lookup_plain(c, idx_d, tab_d, bw), x)
        for route in ("smem", "direct"):
            got = _layer_direct(x, idx_d, tab_d, bw, route)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (batch, route)


def test_cached_compile_keyed_by_device(dev):
    """A CPU call and a CUDA call with the same arrays make two entries,
    each on its own device; ``cuda`` and ``cuda:<current>`` are one."""
    from repro_torch.kernels import ops

    engine.cache_clear()
    layers = random_stack((8, 6, 4), (2, 2), (2, 2), seed=3)
    kw = dict(optimize_level=None, in_features=8, fused=True,
              use_pallas=True, block_b=8,
              budget_bytes=ops.FUSED_SMEM_BUDGET_BYTES)
    on_cpu = engine.cached_compile(layers, device="cpu", **kw)
    on_card = engine.cached_compile(layers, device=dev, **kw)
    assert engine.cache_size() == 2
    assert on_cpu.device.type == "cpu" and on_card.device.type == "cuda"
    here = torch.device("cuda", torch.cuda.current_device())
    assert engine.cached_compile(layers, device=here, **kw) is on_card
    x = codes(8, 33, hi=4, seed=1)
    before = P.lut_network.launches
    got = ops.lut_network(torch.from_numpy(x).to(dev), layers, block_b=8)
    assert P.lut_network.launches == before + 1 and engine.cache_size() == 2
    assert torch.equal(got.cpu(), ops.lut_network(torch.from_numpy(x),
                                                  layers, block_b=8))
    engine.cache_clear()


def test_model_d_served_per_layer_matches_reference(dev):
    """The engine sends model D to the per-layer kernel by itself; its
    outputs are the reference's."""
    with np.load(MODEL_D) as z:
        ref = {k: z[k] for k in z.files}
    net = engine.compile_network(
        [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
         for i in range(4)], block_b=16, device=dev)
    assert net.layout == "per_layer"
    x = _on(dev, ref["codes"])[0]
    for b in (1, 16, 17, 4096):
        assert torch.equal(net(x[:b]).cpu(),
                           torch.from_numpy(ref["out_uniform"][:b]))


# -- the port's own compiler feeding the mixed kernel

def _fixture(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("model", ["A", "D"])
def test_port_compiled_models_on_mixed_kernel(dev, model):
    """Models A and D compiled by the port at level 3 take the mixed layout
    and the smem route; both routes equal the plain version at every
    batch, and the outputs the raw tables' (the reference's)."""
    ref = _fixture(REF if model == "A" else MODEL_D)
    triples = [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
               for i in range(len(ref["bws"]))]
    runs = engine.compile_runs()
    net = engine.compile_network(triples, optimize_level=3, in_features=16,
                                 block_b=16, device=dev)
    assert engine.compile_runs() == runs + 1
    assert net.layout == "mixed" and net.plan.variant.cost.reason == "fused"
    x = _on(dev, ref["codes"])[0]
    for batch in LUT_BATCHES:
        _fused_routes(net.slabs, x[:batch].contiguous())
    want = ref["out_mixed" if model == "A" else "out_uniform"]
    assert torch.equal(net(x).cpu(), torch.from_numpy(want))


@pytest.mark.parametrize("seed,hi", [(0, 2), (1, 3), (2, None)])
def test_port_compiled_random_stacks_on_mixed_kernel(dev, seed, hi):
    """Seeded sparse stacks at level 3 (codes from 2 values, which the
    re-encoding pass narrows to 1 bit, from 3 or from all 4): both routes
    of the mixed kernel equal the plain version, and the raw stack's plain
    chain."""
    from repro_torch import compile as rcompile

    layers = random_stack((16, 40, 24, 12), (3, 4, 2), (2, 2, 2),
                          seed=seed, hi=hi)
    opt = rcompile.optimize(rcompile.tables_from_triples(layers), 3,
                            in_features=16)
    slabs = P.build_mixed_network_slabs(opt.mixed_tables, device=dev)
    for batch in LUT_BATCHES:
        xc = codes(16, batch, hi=4, seed=batch)
        _fused_routes(slabs, _on(dev, xc)[0])
        want = torch.from_numpy(xc)
        for idx, tab, bw in layers:
            want = lut_lookup_plain(want, *(torch.from_numpy(a)
                                            for a in (idx, tab)), bw)
        got = P.lut_network_mixed(_on(dev, xc)[0], slabs)
        assert torch.equal(got.cpu(), want)


def _mm_inputs(dev, m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((m, k), (k, n), (n,)))
    mask = (rng.random((k, n)) < 0.4).astype(np.float32)
    return [t.to(dtype) for t in _on(dev, x, w, mask, b)]


@pytest.mark.parametrize("m,k,n", [(256, 16, 64), (256, 64, 64),
                                   (130, 700, 50), (1, 1, 1), (65, 129, 63)])
@pytest.mark.parametrize("dtype,atol,rtol,steps",
                         [(torch.float32, 1e-4, 1e-5, 0),
                          (torch.bfloat16, 5e-2, 1e-3, 1)])
def test_masked_matmul_matches_plain(dev, m, k, n, dtype, atol, rtol, steps):
    x, w, mask, b = _mm_inputs(dev, m, k, n, dtype, seed=m + k + n)
    for bias in (b, None):
        before = masked_matmul.launches
        got = masked_matmul(x, w, mask, bias)
        torch.cuda.synchronize()
        assert masked_matmul.launches == before + 1
        assert got.dtype == dtype and got.shape == (m, n)
        want = masked_matmul_plain(x, w, mask, bias).float()
        # ``steps`` units in the last place of the output dtype at |want|
        _, e = torch.frexp(want)
        ulp = torch.ldexp(torch.full_like(want, torch.finfo(dtype).eps / 2),
                          e)
        diff = (got.float() - want).abs()
        limit = atol + rtol * want.abs() + steps * ulp
        assert (diff <= limit).all(), float((diff - limit).max())


def _mm_check(x, w, mask, b, atol, rtol, steps):
    """One launch, on the route the rule names, within the tolerance."""
    m, k = x.shape
    n = w.shape[1]
    route = masked_matmul_route(x.dtype, k, n)
    before = dict(masked_matmul.launches_by_route)
    got = masked_matmul(x, w, mask, b)
    torch.cuda.synchronize()
    assert masked_matmul.launches_by_route[route] == before[route] + 1
    assert sum(masked_matmul.launches_by_route.values()) == \
        sum(before.values()) + 1
    assert got.dtype == x.dtype and got.shape == (m, n)
    want = masked_matmul_plain(x, w, mask, b).float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.full_like(want, torch.finfo(x.dtype).eps / 2), e)
    diff = (got.float() - want).abs()
    limit = atol + rtol * want.abs() + steps * ulp
    assert (diff <= limit).all(), float((diff - limit).max())
    return got, route


@pytest.mark.parametrize("m,k,n,route", [
    (130, 712, 56, "wgmma"), (1000, 4104, 4096, "wgmma"),
    (256, 16, 64, "wgmma"), (1, 8, 8, "wgmma"), (129, 64, 136, "wgmma"),
    (257, 64, 136, "wgmma"), (300, 64, 136, "wgmma"),
    (130, 700, 50, "simt"), (64, 60, 64, "simt"), (64, 64, 60, "simt")])
def test_masked_matmul_bf16_routes(dev, m, k, n, route):
    """bfloat16 with K and N multiples of 8 runs the tensor-core kernel,
    ragged against its 256 x 128 x 64 tiles; any other bfloat16 shape the
    SIMT kernel; both within the bfloat16 tolerance, with and without b."""
    x, w, mask, b = _mm_inputs(dev, m, k, n, torch.bfloat16, seed=m + k)
    for bias in (b, None):
        _, ran = _mm_check(x, w, mask, bias, 5e-2, 1e-3, 1)
        assert ran == route


def test_masked_matmul_float32_stays_simt(dev):
    """float32 stays on the CUDA cores (no tensor core keeps its ascending-k
    fmaf order): the ffma route."""
    x, w, mask, b = _mm_inputs(dev, 256, 64, 64, torch.float32)
    _, ran = _mm_check(x, w, mask, b, 1e-4, 1e-5, 0)
    assert ran == "ffma"


def _simt_f32(x, w, mask, b):
    """The first design, ``masked_matmul_forward``, called directly and
    uncounted: the float32 order oracle of the ffma kernel."""
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    MM._launch_simt(x, w, mask, b, out)
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


# around both tiles: the small one (32 x 32, K panels of 64) and the large
# one (128 x 256, K tiles of 8; 132 or more of them), with K and N not
# multiples of 4 (scalar loads) and ragged M, N and K edges
FFMA_SHAPES = [(1, 1, 1), (31, 63, 33), (32, 64, 32), (33, 65, 31),
               (256, 16, 64), (256, 64, 64), (256, 64, 16), (130, 700, 50),
               (129, 65, 127), (64, 70, 64), (1536, 64, 2816),
               (1537, 37, 2817), (1500, 130, 3001), (2048, 1024, 4096)]


@pytest.mark.parametrize("m,k,n", FFMA_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_masked_matmul_ffma_bit_identical_to_simt(dev, m, k, n, transposed):
    """The ffma kernel, with w and mask as (K, N) or read as (N, K), equals
    ``masked_matmul_forward`` on the same inputs bit for bit, with and
    without b, and launches once on the ffma route."""
    x, w, mask, b = _mm_inputs(dev, m, k, n, torch.float32, seed=m + k + n)
    ops = ((w.t().contiguous(), mask.t().contiguous()) if transposed
           else (w, mask))
    for bias in (b, None):
        want = _simt_f32(x, w, mask, bias)
        before = dict(masked_matmul.launches_by_route)
        got = masked_matmul(x, *ops, bias, transposed=transposed)
        torch.cuda.synchronize()
        assert masked_matmul.launches_by_route["ffma"] == before["ffma"] + 1
        assert sum(masked_matmul.launches_by_route.values()) == \
            sum(before.values()) + 1
        assert got.shape == (m, n)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("m,k,n", [(300, 64, 200), (1536, 64, 2816)])
def test_masked_matmul_ffma_unaligned_views_bit_identical(dev, m, k, n):
    """Operands that start 4 bytes past a 16-byte boundary take the scalar
    loads and give the same bits."""
    x, w, mask, b = _mm_inputs(dev, m, k, n, torch.float32, seed=5)

    def shifted(t):
        v = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
        v.copy_(t)
        return v

    got = masked_matmul(shifted(x), shifted(w), shifted(mask), shifted(b))
    assert torch.equal(_bits(got), _bits(_simt_f32(x, w, mask, b)))


@pytest.mark.parametrize("m,k,n", [(256, 64, 64), (1536, 64, 2816)])
def test_masked_matmul_ffma_mask_is_exact(dev, m, k, n):
    """Masked-out weights of 1e9 vanish exactly on both tiles and both
    reads: the result equals the call with those weights zeroed."""
    x, w, mask, b = _mm_inputs(dev, m, k, n, torch.float32, seed=6)
    loud = torch.where(mask.bool(), w, torch.full_like(w, 1e9))
    want = masked_matmul(x, w * mask, mask, b)
    assert torch.equal(_bits(masked_matmul(x, loud, mask, b)), _bits(want))
    got = masked_matmul(x, loud.t().contiguous(), mask.t().contiguous(), b,
                        transposed=True)
    assert torch.equal(_bits(got), _bits(want))


def test_masked_matmul_dx_reads_transposed_operands(dev, monkeypatch):
    """``MaskedMatmulFn``'s float32 dx reads w and mask as (N, K): no
    transposed copy is made, it launches on the ffma route, and it equals
    the copy-based dx (the first design on w^T, mask^T) bit for bit."""
    x, w, mask, b = _mm_inputs(dev, 256, 64, 64, torch.float32)
    dy = _on(dev, np.random.default_rng(1).standard_normal(
        (256, 64)).astype(np.float32))[0]
    copies = []
    contiguous = torch.Tensor.contiguous

    def watched(t, *a, **kw):
        if not t.is_contiguous():
            copies.append(tuple(t.shape))
        return contiguous(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "contiguous", watched)
    xi = x.clone().requires_grad_()
    before = masked_matmul.launches_by_route["ffma"]
    MaskedMatmulFn.apply(xi, w, mask, b).backward(dy)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert copies == []
    assert masked_matmul.launches_by_route["ffma"] == before + 2
    want = _simt_f32(dy, w.t().contiguous(), mask.t().contiguous(), None)
    assert torch.equal(_bits(xi.grad), _bits(want))


def test_masked_matmul_transposed_only_on_ffma(dev):
    x, w, mask, b = _mm_inputs(dev, 64, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="ffma"):
        masked_matmul(x, w.t().contiguous(), mask.t().contiguous(),
                      transposed=True)


def test_masked_matmul_bf16_mask_is_exact(dev):
    """Masked-out weights of 1e9 vanish exactly on the tensor-core route:
    the result equals, bit for bit, the same call with those weights
    zeroed (the mask is applied in shared memory before wgmma reads it)."""
    x, w, mask, b = _mm_inputs(dev, 200, 256, 192, torch.bfloat16, seed=3)
    loud = torch.where(mask.bool(), w, torch.full_like(w, 1e9))
    got, ran = _mm_check(x, loud, mask, b, 5e-2, 1e-3, 1)
    assert ran == "wgmma"
    assert torch.equal(got, masked_matmul(x, w * mask, mask, b))
    ones = torch.ones((64, 64), dtype=torch.bfloat16, device=dev)
    big = torch.full((64, 64), 1e9, dtype=torch.bfloat16, device=dev)
    m1 = torch.zeros((64, 64), dtype=torch.bfloat16, device=dev)
    m1[0] = 1.0
    assert (masked_matmul(ones, big, m1) == big[0, 0]).all()


def test_masked_matmul_mask_is_exact(dev):
    x = torch.ones((4, 8), device=dev)
    w = torch.full((8, 4), 1e9, device=dev)
    mask = torch.zeros((8, 4), device=dev)
    mask[0] = 1.0
    assert (masked_matmul(x, w, mask) == 1e9).all()


def test_masked_matmul_backward_launches_dx_only_when_needed(dev):
    x, w, mask, b = _mm_inputs(dev, 256, 64, 64, torch.float32)
    for x_grad, launches in ((False, 1), (True, 2)):
        # fresh leaves each pass, so no gradient carries over
        xi, wi, bi = (t.clone().requires_grad_(g)
                      for t, g in ((x, x_grad), (w, True), (b, True)))
        before = masked_matmul.launches
        MaskedMatmulFn.apply(xi, wi, mask, bi).square().sum().backward()
        torch.cuda.synchronize()
        assert masked_matmul.launches == before + launches
        # the gradients equal autograd of the plain version
        xp, wp, bp = (t.clone().requires_grad_() for t in (x, w, b))
        masked_matmul_plain(xp, wp, mask, bp).square().sum().backward()
        pairs = [(wi, wp), (bi, bp)] + ([(xi, xp)] if x_grad else [])
        for got, want in pairs:
            torch.testing.assert_close(got.grad, want.grad, atol=1e-4,
                                       rtol=1e-5)
        assert x_grad or xi.grad is None


def _close(got, want, atol, rtol, steps):
    """|got - want| within atol + rtol |want| + ``steps`` units in the last
    place of ``got``'s dtype at |want|."""
    want = want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.full_like(want, torch.finfo(got.dtype).eps / 2),
                      e)
    diff = (got.float() - want).abs()
    limit = atol + rtol * want.abs() + steps * ulp
    assert (diff <= limit).all(), float((diff - limit).max())


@functools.lru_cache(maxsize=1)
def _lm_ffn_masks():
    """qwen3-1.7b's LogicNet-FFN masks (fan-in 16): mask_in (2048, 6144),
    mask_out (6144, 2048) and their transposes (the input gradients')."""
    from repro_torch.models.config import LogicNetFFNCfg
    from repro_torch.models.layers import logicnet_masks
    mask_in, mask_out = logicnet_masks(2048, 6144, LogicNetFFNCfg())
    return {"in": mask_in, "out": mask_out,
            "in_t": mask_in.t().contiguous(),
            "out_t": mask_out.t().contiguous()}


@pytest.mark.parametrize("m,which", [(2048, "in"), (2048, "out"),
                                     (2048, "in_t"), (2048, "out_t"),
                                     (8192, "in"), (8192, "out"),
                                     (4, "in"), (4, "out")])
def test_masked_matmul_at_the_lm_ffn_shapes(dev, m, which):
    """The LogicNet-FFN's products at batch 8 x seq 256 (M 2048), at a
    prefill of 4 x 2048 tokens (M 8192) and at 4 decode slots, forward and
    input-gradient operands, with the model's fan-in-16 masks: one wgmma
    launch each, within one bfloat16 step of the plain output plus 1e-3 of
    its rms.  These outputs have an rms of 0.05-0.09, so the reference's
    atol of 5e-2 would not tell a kernel that accumulates in bfloat16 from
    a right one."""
    mask = _lm_ffn_masks()[which].to(dev, torch.bfloat16)
    k, n = mask.shape
    rng = np.random.default_rng(m + k)
    x, w = _on(dev, rng.standard_normal((m, k)).astype(np.float32),
               (rng.standard_normal((k, n)) / k ** 0.5).astype(np.float32))
    x, w = x.bfloat16(), w.bfloat16()
    rms = float(masked_matmul_plain(x, w, mask).float().square().mean()
                .sqrt())
    _, ran = _mm_check(x, w, mask, None, 1e-3 * rms, 0.0, 1)
    assert ran == "wgmma"


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-5, 0)),
                                       (torch.bfloat16, (5e-2, 1e-3, 2))])
def test_masked_matmul_fn_mask_gradient_on_the_card(dev, dtype, tol):
    """With the mask requiring grad (the LM's masks do, for the clip norm)
    ``MaskedMatmulFn`` gives dx, dw and dmask = (x^T dy) * w within the
    tolerance of autograd of the plain version, and launches the kernel
    twice (forward, dx).  bfloat16 allows two steps: (x^T dy) rounds to
    bfloat16 before the product with w, as the reference's does."""
    x, w, mask, _ = _mm_inputs(dev, 512, 256, 384, dtype, seed=11)
    dy = _on(dev, np.random.default_rng(12).standard_normal(
        (512, 384)).astype(np.float32))[0].to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, mask)]
    plain = [t.clone().requires_grad_() for t in (x, w, mask)]
    before = masked_matmul.launches
    MaskedMatmulFn.apply(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert masked_matmul.launches == before + 2
    masked_matmul_plain(*plain).backward(dy)
    for got, want in zip(leaves, plain):
        assert got.grad.dtype == dtype
        _close(got.grad, want.grad, *tol)
    assert float(leaves[2].grad.float().abs().max()) > 0


def test_lm_training_step_at_full_width(dev):
    """One step of qwen3-1.7b with the LogicNet-FFN at full width, the
    depth cut to 2 layers: 18 masked-matmul launches (2 layers x 3
    products x forward, remat's recompute and dx), all wgmma; a finite
    loss; pruned weights 0 and 16 ones a mask column after it; then one
    decode step of the trained model, without grad: 2 masked-matmul
    launches (``wo``), 2 fused ``wi`` launches and 2 input quantizers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.config import LogicNetFFNCfg

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2,
                              logicnet_ffn=LogicNetFFNCfg())
    state = steps.make_train_state(cfg, seed=0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
        cfg.vocab, 256, 8).batch(0).items()}
    before = dict(masked_matmul.launches_by_route)
    state, loss = steps.make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    after = masked_matmul.launches_by_route
    assert {r: after[r] - before[r] for r in after} == \
        {"simt": 0, "wgmma": 18, "ffma": 0}
    assert bool(torch.isfinite(loss)) and 11 < float(loss) < 13
    p = state["params"]
    for i in range(2):
        for w, m in (("wi_gate", "mask_in"), ("wi_up", "mask_in"),
                     ("wo", "mask_out")):
            mask = p[f"layers.{i}.ffn.{m}"]
            assert not bool((p[f"layers.{i}.ffn.{w}"][mask == 0]).any())
            assert bool((mask.sum(0) == 16).all())
    model = steps.model_from_state(cfg, state)
    cache = M.init_cache(cfg, 4, 16, device=dev)
    before = (masked_matmul.launches_by_route["wgmma"],
              MM.masked_matmul_swiglu_quant.launches, MM.quant_relu.launches)
    logits, _ = steps.make_decode_step(cfg)(
        model, cache, torch.ones((4, 1), dtype=torch.int32, device=dev),
        torch.zeros(4, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert (masked_matmul.launches_by_route["wgmma"],
            MM.masked_matmul_swiglu_quant.launches,
            MM.quant_relu.launches) == tuple(b + 2 for b in before)
    assert logits.shape == (4, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def _ffn_case(dev, d_model, d_ff, m, seed):
    """A LogicNet-FFN at these widths (its fan-in-16 masks) in bfloat16
    on the card and an input of ``m`` rows; the seed sets the input's
    scale (0.75, 1.5 or 3), so the hidden activations fall in the
    quantizer's range, past its top and near each of its levels."""
    from repro_torch.models.config import LogicNetFFNCfg
    from repro_torch.models.layers import logicnet_masks
    masks = [t.to(dev, torch.bfloat16) for t in logicnet_masks(
        d_model, d_ff, LogicNetFFNCfg())]
    g = torch.Generator(device=dev).manual_seed(1000 * seed + d_ff + m)
    p = {"wi_gate": (torch.randn((d_model, d_ff), generator=g, device=dev)
                     * 0.5).bfloat16(),
         "wi_up": (torch.randn((d_model, d_ff), generator=g, device=dev)
                   * 0.5).bfloat16(),
         "wo": (torch.randn((d_ff, d_model), generator=g, device=dev)
                / 4).bfloat16(),
         "mask_in": masks[0], "mask_out": masks[1]}
    scale = 0.75 * 2 ** seed
    x = (torch.randn((m, d_model), generator=g, device=dev) * scale
         ).bfloat16()
    return p, x


def _hq_composed(p, x, q):
    """The composed ``wi`` stage: the quantizers of ``core.quantize``, the
    two masked products on the wgmma route, ``F.silu`` and the product."""
    import torch.nn.functional as F

    from repro_torch.core.quantize import quantize
    xq = quantize(q, x.float()).value.to(x.dtype)
    h = (F.silu(masked_matmul(xq, p["wi_gate"], p["mask_in"]))
         * masked_matmul(xq, p["wi_up"], p["mask_in"]))
    return quantize(q, h.float()).value.to(x.dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d_model,d_ff,m", [
    (2048, 6144, 8192), (2048, 6144, 5632), (2048, 6144, 4),
    (2048, 6144, 1000), (2560, 10240, 4096), (1536, 8960, 4096)])
def test_fused_ffn_equals_composed_bit_for_bit(dev, d_model, d_ff, m, seed):
    """The fused ``wi`` stage (``quant_relu``, then
    ``masked_matmul_swiglu_quant``) gives the composed path's ``hq`` bit
    for bit, and ``logicnet_ffn_apply`` the same output after ``wo`` on
    either path: without grad it takes the fused path (one launch of each
    kernel, one masked matmul), with an input that requires grad the
    composed one (three masked matmuls), qwen3-1.7b's, zamba2-2.7b's and
    qwen2-vl-2b's widths, M ragged and at 4 decode slots."""
    from repro_torch.core.quantize import QuantizerCfg
    from repro_torch.models import layers as L
    from repro_torch.models.config import LogicNetFFNCfg

    cfg = LogicNetFFNCfg()
    q = QuantizerCfg(cfg.bw, cfg.max_val)
    p, x = _ffn_case(dev, d_model, d_ff, m, seed)
    fused, quant = (MM.masked_matmul_swiglu_quant.launches,
                    MM.quant_relu.launches)
    hq = MM.masked_matmul_swiglu_quant(MM.quant_relu(x, q), p["wi_gate"],
                                       p["wi_up"], p["mask_in"], q)
    want = _hq_composed(p, x, q)
    torch.cuda.synchronize()
    assert (MM.masked_matmul_swiglu_quant.launches,
            MM.quant_relu.launches) == (fused + 1, quant + 1)
    assert hq.shape == (m, d_ff) and hq.dtype == torch.bfloat16
    assert torch.equal(hq.view(torch.int16), want.view(torch.int16))
    levels = torch.bincount(torch.round(want.float() / q.step).long().flatten(),
                            minlength=q.n_levels)
    assert int((levels > 0).sum()) >= q.n_levels // 2 or m == 4

    paths = dict(L.logicnet_ffn_apply.paths)
    mm, fused = masked_matmul.launches, MM.masked_matmul_swiglu_quant.launches
    with torch.no_grad():
        out_fused = L.logicnet_ffn_apply(p, x[None], cfg)
    torch.cuda.synchronize()
    assert (masked_matmul.launches - mm,
            MM.masked_matmul_swiglu_quant.launches - fused) == (1, 1)
    out_composed = L.logicnet_ffn_apply(p, x[None].clone().requires_grad_(),
                                        cfg)
    torch.cuda.synchronize()
    assert (masked_matmul.launches - mm,
            MM.masked_matmul_swiglu_quant.launches - fused) == (4, 1)
    assert L.logicnet_ffn_apply.paths == {
        "fused": paths["fused"] + 1, "composed": paths["composed"] + 1}
    assert torch.equal(out_fused.view(torch.int16),
                       out_composed.detach().view(torch.int16))


def test_quant_relu_kernel_equals_quantize_on_edges(dev):
    """The input quantizer's kernel against ``core.quantize`` on the card:
    every finite bfloat16 value from -8 to 8, the bfloat16 neighbours of
    each level's midpoint, -0, the infinities, NaN, lengths with a ragged
    tail past a multiple of 8, and views 2 bytes past a 16-byte boundary
    (the wrapper copies them); bit for bit, and NaN where ``quantize``
    gives NaN; -0 comes out +0."""
    from repro_torch.core.quantize import QuantizerCfg
    for q in (QuantizerCfg(4, 4.0), QuantizerCfg(2, 1.0)):
        step = float(torch.tensor(q.step, dtype=torch.float32))
        grid = torch.arange(-32768, 32768, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16)
        grid = grid[grid.float().abs() <= 8]
        mids = torch.tensor([step * (k + 0.5) for k in range(q.n_levels)]
                            ).bfloat16().view(torch.int16)
        near = torch.stack([mids, mids + 1, mids - 1]).view(torch.bfloat16)
        special = torch.tensor([-0.0, 0.0, float("inf"), float("-inf"),
                                float("nan")], dtype=torch.bfloat16)
        x = torch.cat([grid, near.flatten(), special]).to(dev)
        for n in (x.numel(), x.numel() - 3, 13):
            for off in (0, 1):
                xin = x[off:n + off]
                before = MM.quant_relu.launches
                got = MM.quant_relu(xin, q)
                want = MM.quant_relu_plain(xin, q)
                torch.cuda.synchronize()
                assert MM.quant_relu.launches == before + 1
                nan = torch.isnan(want)
                assert torch.equal(torch.isnan(got), nan)
                assert torch.equal(got[~nan].view(torch.int16),
                                   want[~nan].view(torch.int16))
                assert not bool(torch.signbit(got[~nan]).any())


def test_fused_ffn_refuses_what_the_kernel_cannot_take(dev):
    from repro_torch.core.quantize import QuantizerCfg
    q = QuantizerCfg(4, 4.0)
    x = torch.zeros((16, 64), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((64, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        MM.masked_matmul_swiglu_quant(x.float(), w, w, w, q)
    with pytest.raises(ValueError, match="chain"):
        MM.masked_matmul_swiglu_quant(x, w, w[:, :64].contiguous(), w, q)
    with pytest.raises(ValueError, match="multiples of 8"):
        MM.masked_matmul_swiglu_quant(x[:, :60].contiguous(),
                                      w[:60].contiguous(),
                                      w[:60].contiguous(),
                                      w[:60].contiguous(), q)
    with pytest.raises(ValueError, match="QuantReLU"):
        MM.masked_matmul_swiglu_quant(x, w, w, w, QuantizerCfg(1, 1.0))
    with pytest.raises(ValueError, match="QuantReLU"):
        MM.quant_relu(x, QuantizerCfg(1, 1.0))
    with pytest.raises(ValueError, match="contiguous"):
        MM.quant_relu(x.t(), q)


def test_masked_matmul_refuses_what_the_kernel_cannot_take(dev):
    x, w, mask, b = _mm_inputs(dev, 8, 6, 4, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        masked_matmul(x, w.bfloat16(), mask, b)
    with pytest.raises(TypeError, match="dtype"):
        masked_matmul(x.double(), w.double(), mask.double())
    with pytest.raises(ValueError, match="contiguous"):
        masked_matmul(x, w.T.contiguous().T, mask, b)
    with pytest.raises(ValueError, match="expected"):
        masked_matmul(x, w.cpu(), mask, b)
    with pytest.raises(ValueError, match="chain"):
        masked_matmul(x, w[:5].contiguous(), mask, b)


def test_training_on_the_card_matches_the_cpu(dev):
    """Five steps of model A from the reference-made init: the card's
    losses equal the CPU's within rtol 1e-3, and each step launches the
    masked matmul 5 times (3 forward, 2 input gradients)."""
    x, y = jet_substructure_data(8000, seed=0)
    init = LN.reference_from_arrays(load_train(), "init")
    cfg = fpga4hep.model_a()
    losses = {}
    for where in ("cpu", "cuda"):
        before = masked_matmul.launches
        ffma = masked_matmul.launches_by_route["ffma"]
        res = train_logicnet(cfg, x[:7000], y[:7000], x[7000:], y[7000:],
                             steps=5, seed=0, device=where,
                             net=LN.from_reference(cfg, init, device="cpu"))
        losses[where] = res.losses
        if where == "cuda":
            # 5 per step, then 3 for the held-out accuracy forward, all
            # float32 on the ffma route
            assert masked_matmul.launches - before == 5 * 5 + 3
            assert masked_matmul.launches_by_route["ffma"] - ffma == 5 * 5 + 3
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


FLASH_TOL = {torch.float32: (1e-5, 1e-5, 0), torch.bfloat16: (3e-2, 0.0, 1)}
# the tensor-core route's second gate, beside FLASH_TOL: 1e-3 plus two
# bfloat16 steps of the plain output, elementwise (kernel and plain version
# differ far below one step; FLASH_TOL's 3e-2 is about an output's size at
# S 2048, so alone it would pass a kernel that reads a stale K/V stage)
FLASH_GATE = (1e-3, 0.0, 2)


def _qkv(dev, b, hq, hkv, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=dev, dtype=dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _flash_limit(want, dtype, atol, rtol, steps):
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.full_like(want, torch.finfo(dtype).eps / 2), e)
    return atol + rtol * want.abs() + steps * ulp


def _flash_check(q, k, v, **kw):
    """One launch within FLASH_TOL and, on the tensor-core route, within
    FLASH_GATE."""
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, **kw).float()
    diff = (got.float() - want).abs()
    limit = _flash_limit(want, q.dtype, *FLASH_TOL[q.dtype])
    assert (diff <= limit).all(), float((diff - limit).max())
    if flash_attention_route(q.dtype, q.shape[-1]) == "wgmma":
        gate = _flash_limit(want, q.dtype, *FLASH_GATE)
        assert (diff <= gate).all(), float((diff - gate).max())


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 64, 16), (2, 4, 2, 96, 32), (1, 8, 1, 128, 16),
    (2, 4, 4, 250, 8), (1, 4, 2, 65, 16), (1, 2, 1, 1000, 64),
    (1, 4, 2, 300, 256), (1, 2, 2, 70, 6)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, b, hq, hkv, s, d, causal, dtype):
    _flash_check(*_qkv(dev, b, hq, hkv, s, d, dtype, seed=s + d),
                 causal=causal)


@pytest.mark.parametrize("window,causal,shape", [
    (16, True, (1, 2, 2, 128, 16)), (64, True, (1, 2, 2, 128, 16)),
    (1024, True, (1, 2, 2, 128, 16)), (1024, True, (1, 16, 8, 2048, 128)),
    (100, False, (1, 4, 2, 300, 32)), (1, True, (1, 2, 1, 130, 16))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_matches_plain(dev, window, causal, shape,
                                              dtype):
    _flash_check(*_qkv(dev, *shape, dtype, seed=window), causal=causal,
                 window=window)


def _flash_route_check(q, k, v, **kw):
    route = flash_attention_route(q.dtype, q.shape[-1])
    before = dict(flash_attention.launches_by_route)
    _flash_check(q, k, v, **kw)
    assert flash_attention.launches_by_route[route] == before[route] + 1
    return route


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 65, 64), (2, 4, 2, 250, 128), (1, 8, 1, 1000, 16),
    (1, 4, 4, 130, 256), (1, 16, 2, 300, 128), (2, 6, 2, 200, 64),
    (1, 2, 1, 1000, 128), (1, 4, 2, 64, 8), (4, 16, 8, 2048, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tensor_core_route(dev, b, hq, hkv, s, d,
                                                causal):
    """bfloat16 with D % 8 == 0 runs the wgmma kernel: GQA groups 1, 2, 3
    and 8, D 8 to 256, S not a multiple of its tiles, and qwen3-1.7b's
    prefill shape, at the unchanged tolerance and the second gate."""
    q, k, v = _qkv(dev, b, hq, hkv, s, d, torch.bfloat16, seed=s + d + hq)
    assert _flash_route_check(q, k, v, causal=causal) == "wgmma"


@pytest.mark.parametrize("window", [16, 64, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 2, 1000, 128), (1, 2, 2, 250, 64),
                                   (1, 8, 1, 300, 256)])
def test_flash_attention_bf16_windows(dev, window, causal, shape):
    q, k, v = _qkv(dev, *shape, torch.bfloat16, seed=window)
    assert _flash_route_check(q, k, v, causal=causal,
                              window=window) == "wgmma"


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, hq, hkv, s, d) for hq, hkv in ((4, 4), (4, 2), (8, 1))
    for d in (8, 64, 128, 256) for s in (65, 250, 1000)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_tensor_core_route(dev, b, hq, hkv, s, d,
                                               causal):
    """float32 with D % 8 == 0 runs the tf32x3 kernel: GQA groups 1, 2 and
    8, D 8 to 256, S not a multiple of its tiles, within FLASH_TOL's
    float32 atol 1e-5 / rtol 1e-5."""
    q, k, v = _qkv(dev, b, hq, hkv, s, d, torch.float32, seed=s + d + hq)
    assert _flash_route_check(q, k, v, causal=causal) == "tf32x3"


@pytest.mark.parametrize("window", [16, 64, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 2, 1000, 128), (1, 2, 2, 250, 64),
                                   (1, 8, 1, 300, 256)])
def test_flash_attention_f32_windows(dev, window, causal, shape):
    q, k, v = _qkv(dev, *shape, torch.float32, seed=window)
    assert _flash_route_check(q, k, v, causal=causal,
                              window=window) == "tf32x3"


@pytest.mark.parametrize("sq,skv", [(1, 1500), (65, 250), (448, 1500),
                                    (250, 65), (1, 1), (130, 64)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("d,dtype,route", [
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (64, torch.float32, "tf32x3"), (128, torch.float32, "tf32x3"),
    (12, torch.bfloat16, "simt"), (12, torch.float32, "simt")])
def test_flash_attention_cross_lengths(dev, sq, skv, hq, hkv, d, dtype,
                                       route):
    """Sq != Skv (cross-attention: whisper's 448 decoder tokens or one
    decode token against 1500 frames), non-causal, on every route: query
    tiles over Sq, key tiles and masks over Skv, on the transposed
    (B, S, H, D) views ``cross_attn_apply`` passes; within FLASH_TOL (and
    FLASH_GATE on wgmma)."""
    rng = np.random.default_rng(sq * skv + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, h, d)).astype(
        np.float32)).to(device=dev, dtype=dtype).transpose(1, 2)
        for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    assert _flash_route_check(q, k, v, causal=False) == route


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False,
                                                   "window": 8}])
def test_flash_attention_refuses_masked_cross_lengths(dev, kw):
    q, k, v = _qkv(dev, 1, 2, 2, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention(q[:, :, :16], k, v, **kw)


@pytest.mark.parametrize("s", [65, 250, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mha_at_head_dim_80(dev, s, causal, dtype):
    """zamba2-2.7b's shared attention: MHA (Hq = Hkv = 32) at head_dim 80,
    which both tensor-core kernels pad to 128, on the transposed (B, S, H,
    D) views the model passes; within FLASH_TOL (and FLASH_GATE on
    wgmma), each head's 80 columns only."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, 32, 80)).astype(
        np.float32)).to(device=dev, dtype=dtype).transpose(1, 2)
        for _ in range(3))
    route = _flash_route_check(q, k, v, causal=causal)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_moe_and_hybrid_prefill_on_the_card_match_the_cpu(dev, arch,
                                                          compute_dtype):
    """The smoke config's prefill on the card against the same weights on
    the CPU (the plain versions): olmoe-1b-7b's 2 flash launches, all
    layers' MoE dispatch on the card, within 1e-4 at float32; zamba2's 2
    shared-attention sites.  At bfloat16 a MoE router may settle a
    near-tie apart on the two devices, so the bfloat16 case runs at
    capacity E / k (nothing dropped) and holds every position whose expert
    sets agree to 0.05."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    # chip_smoke.py's router recorder (importing it runs nothing)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rules", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    if cfg.moe is not None and compute_dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    cpu = steps.init_params(cfg, seed=0, device="cpu")
    card = M.LM(cfg, {n: p.to(dev) for n, p in cpu.params.items()})
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    before = flash_attention.launches
    with cs.record_routing() as on_card:
        got = M.forward(card, {"tokens": tokens.to(dev)}).float().cpu()
    torch.cuda.synchronize()
    sites = cfg.n_layers // cfg.hybrid_attn_every if cfg.is_hybrid \
        else cfg.n_layers
    assert flash_attention.launches - before == sites
    with cs.record_routing() as on_cpu:
        want = M.forward(cpu, {"tokens": tokens}).float()
    keep = torch.ones((2, 64), dtype=torch.bool)
    for a, b in zip(on_card, on_cpu):
        keep &= (a["topi"].cpu().sort(-1).values
                 == b["topi"].sort(-1).values).all(-1)
    tol = 1e-4 if compute_dtype == "float32" else 0.05
    assert int(keep.sum()) >= 120
    torch.testing.assert_close(got[keep], want[keep], atol=tol, rtol=tol)


def test_flash_attention_tf32_matches_simt_at_prefill_shape(dev):
    """At qwen3-1.7b's prefill shape (4, 16, 8, 2048, 128) causal the tf32x3
    route agrees with the SIMT kernel (the earlier float32 design) on the
    same inputs within FLASH_TOL's float32 tolerance, and with the plain
    version."""
    q, k, v = _qkv(dev, 4, 16, 8, 2048, 128, torch.float32, seed=3)
    assert _flash_route_check(q, k, v, causal=True) == "tf32x3"
    got = flash_attention(q, k, v, causal=True)
    simt = torch.empty_like(q)
    FA._launch_simt(q, k, v, simt, True, None, 1.0 / 128 ** 0.5)
    torch.cuda.synchronize()
    limit = _flash_limit(simt, q.dtype, *FLASH_TOL[q.dtype])
    diff = (got - simt).abs()
    assert (diff <= limit).all(), float((diff - limit).max())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 128, "tf32x3"), (torch.float32, 8, "tf32x3"),
    (torch.float32, 6, "simt"), (torch.bfloat16, 12, "simt"),
    (torch.bfloat16, 6, "simt"), (torch.bfloat16, 8, "wgmma")])
def test_flash_attention_routes(dev, dtype, d, route):
    q, k, v = _qkv(dev, 1, 4, 2, 100, d, dtype, seed=d)
    assert _flash_route_check(q, k, v, causal=True) == route


def test_flash_attention_gate_rejects_a_stale_stage(dev):
    """FLASH_GATE tells a kernel that read a stale K/V stage from a sound
    one: the plain version on inputs whose middle 128-key tile is the one
    two tiles before it (a 2-stage ring's slot read before its refill)
    fails the gate; the kernel passes it."""
    q, k, v = _qkv(dev, 1, 16, 8, 2048, 128, torch.bfloat16, seed=11)
    want = flash_attention_plain(q, k, v, causal=True).float()
    stale = [t.clone() for t in (k, v)]
    for t, src in zip(stale, (k, v)):
        t[:, :, 1024:1152] = src[:, :, 768:896]
    diff = (flash_attention_plain(q, *stale, causal=True).float()
            - want).abs()
    assert (diff > _flash_limit(want, q.dtype, *FLASH_GATE)).any()
    _flash_check(q, k, v, causal=True)


@pytest.mark.parametrize("b,s,hq,hkv", [(2, 300, 8, 4), (2, 64, 16, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_reads_strided_views(dev, dtype, b, s, hq, hkv,
                                             monkeypatch):
    """The (B, H, S, D) transpose of a (B, S, H, D) tensor goes in without a
    copy and gives, bit for bit, what its contiguous copy gives; the output
    is the (B, H, S, D) view of a (B, S, H, D) buffer (both tensor-core
    routes).  (2, 64, 16, 8) is qwen3-1.7b's decode-check prefill."""
    rng = np.random.default_rng(5)
    d = 128
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device=dev, dtype=dtype).transpose(1, 2)
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    copies = []
    for name in ("contiguous", "clone"):
        method = getattr(torch.Tensor, name)

        def watched(t, *a, _method=method, _name=name, **kw):
            copies.append((_name, tuple(t.shape)))
            return _method(t, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, watched)
    got = flash_attention(q, k, v, causal=True)
    monkeypatch.undo()
    assert copies == []
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.transpose(1, 2).is_contiguous()
    _flash_check(q, k, v, causal=True)


def test_flash_attention_scale_is_used(dev):
    _flash_check(*_qkv(dev, 2, 4, 2, 80, 32, torch.float32), causal=True,
                 scale=0.05)


def test_flash_attention_refuses_what_the_kernel_cannot_take(dev):
    q, k, v = _qkv(dev, 1, 4, 2, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="expected"):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="expected"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*_qkv(dev, 1, 2, 2, 8, 260, torch.float32))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


# ---------------------------------------------------------------------------
# training attention: the flash kernel's training forward and its backward
# ---------------------------------------------------------------------------

# The backward kernels against the float64 gradients of the same bfloat16
# inputs: one bfloat16 step (each gradient is rounded once from its float32
# sum) plus 1e-4 of the tensor's largest element (P and dS enter their
# products as hi + lo halves, 2^-17 of each term left out, and the sums
# run over up to 2048 terms in float32: some 1e-5 of the largest element).
TRAIN_GRAD_REL = 1e-4
# ... and against autograd through the chunked form (float32, rounded to
# bfloat16 the same way): two steps (each side's rounding) plus the same
# 1e-4 of the largest element.  The log-sum-exp against torch.logsumexp of
# the float32 scores: 2e-5 absolute (float32 exp and log of a sum of up to
# 2048 terms, values up to ~15).
LSE_ATOL = 2e-5


def _train_inputs(dev, b, hq, hkv, s, d, seed):
    q, k, v = _qkv(dev, b, hq, hkv, s, d, torch.bfloat16, seed=seed)
    do = _qkv(dev, b, hq, hq, s, d, torch.bfloat16, seed=seed + 1)[0]
    return q, k, v, do


def _rel_close(got, want, steps):
    _close(got, want, TRAIN_GRAD_REL * float(want.abs().max()), 0.0, steps)


def _kernel_grads(q, k, v, do, causal, scale):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention_train(*leaves, causal=causal, scale=scale)
    out.backward(do)
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 64, 16), (2, 4, 2, 96, 32), (1, 8, 1, 128, 64),
    (2, 4, 4, 250, 8), (1, 4, 2, 65, 128), (1, 2, 1, 130, 80),
    (1, 4, 2, 300, 256), (1, 2, 2, 192, 224), (1, 2, 2, 129, 192)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_train_matches_float64(dev, b, hq, hkv, s, d, causal):
    """The training forward gives the prefill kernel's output bit for bit
    and the row log-sum-exp; the backward (two launches) gives dq, dk, dv
    within TRAIN_GRAD_REL of the float64 gradients."""
    q, k, v, do = _train_inputs(dev, b, hq, hkv, s, d, seed=s + d)
    scale = 0.7 / d ** 0.5
    before = (FA.flash_attention_train.launches,
              FA.flash_attention_backward.launches, flash_attention.launches)
    out, grads = _kernel_grads(q, k, v, do, causal, scale)
    torch.cuda.synchronize()
    assert (FA.flash_attention_train.launches,
            FA.flash_attention_backward.launches,
            flash_attention.launches) == (before[0] + 1, before[1] + 2,
                                          before[2])
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            scale=scale))
    _, lse, o32 = FA._train_forward(q, k, v, causal, scale)
    f64 = [t.double() for t in (q, k, v, do)]
    _, lse64, o64 = FA.flash_attention_train_plain(*f64[:3], causal=causal,
                                                   scale=scale)
    torch.testing.assert_close(lse.double(), lse64, atol=LSE_ATOL, rtol=0)
    _close(o32, o64, 1e-5, 1e-5, 0)
    want = FA.flash_attention_backward_plain(*f64[:3], o64, lse64, f64[3],
                                             causal=causal, scale=scale)
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        _rel_close(got, w, 1)


def test_flash_backward_is_deterministic(dev):
    q, k, v, do = _train_inputs(dev, 2, 4, 2, 320, 128, seed=3)
    first = _kernel_grads(q, k, v, do, True, None)[1]
    second = _kernel_grads(q, k, v, do, True, None)[1]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,scale", [
    ((4, 16, 8, 2048, 128), None),            # qwen3-1.7b's training
    ((4, 32, 32, 2048, 224), 112 ** -0.5)])   # zamba2-7b's shared blocks
def test_flash_train_matches_chunked_autograd_at_the_cells(dev, shape,
                                                           scale):
    """At both train cells' shapes: dq, dk, dv against float32 autograd
    through ``_chunked_attention`` at chunk 1024 (two bfloat16 steps plus
    TRAIN_GRAD_REL of the largest element), the log-sum-exp against the
    float32 scores' (LSE_ATOL)."""
    from repro_torch.models.attention import _chunked_attention
    b, hq, hkv, s, d = shape
    q, k, v, do = _train_inputs(dev, b, hq, hkv, s, d, seed=d)
    _, grads = _kernel_grads(q, k, v, do, True, scale)
    leaves = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    _chunked_attention(*leaves, q_offset=0, window=0, causal=True,
                       chunk=1024, scale=scale).backward(do.transpose(1, 2))
    for got, ref in zip(grads, leaves):
        _rel_close(got, ref.grad.transpose(1, 2), 2)
    del leaves
    _, lse, _ = FA._train_forward(q, k, v, True, scale or d ** -0.5)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                      k.float().repeat_interleave(hq // hkv, 1))
    sc = (sc * (scale or d ** -0.5)).masked_fill(
        torch.ones(s, s, dtype=torch.bool, device=dev).triu(1),
        float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(sc, -1), atol=LSE_ATOL,
                               rtol=0)


# The share of a gradient's elements that differ from the float64
# gradient rounded to nearest bfloat16.  A plain emulation of the kernels'
# arithmetic at the cells' shapes (S 2048, D 128 and 224, standard normal
# inputs) puts it at 0.22-0.29 % with P and dS entering as hi + lo halves
# and at 41-42 % with them rounded to bfloat16 once: 2 % lies 7x above the
# one and 20x below the other.  The tolerances above (a bfloat16 step of
# each element) would pass a kernel that dropped the lo halves; this
# does not.
TRAIN_ROUNDED_SHARE = 0.02


@pytest.mark.parametrize("shape,scale", [
    ((4, 16, 8, 2048, 128), None),
    ((4, 32, 32, 2048, 224), 112 ** -0.5)])
def test_flash_backward_rounds_float32_gradients_at_the_cells(dev, shape,
                                                              scale):
    """At both train cells' shapes at most TRAIN_ROUNDED_SHARE of dq, dk
    and dv differ from the float64 gradients of the same bfloat16 inputs
    rounded to nearest bfloat16: the kernels keep float32 accuracy up to
    the one rounding of the output."""
    b, hq, hkv, s, d = shape
    q, k, v, do = _train_inputs(dev, b, hq, hkv, s, d, seed=d + 1)
    grads = _kernel_grads(q, k, v, do, True, scale)[1]
    scale = scale or d ** -0.5
    f64 = [t.double() for t in (q, k, v, do)]
    _, lse64, o64 = FA.flash_attention_train_plain(*f64[:3], scale=scale)
    want = FA.flash_attention_backward_plain(*f64[:3], o64, lse64, f64[3],
                                             scale=scale)
    del f64, lse64, o64
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        share = float((got != w.to(torch.bfloat16)).double().mean())
        assert share <= TRAIN_ROUNDED_SHARE, (name, share)


def test_lm_training_step_takes_the_flash_route_at_full_width(dev):
    """One qwen3-1.7b step (LogicNet-FFN, 28 layers, 1 x 2048 tokens,
    attn_chunk 1024): 28 training forwards and 28 more in remat's
    recompute, 28 backward calls of two launches each, every attention on
    the flash route; no prefill launch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps
    from repro_torch.models import attention as A
    from repro_torch.models.config import LogicNetFFNCfg

    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              logicnet_ffn=LogicNetFFNCfg())
    assert cfg.n_layers == 28 and cfg.attn_chunk == 1024
    state = steps.make_train_state(cfg, seed=0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
        cfg.vocab, 2048, 1).batch(0).items()}
    before = (FA.flash_attention_train.launches,
              FA.flash_attention_backward.launches, flash_attention.launches,
              dict(A.attn_apply.paths))
    state, loss = steps.make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert FA.flash_attention_train.launches - before[0] == 28 + 28
    assert FA.flash_attention_backward.launches - before[1] == 2 * 28
    assert flash_attention.launches == before[2]
    assert A.attn_apply.paths["flash"] - before[3]["flash"] == 56
    assert A.attn_apply.paths["chunked"] == before[3]["chunked"]


def test_prefill_launches_and_output_are_unchanged(dev):
    """A prefill launches the prefill kernel alone, as before: one
    ``wgmma`` launch a layer and no training launch; the training forward
    on the same layer's heads gives its bits, and a training call that
    needs no gradient launches the prefill kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A

    cfg = get_config("qwen3-1.7b")
    g = torch.Generator(device=dev).manual_seed(0)
    p = {k: t.to(torch.bfloat16) for k, t in A.attn_init(g, cfg).items()}
    x = torch.randn((2, 1024, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    pos = torch.arange(1024, device=dev).expand(2, 1024)
    before = (dict(flash_attention.launches_by_route),
              FA.flash_attention_train.launches)
    prefill = A.attn_apply(p, cfg, x, pos)
    torch.cuda.synchronize()
    after = flash_attention.launches_by_route
    assert {r: after[r] - before[0][r] for r in after} == \
        {"simt": 0, "wgmma": 1, "tf32x3": 0}
    assert FA.flash_attention_train.launches == before[1]
    heads = [t.transpose(1, 2) for t in A._project_qkv(p, cfg, x, pos)]
    out = FA._train_forward(*heads, True, cfg.head_dim ** -0.5)[0]
    assert torch.equal(out, flash_attention(*heads, causal=True))
    assert FA.flash_attention_train.launches == before[1] + 1
    with torch.no_grad():
        trained = A.attn_apply(p, cfg, x, pos, train=True)
    assert FA.flash_attention_train.launches == before[1] + 1
    assert flash_attention.launches_by_route["wgmma"] == \
        before[0]["wgmma"] + 3
    assert torch.equal(prefill, trained)


def test_flash_train_refuses_what_the_kernels_cannot_take(dev):
    q, k, v, _ = _train_inputs(dev, 1, 4, 2, 64, 16, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_attention_train(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_train(q[..., :12].contiguous(),
                                 k[..., :12].contiguous(),
                                 v[..., :12].contiguous())
    with pytest.raises(ValueError, match="self-attention"):
        FA.flash_attention_train(q, k[:, :, :32], v[:, :, :32],
                                 causal=False)
