"""The port's legacy flag API (``repro_torch.kernels.ops``) and the engine's
identity-keyed memo, against the reference's (``repro.kernels.ops``,
``repro.engine.cached_compile``).

* the memo contracts of ``tests/test_engine.py`` (repeated legacy calls
  compile once, FIFO eviction at ``_CACHE_MAX``, ``cache_clear`` after an
  in-place edit) and of ``tests/test_obs.py`` (the memo's hit and miss
  counters), run on the port;
* ``ops.lut_network`` and ``ops.lut_lookup`` bit-exact (tolerance 0:
  integer codes) with the reference's, which run their Pallas kernels in
  interpret mode, on model A's fixture tables at ``fused`` True / False and
  ``optimize_level`` None / 3;
* ``ops.masked_matmul`` and ``ops.flash_attention`` against the
  reference's within the port tests' tolerances (masked matmul float32
  atol 1e-5 / rtol 1e-3, flash attention float32 atol 2e-5 / rtol 1e-4:
  the same float32 arithmetic summed in another order);
* ``enumerate_variants(include_per_layer=False)`` equal to the
  reference's;
* a second ``network_table_forward(fused=True, optimize_level=3)`` with the
  same tables adds no compiler run, and ``sparse_head_forward(fused=True)``
  builds its artifact once.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (codes, load_ref, one_torch_thread,  # noqa: F401
                             random_stack, ref_triples, t)

from repro.kernels import ops as jops
from repro.kernels import plan as jplan
from repro_torch import engine, obs
from repro_torch.compile import optimize, tables_from_triples
from repro_torch.core.table_infer import network_table_forward
from repro_torch.core.truth_table import LayerTruthTable
from repro_torch.engine import engine as engmod
from repro_torch.kernels import ops
from repro_torch.kernels.plan import FUSED_SMEM_BUDGET_BYTES, \
    enumerate_variants

STACK = ((12, 20, 16, 8), (3, 3, 3), (2, 2, 2))


@pytest.fixture(autouse=True, scope="module")
def memos_as_found():
    """This file leaves both legacy memos (the port's and the
    reference's, which its comparisons fill) as it found them: they are
    module state, and a later file of the same test process reads them
    (``tests/test_engine.py::test_legacy_flag_api_memoizes`` counts the
    reference's)."""
    from repro.engine import engine as jengmod
    saved = [(mod._cache, dict(mod._cache)) for mod in (engmod, jengmod)]
    yield
    for cache, entries in saved:
        cache.clear()
        cache.update(entries)


def _tables(layers):
    return [LayerTruthTable(tab, idx, bw, bw) for idx, tab, bw in layers]


def _plain_chain(layers, x):
    return network_table_forward(_tables(layers), t(x)).numpy()


def _total(name):
    m = obs.registry().get(name)
    if m is None:
        return 0.0
    if isinstance(m, obs.Family):
        return sum(c.value for _, c in m._series())
    return m.value


# ---------------------------------------------------------------------------
# the memo (tests/test_engine.py's contracts on the port)
# ---------------------------------------------------------------------------

def test_legacy_flag_api_memoizes():
    """Repeated ``ops.lut_network(..., optimize_level=3)`` calls with the
    same layers reuse one artifact: no compiler run, no memo growth."""
    engine.cache_clear()
    layers = random_stack(*STACK, seed=29)
    x = codes(12, 21, hi=4, seed=8)
    want = _plain_chain(layers, x)

    got = ops.lut_network(t(x), layers, optimize_level=3).numpy()
    np.testing.assert_array_equal(got, want)
    size0 = engine.cache_size()
    runs0 = engine.compile_runs()
    for _ in range(4):
        got = ops.lut_network(t(x), layers, optimize_level=3).numpy()
    np.testing.assert_array_equal(got, want)
    assert engine.cache_size() == size0, "legacy calls grew the memo"
    assert engine.compile_runs() == runs0, "legacy calls re-ran the compiler"
    # distinct flag combinations are distinct artifacts ...
    ops.lut_network(t(x), layers, optimize_level=2)
    assert engine.cache_size() == size0 + 1
    # ... and cache_clear forces a fresh compile
    engine.cache_clear()
    assert engine.cache_size() == 0
    got = ops.lut_network(t(x), layers, optimize_level=3).numpy()
    np.testing.assert_array_equal(got, want)
    assert engine.compile_runs() == runs0 + 2


def test_cache_bounded_fifo_eviction_order(monkeypatch):
    """FIFO-bounded: filling past ``_CACHE_MAX`` evicts the oldest
    insertion, not the least recently used (a hit does not refresh it)."""
    engine.cache_clear()
    monkeypatch.setattr(engmod, "_CACHE_MAX", 3)
    stacks = [random_stack((8, 6, 4), (2, 2), (2, 2), seed=100 + i)
              for i in range(4)]

    def compiled(stack):
        return engine.cached_compile(
            stack, optimize_level=None, in_features=8, fused=True,
            use_pallas=True, block_b=8, budget_bytes=8 * 2 ** 20,
            device="cpu")

    a, b, c = (compiled(s) for s in stacks[:3])
    assert engine.cache_size() == 3
    assert compiled(stacks[0]) is a, "expected a memo hit"
    d = compiled(stacks[3])
    assert engine.cache_size() == 3
    assert compiled(stacks[1]) is b and compiled(stacks[2]) is c
    a2 = compiled(stacks[0])
    assert a2 is not a, "evicted entry must recompile"
    assert engine.cache_size() == 3
    assert compiled(stacks[2]) is c and compiled(stacks[3]) is d
    engine.cache_clear()
    assert engine.cache_size() == 0


def test_cache_clear_after_in_place_edit():
    """An in-place table edit is served stale until ``cache_clear``."""
    engine.cache_clear()
    layers = random_stack((8, 6, 4), (2, 2), (2, 2), seed=77)
    x = codes(8, 9, hi=4, seed=9)
    stale = ops.lut_network(t(x), layers).numpy()
    np.testing.assert_array_equal(stale, _plain_chain(layers, x))

    idx0, tab0, bw0 = layers[0]
    tab0 += 1
    tab0 %= 2 ** bw0                     # in-place edit, same array id
    np.testing.assert_array_equal(ops.lut_network(t(x), layers).numpy(),
                                  stale)

    engine.cache_clear()
    fresh = ops.lut_network(t(x), layers).numpy()
    np.testing.assert_array_equal(fresh, _plain_chain(layers, x))
    assert not np.array_equal(fresh, stale)


def test_memo_key_holds_flags_budget_and_device():
    """Each flag, the budget and the device are part of the key; an
    artifact keeps the device it was built for."""
    engine.cache_clear()
    layers = random_stack((8, 6, 4), (2, 2), (2, 2), seed=5)
    base = dict(optimize_level=None, in_features=8, fused=True,
                use_pallas=True, block_b=8,
                budget_bytes=FUSED_SMEM_BUDGET_BYTES, device="cpu")
    first = engine.cached_compile(layers, **base)
    assert first.device.type == "cpu" and first.layout == "uniform"
    for change in (dict(fused=False), dict(use_pallas=False),
                   dict(block_b=16), dict(budget_bytes=64),
                   dict(optimize_level=1), dict(in_features=9)):
        assert engine.cached_compile(layers, **{**base, **change}) is not \
            first
    assert engine.cache_size() == 7
    assert engine.cached_compile(layers, **base) is first
    assert engine.cached_compile(layers, **{**base, "budget_bytes": 64}
                                 ).layout == "per_layer"
    assert engine.cached_compile(layers, **{**base, "use_pallas": False}
                                 ).layout == "reference"
    engine.cache_clear()


def test_engine_counters_record_compiles_and_memo():
    """``tests/test_obs.py``'s contract on the port's registry: one build
    counts a compiler run, a build and a slab-build observation; two
    identical ``cached_compile`` calls one miss and one hit."""
    reg = obs.registry()
    runs0 = _total("engine_compiler_runs_total")
    builds0 = _total("engine_builds_total")
    slab0 = reg.get("engine_slab_build_seconds").count
    rng = np.random.default_rng(7)
    layers = []
    for a, b in zip((10, 16), (16, 6)):
        idx = np.stack([np.sort(rng.choice(a, 2, replace=False))
                        for _ in range(b)]).astype(np.int32)
        layers.append((idx, rng.integers(0, 4, (b, 16), dtype=np.int32), 2))
    engine.compile_network(layers, optimize_level=2, in_features=10,
                           block_b=4, device="cpu")
    assert _total("engine_compiler_runs_total") == runs0 + 1
    assert _total("engine_builds_total") == builds0 + 1
    assert reg.get("engine_slab_build_seconds").count == slab0 + 1

    hits0 = _total("engine_memo_hits_total")
    misses0 = _total("engine_memo_misses_total")
    rng = np.random.default_rng(3)
    idx = np.stack([np.sort(rng.choice(6, 2, replace=False))
                    for _ in range(4)]).astype(np.int32)
    tab = rng.integers(0, 4, (4, 2 ** 4), dtype=np.int32)
    engine.cache_clear()
    kwargs = dict(optimize_level=1, in_features=6, fused=True,
                  use_pallas=True, block_b=8,
                  budget_bytes=ops.FUSED_SMEM_BUDGET_BYTES, device="cpu")
    engine.cached_compile([(idx, tab, 2)], **kwargs)
    engine.cached_compile([(idx, tab, 2)], **kwargs)
    assert _total("engine_memo_misses_total") == misses0 + 1
    assert _total("engine_memo_hits_total") == hits0 + 1
    snap = reg.snapshot()
    assert "engine_memo_hits_total" in snap
    assert "engine_memo_misses_total" in snap


# ---------------------------------------------------------------------------
# the legacy functions against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_a():
    ref = load_ref()
    return ref_triples(ref), ref["codes"][:48]


@pytest.mark.parametrize("optimize_level", [None, 3])
@pytest.mark.parametrize("fused", [True, False])
def test_lut_network_matches_reference(model_a, fused, optimize_level):
    triples, x = model_a
    want = np.asarray(jops.lut_network(x, triples, fused=fused,
                                       optimize_level=optimize_level))
    got = ops.lut_network(t(x), triples, fused=fused,
                          optimize_level=optimize_level)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # and the plain chain, through the same memo
    plain = ops.lut_network(t(x), triples, fused=fused, use_pallas=False,
                            optimize_level=optimize_level)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_lut_network_picks_the_reference_layouts(model_a):
    triples, x = model_a
    for kw, layout in ((dict(), "uniform"), (dict(optimize_level=3), "mixed"),
                       (dict(fused=False), "per_layer"),
                       (dict(use_pallas=False), "reference"),
                       (dict(budget_bytes=64), "per_layer")):
        ops.lut_network(t(x), triples, **kw)
        net = engine.cached_compile(
            triples, **{**dict(optimize_level=None, in_features=16,
                               fused=True, use_pallas=True,
                               block_b=ops.DEFAULT_BLOCK_B,
                               budget_bytes=FUSED_SMEM_BUDGET_BYTES,
                               device="cpu"), **kw})
        assert net.layout == layout, kw


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_lut_lookup_matches_reference(model_a, layer, use_pallas):
    triples, x = model_a
    for i in range(layer):
        x = np.asarray(jops.lut_lookup(x, *triples[i]))
    idx, tab, bw = triples[layer]
    want = np.asarray(jops.lut_lookup(x, idx, tab, bw,
                                      use_pallas=use_pallas))
    got = ops.lut_lookup(t(x), idx, tab, bw, use_pallas=use_pallas)
    np.testing.assert_array_equal(got.numpy(), want)
    # tensors for indices and tables, as well as arrays
    np.testing.assert_array_equal(
        ops.lut_lookup(t(x), t(idx), t(tab), bw).numpy(), want)


def test_lut_network_docstring_example():
    namespace: dict = {}
    example = ops.lut_network.__doc__.split("Example::")[1]
    exec(compile("\n".join(line[8:] for line in example.splitlines()),
                 "example", "exec"), namespace)
    assert tuple(namespace["out"].shape) == (3, 4)


def test_non_tensor_inputs_default_to_cuda():
    layers = random_stack((8, 6), (2,), (2,))
    x = codes(8, 4, hi=4)
    if torch.cuda.is_available():
        assert ops.lut_network(x, layers).device.type == "cuda"
        return
    for call in (lambda: ops.lut_network(x, layers),
                 lambda: ops.lut_lookup(x, *layers[0])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert ops.lut_network(x, layers, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (33, 70, 19)])
def test_masked_matmul_matches_reference(m, k, n, use_pallas):
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = (rng.random((k, n)) < 0.3).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jops.masked_matmul(x, w, mask, b,
                                         use_pallas=use_pallas))
    got = ops.masked_matmul(t(x), t(w), t(mask), t(b),
                            use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(
        ops.masked_matmul(t(x), t(w), t(mask)).numpy(),
        np.asarray(jops.masked_matmul(x, w, mask)), atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
def test_flash_attention_matches_reference(causal, window, use_pallas):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16)))
    want = np.asarray(jops.flash_attention(q, k, v, causal=causal,
                                           window=window,
                                           use_pallas=use_pallas))
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal,
                              window=window, use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# enumerate_variants(include_per_layer=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("include_per_layer", [True, False])
@pytest.mark.parametrize("budget", [FUSED_SMEM_BUDGET_BYTES, 64, 50_000])
@pytest.mark.parametrize("case", ["stack", "A", "A_l3"])
def test_enumerate_variants_per_layer_flag_equal_reference(
        model_a, case, budget, include_per_layer):
    from repro import compile as jcompile

    triples = (random_stack(*STACK, seed=13) if case == "stack"
               else model_a[0])
    mixed = jmixed = None
    if case == "A_l3":
        res = optimize(tables_from_triples(triples), 3, in_features=16)
        jres = jcompile.optimize(jcompile.tables_from_triples(triples), 3,
                                 in_features=16)
        triples = [(tt.indices, tt.table, tt.bw_in) for tt in res.tables]
        mixed, jmixed = res.mixed_tables, jres.mixed_tables
    sweep = (16, 128)
    ours = enumerate_variants(triples, mixed, block_bs=sweep,
                              budget_bytes=budget,
                              include_per_layer=include_per_layer)
    theirs = jplan.enumerate_variants(triples, jmixed, block_bs=sweep,
                                      vmem_budget_bytes=budget,
                                      include_per_layer=include_per_layer)
    assert [v.key for v in ours] == [v.key for v in theirs]
    assert include_per_layer == any(v.layout == "per_layer" for v in ours)


# ---------------------------------------------------------------------------
# the compile-once repair: fused table forwards go through the memo
# ---------------------------------------------------------------------------

def test_network_table_forward_fused_compiles_once(model_a):
    triples, x = model_a
    tables = _tables(triples)
    first = network_table_forward(tables, t(x), fused=True,
                                  optimize_level=3)
    runs0, size0 = engine.compile_runs(), engine.cache_size()
    again = network_table_forward(tables, t(x), fused=True,
                                  optimize_level=3)
    assert engine.compile_runs() == runs0, "a second call re-ran the compiler"
    assert engine.cache_size() == size0
    np.testing.assert_array_equal(again.numpy(), first.numpy())
    np.testing.assert_array_equal(
        first.numpy(), network_table_forward(tables, t(x)).numpy())


def test_sparse_head_forward_fused_compiles_once():
    from repro_torch.configs import fpga4hep
    from repro_torch.core import logicnet as LN

    cfg = fpga4hep.model_a()
    net = LN.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = np.random.default_rng(0).standard_normal((64, 16)).astype(
        np.float32)
    LN.forward(net, x, train=True)
    tables = LN.generate_tables(net)
    want = LN.sparse_head_forward(net, tables, x)
    builds0 = _total("engine_builds_total")
    for _ in range(5):
        got = LN.sparse_head_forward(net, tables, x, fused=True)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    # one artifact built (slabs built and uploaded once), then memo hits
    assert _total("engine_builds_total") == builds0 + 1
