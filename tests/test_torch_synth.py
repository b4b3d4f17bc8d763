"""The port's two-level synthesis (``repro_torch.synth``) against
``repro.synth``.

Both packages get the same seeded tables, reachability masks and
netlists; synthesis is integer code, so the tolerance is 0: equal cubes
in equal order for every output bit (``minimize_bit``), equal covers or
the same budget fallback (``minimize_table``: ``max_bits`` and
``max_cubes``), and equal covers and stats on every neuron of a compiled
netlist (``synthesize_netlist``).
"""

import doctest

import numpy as np
import pytest

from torch_port_util import assert_same_cover, one_torch_thread  # noqa: F401

from repro import compile as JC
from repro import synth as JS
from repro_torch import compile as PC
from repro_torch import synth as PS
from repro_torch.core import truth_table as PT
from repro_torch.synth import minimize as PM
from repro_torch.synth import sop as PSOP


def _sets(rng, n_in, p_on=0.4, p_dc=0.3):
    """A random disjoint (on-set, dc-set) pair over ``n_in`` input bits."""
    draw = rng.random(1 << n_in)
    on = set(np.flatnonzero(draw < p_on).tolist())
    dc = set(np.flatnonzero((draw >= p_on) & (draw < p_on + p_dc)).tolist())
    return on, dc


def test_defaults_and_exports_equal():
    assert (PS.DEFAULT_MAX_BITS, PS.DEFAULT_MAX_CUBES) == (
        JS.DEFAULT_MAX_BITS, JS.DEFAULT_MAX_CUBES)
    assert set(PS.__all__) == set(JS.__all__)


def test_cube_and_cover_ir_equal():
    bits = ((PS.Cube(0b101, 0b001), PS.Cube(0b010, 0b010)), (),
            (PS.Cube(0, 0),))
    jbits = tuple(tuple(JS.Cube(*c) for c in b) for b in bits)
    p, j = PS.SopCover(3, 3, bits), JS.SopCover(3, 3, jbits)
    assert_same_cover(j, p)
    words = np.arange(8)
    np.testing.assert_array_equal(p.evaluate(words), j.evaluate(words))
    assert [p.bit_support(b) for b in range(3)] == [
        j.bit_support(b) for b in range(3)]
    assert PS.Cube(0b101, 0b001).literals() == JS.Cube(0b101,
                                                       0b001).literals()
    assert p.evaluate_word(5) == j.evaluate_word(5)
    with pytest.raises(ValueError):
        PS.SopCover(3, 2, bits)
    with pytest.raises(ValueError):
        JS.SopCover(3, 2, jbits)


@pytest.mark.parametrize("seed", range(8))
def test_minimize_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n_in = 1 + seed % 7
    on, dc = _sets(rng, n_in)
    assert PS.minimize_bit(on, dc, n_in) == JS.minimize_bit(on, dc, n_in)
    # a full care set, and a function with no don't-cares
    assert PS.minimize_bit(on, set(), n_in) == JS.minimize_bit(on, set(),
                                                               n_in)


def test_minimize_bit_constants_and_cube_budget():
    everything = set(range(16))
    assert PS.minimize_bit(set(), {1, 2}, 4) == () == JS.minimize_bit(
        set(), {1, 2}, 4)
    assert (PS.minimize_bit({0, 1}, everything - {0, 1}, 4)
            == (PS.Cube(0, 0),)
            == JS.minimize_bit({0, 1}, everything - {0, 1}, 4))
    parity = {w for w in range(16) if bin(w).count("1") & 1}
    for cap in (4, 8, 64):
        assert PS.minimize_bit(parity, set(), 4, max_cubes=cap) == (
            JS.minimize_bit(parity, set(), 4, max_cubes=cap))
    assert PS.minimize_bit(parity, set(), 4, max_cubes=4) is None


@pytest.mark.parametrize("seed", range(10))
def test_minimize_table_equal(seed):
    rng = np.random.default_rng(100 + seed)
    n_in = 1 + seed % 6
    out_bits = 1 + seed % 3
    table = rng.integers(0, 1 << out_bits, 1 << n_in)
    reach = rng.random(1 << n_in) < 0.6
    reach[0] = True
    for mask in (reach, None):
        p = PS.minimize_table(table, n_in, out_bits, mask)
        j = JS.minimize_table(table, n_in, out_bits, mask)
        assert_same_cover(j, p)
        words = np.flatnonzero(np.ones(1 << n_in, bool) if mask is None
                               else mask)
        np.testing.assert_array_equal(p.evaluate(words), table[words])


def test_minimize_table_budget_fallbacks():
    table = np.array([bin(w).count("1") & 1 for w in range(16)])
    for kw in ({"max_bits": 3}, {"max_bits": 4}, {"max_cubes": 4},
               {"max_cubes": 8}):
        assert_same_cover(JS.minimize_table(table, 4, 1, **kw),
                    PS.minimize_table(table, 4, 1, **kw))
    assert PS.minimize_table(table, 4, 1, max_bits=3) is None
    assert PS.minimize_table(table, 4, 1, max_cubes=4) is None
    for pkg in (PS, JS):
        with pytest.raises(ValueError):
            pkg.minimize_table(np.array([0, 1, 0]), 2, 1)


def _compiled_netlists(seed):
    """The same level-3 netlist (reachability masks attached) from each
    package's compiler over a seeded sparse stack with small code pools."""
    rng = np.random.default_rng(seed)
    width, jt, pt = 4, [], []
    for li in range(3):
        n_out, fi, bw = int(rng.integers(3, 7)), min(3, width), 2
        idx = np.stack([np.sort(rng.choice(width, fi, replace=False))
                        for _ in range(n_out)]).astype(np.int32)
        pool = (rng.choice(4, size=int(rng.integers(2, 5)), replace=False)
                if li < 2 else np.arange(4))
        tab = rng.choice(pool, size=(n_out, 1 << (fi * bw))).astype(np.int32)
        jt.append(JC.pipeline.LayerTruthTable(tab, idx, bw, bw))
        pt.append(PT.LayerTruthTable(tab.copy(), idx.copy(), bw, bw))
        width = n_out
    return (JC.optimize(jt, 3, in_features=4).netlist,
            PC.optimize(pt, 3, in_features=4).netlist)


@pytest.mark.parametrize("kw", [{}, {"max_bits": 0}, {"max_bits": 4},
                                {"max_cubes": 4}],
                         ids=["default", "max_bits0", "max_bits4",
                              "max_cubes4"])
@pytest.mark.parametrize("seed", range(3))
def test_synthesize_netlist_equal(seed, kw):
    jn, pn = _compiled_netlists(seed)
    assert PS.synthesize_netlist(pn, **kw) == JS.synthesize_netlist(jn, **kw)
    for jl, pl in zip(jn.layers, pn.layers):
        for a, b in zip(jl, pl):
            assert_same_cover(a.sop, b.sop)
    if kw.get("max_bits") == 0:
        assert all(n.sop is None for lay in pn.layers for n in lay)


@pytest.mark.parametrize("module", [PM, PSOP], ids=["minimize", "sop"])
def test_port_docstring_examples(module):
    res = doctest.testmod(module, optionflags=doctest.ELLIPSIS)
    assert res.attempted and res.failed == 0
