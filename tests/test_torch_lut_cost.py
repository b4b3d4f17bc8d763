"""The port's netlist and SOP LUT costs (``netlist_lut_cost``,
``sop_lut_estimate``, ``netlist_sop_cost``) against ``repro.core.lut_cost``.

Both packages compile the same seeded stacks, and model A from the
committed fixture's raw tables, and each prices its own netlist: raw
(``build_netlist``), level 3, and level 4 (every neuron's SOP cover
attached).  The costs are integer counts, so the tolerance is 0.
"""

import numpy as np
import pytest

from torch_port_util import (load_ref, one_torch_thread,  # noqa: F401
                             random_stack, ref_triples)

from repro import compile as JC
from repro.core import lut_cost as JLC
from repro.core import netlist as JNL
from repro_torch import compile as PC
from repro_torch.core import lut_cost as PLC
from repro_torch.core import netlist as PNL

KS = range(2, 9)


def _netlists(triples, in_features, level):
    """(reference netlist, port netlist) of ``triples`` at ``level`` (None:
    the raw netlist)."""
    jt, pt = JC.tables_from_triples(triples), PC.tables_from_triples(triples)
    if level is None:
        return (JNL.build_netlist(jt, in_features),
                PNL.build_netlist(pt, in_features))
    return (JC.optimize(jt, level, in_features=in_features).netlist,
            PC.optimize(pt, level, in_features=in_features).netlist)


STACKS = {
    "small": ((6, 8, 5), (2, 3), (2, 2), 21),
    "narrow": ((8, 12, 10, 6), (3, 3, 2), (1, 2, 2), 4),
    "wide": ((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), 13),
}


@pytest.fixture(scope="module")
def model_a():
    triples = ref_triples(load_ref())
    return {lv: _netlists(triples, 16, lv) for lv in (None, 3, 4)}


def _assert_costs_equal(jn, pn):
    assert PLC.netlist_lut_cost(pn) == JLC.netlist_lut_cost(jn)
    for k in KS:
        assert PLC.netlist_sop_cost(pn, k) == JLC.netlist_sop_cost(jn, k)
    for jl, pl in zip(jn.layers, pn.layers):
        for a, b in zip(jl, pl):
            assert (a.sop is None) == (b.sop is None)
            if b.sop is not None:
                assert ([PLC.sop_lut_estimate(b.sop, k) for k in KS]
                        == [JLC.sop_lut_estimate(a.sop, k) for k in KS])


@pytest.mark.parametrize("level", [None, 3, 4], ids=["raw", "L3", "L4"])
@pytest.mark.parametrize("stack", list(STACKS))
def test_costs_equal_reference(stack, level):
    widths, fan_ins, bws, seed = STACKS[stack]
    triples = random_stack(widths, fan_ins, bws, seed=seed)
    # small code pools upstream give the compiler don't-cares to use
    for i in range(len(triples) - 1):
        idx, tab, bw = triples[i]
        triples[i] = (idx, tab % (2 ** bws[i + 1]) // 2 * 2, bw)
    jn, pn = _netlists(triples, widths[0], level)
    _assert_costs_equal(jn, pn)
    covered = PLC.netlist_sop_cost(pn)["covered_neurons"]
    assert covered == (pn.n_hbbs if level == 4 else 0)


@pytest.mark.parametrize("level", [None, 3, 4], ids=["raw", "L3", "L4"])
def test_model_a_costs_equal_reference(model_a, level):
    jn, pn = model_a[level]
    _assert_costs_equal(jn, pn)


def test_model_a_sop_below_the_bound(model_a):
    """Model A at level 4: every neuron covered, and the measured estimate
    below the worst-case bound of the same netlist."""
    _, pn = model_a[4]
    cost = PLC.netlist_sop_cost(pn)
    assert cost["fallback_neurons"] == 0
    assert cost["covered_neurons"] == pn.n_hbbs
    assert cost["est_kluts"] < PLC.netlist_lut_cost(pn)
    # level 3 shrinks the raw netlist's bound
    assert PLC.netlist_lut_cost(model_a[3][1]) < PLC.netlist_lut_cost(
        model_a[None][1])


def test_unsynthesized_netlist_prices_at_the_bound(model_a):
    _, pn = model_a[3]
    cost = PLC.netlist_sop_cost(pn)
    assert cost["est_kluts"] == PLC.netlist_lut_cost(pn)
    assert (cost["covered_neurons"], cost["literals"], cost["terms"]) == (
        0, 0, 0)
    assert cost["fallback_neurons"] == pn.n_hbbs


@pytest.mark.parametrize("k", [1, 0, -3])
def test_sop_lut_estimate_refuses_k_below_2(model_a, k):
    jn, pn = model_a[4]
    for fn, c in ((PLC.sop_lut_estimate, pn.layers[0][0].sop),
                  (JLC.sop_lut_estimate, jn.layers[0][0].sop)):
        with pytest.raises(ValueError, match="k >= 2"):
            fn(c, k)
    with pytest.raises(ValueError, match="k >= 2"):
        PLC.netlist_sop_cost(pn, k)


def test_port_drops_the_tpu_vmem_figure():
    """``table_vmem_bytes`` is a TPU VMEM figure; the port's counterpart is
    the fused kernels' shared-memory budget."""
    from repro_torch.kernels import plan

    assert hasattr(JLC, "table_vmem_bytes")
    assert not hasattr(PLC, "table_vmem_bytes")
    assert plan.FUSED_SMEM_BUDGET_BYTES == 183_296
    assert np.all([PLC.code_width(b) == JLC.code_width(b)
                   for b in range(1, 33)])
