"""The port's Verilog generation (``repro_torch.core.verilog``,
``logicnet.to_verilog``) against ``repro.core.verilog``.

Every case of ``tests/test_verilog.py`` is mirrored: the reference builds
and trains the toy network, its weights are carried to the port
(``from_reference``) once the two packages' truth tables are equal, and
both packages emit Verilog.  Text is integer code, so the tolerance is 0:
the port's files equal the reference's character for character (raw,
levels 2-4, ``sop=True``, with and without pipeline registers), and the
port's ``evaluate_verilog`` equals its own table forward on every word
tested (exhaustively on the toy nets).  Model A is compiled at levels 3
and 4 by both packages from the committed fixture's raw tables.
"""

import re

import jax
import numpy as np
import pytest
import torch

from torch_port_util import (load_ref, one_torch_thread,  # noqa: F401
                             ref_triples)

from repro import compile as JC
from repro.core import logicnet as JLN
from repro.core import netlist as JNL
from repro.core import verilog as JV
from repro_torch import compile as PC
from repro_torch.core import logicnet as PLN
from repro_torch.core import netlist as PNL
from repro_torch.core import verilog as PV
from repro_torch.core.table_infer import network_table_forward


def _toy_cfgs():
    kw = dict(in_features=5, n_classes=3, hidden=(4,), fan_in=3, bw=1,
              final_dense=False, fan_in_fc=2, bw_fc=1)
    return JLN.LogicNetCfg(**kw), PLN.LogicNetCfg(**kw)


def _multibit_cfgs():
    kw = dict(in_features=6, n_classes=4, hidden=(5,), fan_in=2, bw=2,
              final_dense=False, fan_in_fc=2, bw_fc=2)
    return JLN.LogicNetCfg(**kw), PLN.LogicNetCfg(**kw)


def _carry(jcfg, pcfg, model):
    """The reference's trained model carried to the port, after checking
    that both packages' truth tables are equal."""
    model = jax.tree.map(np.asarray, model)
    net = PLN.from_reference(pcfg, model, device="cpu")
    want = JLN.generate_tables(jcfg, model)
    got = PLN.generate_tables(net)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.table, w.table)
        np.testing.assert_array_equal(g.indices, w.indices)
        assert (g.bw_in, g.bw_out) == (w.bw_in, w.bw_out)
    return model, net, got


def _toy(seed=0):
    """``tests/test_verilog.py``'s toy net (5 -> 4 -> 3, 1-bit), in both
    packages: (reference cfg, reference model, port net, port tables)."""
    jcfg, pcfg = _toy_cfgs()
    key = jax.random.PRNGKey(seed)
    model = JLN.init(jcfg, key, mask_seed=seed)
    x = jax.random.normal(key, (32, 5))
    _, model = JLN.forward(jcfg, model, x, train=True)
    return (jcfg, *_carry(jcfg, pcfg, model))


def _multibit():
    jcfg, pcfg = _multibit_cfgs()
    key = jax.random.PRNGKey(7)
    model = JLN.init(jcfg, key, mask_seed=7)
    x = jax.random.uniform(key, (64, 6), minval=-1, maxval=3)
    _, model = JLN.forward(jcfg, model, x, train=True)
    return (jcfg, *_carry(jcfg, pcfg, model))


def _digits(word, bw, n):
    return [(word >> (bw * f)) & (2 ** bw - 1) for f in range(n)]


def _out_codes(word, bw_out, n_out):
    return [(word >> (bw_out * j)) & (2 ** bw_out - 1) for j in range(n_out)]


def _forward(tables, rows):
    return network_table_forward(
        tables, torch.as_tensor(np.asarray(rows, np.int32))).numpy()


def _n_layers(files):
    return 1 + max(int(m.group(1)) for m in
                   (re.match(r"LUTLayer(\d+)\.v$", f) for f in files) if m)


def test_listing_structure():
    """The emitted files mirror Listings 5.2-5.6, as the reference's."""
    jcfg, model, net, _ = _toy()
    files = PLN.to_verilog(net)
    assert files == JLN.to_verilog(jcfg, model)
    top = files["LogicNetModule.v"]
    assert top.startswith("module LogicNetModule (input [4:0] M0")
    assert "LUTLayer0" in top
    wires = re.findall(r"wire \[2:0\] inpWire0_\d+ = \{M0\[\d+\], "
                       r"M0\[\d+\], M0\[\d+\]\};", files["LUTLayer0.v"])
    assert len(wires) == 4
    lut = files["LUT_L0_N0.v"]
    assert "case (M0)" in lut and lut.count(": M1 =") == 2 ** 3 + 1
    assert lut.count("default: M1 =") == 1
    assert "endmodule" in lut


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("level,sop", [(None, False), (2, False), (3, False),
                                       (4, False), (4, True)],
                         ids=["raw", "L2", "L3", "L4", "L4-sop"])
@pytest.mark.parametrize("net_of", [_toy, _multibit],
                         ids=["toy", "multibit"])
def test_text_identical(net_of, level, sop, pipeline):
    jcfg, model, net, _ = net_of()
    want = JLN.to_verilog(jcfg, model, pipeline=pipeline,
                          optimize_level=level, sop=sop)
    got = PLN.to_verilog(net, pipeline=pipeline, optimize_level=level,
                         sop=sop)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    if sop:
        assert any("assign M1[" in t for t in got.values())


def test_verilog_semantics_match_tables_exhaustive():
    """Every input word through the port's RTL interpreter equals the
    port's table forward."""
    _, _, net, tables = _toy(seed=4)
    files = PLN.to_verilog(net)
    bw, n_feat = net.cfg.bw, net.cfg.in_features
    words = range(2 ** (bw * n_feat))
    want = _forward(tables, [_digits(w, bw, n_feat) for w in words])
    for word in words:
        out = PV.evaluate_verilog(files, word, n_layers=len(tables))
        assert _out_codes(out, tables[-1].bw_out,
                          tables[-1].out_features) == list(want[word]), word


def test_multibit_verilog_roundtrip():
    _, _, net, tables = _multibit()
    cfg = net.cfg
    files = PLN.to_verilog(net)
    rng = np.random.default_rng(0)
    words = [int(rng.integers(0, 2 ** (cfg.bw * cfg.in_features)))
             for _ in range(64)]
    want = _forward(tables, [_digits(w, cfg.bw, cfg.in_features)
                             for w in words])
    for word, row in zip(words, want):
        out = PV.evaluate_verilog(files, word, n_layers=len(tables))
        assert _out_codes(out, tables[-1].bw_out,
                          tables[-1].out_features) == list(row)


def test_default_arm_matches_interpreter_semantics():
    """Unreachable entries fold into the ``default:`` arm (the most common
    reachable value), and ``_parse_tables`` gives every omitted entry the
    default: the case-statement semantics synthesis implements."""
    table = np.array([5, 2, 2, 2, 7, 2, 2, 1], dtype=np.int64)
    reachable = np.array([1, 1, 0, 1, 1, 0, 1, 0], dtype=bool)
    text = PV.neuron_module("LUT_L0_N0", 3, 3, table, reachable)
    assert text == JV.neuron_module("LUT_L0_N0", 3, 3, table, reachable)
    assert "default: M1 = 3'd2;" in text
    assert text.count(": M1 =") == 3
    parsed = PV._parse_tables({"LUT_L0_N0.v": text})["LUT_L0_N0"]
    assert parsed.shape == (8,)
    assert [parsed[i] for i in np.flatnonzero(reachable)] == [5, 2, 2, 7, 2]
    assert [parsed[i] for i in np.flatnonzero(~reachable)] == [2, 2, 2]
    # a module without a default arm reads its omitted entries as 0
    bare = "\n".join(line for line in text.splitlines()
                     if "default:" not in line)
    parsed = PV._parse_tables({"LUT_L0_N0.v": bare})["LUT_L0_N0"]
    np.testing.assert_array_equal(
        parsed, JV._parse_tables({"LUT_L0_N0.v": bare})["LUT_L0_N0"])
    assert [parsed[i] for i in np.flatnonzero(~reachable)] == [0, 0, 0]


def test_full_case_still_emits_default():
    text = PV.neuron_module("LUT_L0_N1", 2, 2, np.array([0, 1, 2, 3]))
    assert text == JV.neuron_module("LUT_L0_N1", 2, 2,
                                    np.array([0, 1, 2, 3]))
    assert text.count(": M1 =") == 4 + 1
    assert "default: M1 = 2'd0;" in text


def test_optimized_verilog_matches_raw_tables():
    """to_verilog(optimize_level=2): fewer modules, same function."""
    _, _, net, tables = _toy(seed=4)
    raw = PLN.to_verilog(net)
    opt = PLN.to_verilog(net, optimize_level=2)
    assert (sum(1 for f in opt if f.startswith("LUT_L"))
            <= sum(1 for f in raw if f.startswith("LUT_L")))
    cfg = net.cfg
    words = range(2 ** (cfg.bw * cfg.in_features))
    want = _forward(tables, [_digits(w, cfg.bw, cfg.in_features)
                             for w in words])
    n_layers = _n_layers(opt)
    for word in words:
        out = PV.evaluate_verilog(opt, word, n_layers=n_layers)
        assert _out_codes(out, tables[-1].bw_out,
                          tables[-1].out_features) == list(want[word]), word


def test_pipeline_variant_has_registers():
    _, _, net, _ = _toy()
    top = PLN.to_verilog(net, pipeline=True)["LogicNetModule.v"]
    assert "input clk" in top
    assert "always @ (posedge clk)" in top
    assert "M0_r <= M0;" in top


def test_netlist_counts():
    jcfg, model, net, tables = _toy()
    nl = PNL.build_netlist(tables, net.cfg.in_features)
    assert nl.n_hbbs == 4 + 3
    assert nl.in_bits == net.cfg.in_features * net.cfg.bw
    assert nl.out_bits == 3 * 1
    jnl = JNL.build_netlist(JLN.generate_tables(jcfg, model),
                            jcfg.in_features)
    assert (nl.n_hbbs, nl.in_bits, nl.out_bits) == (jnl.n_hbbs, jnl.in_bits,
                                                     jnl.out_bits)


def test_sop_verilog_matches_case_form_exhaustive():
    """Level 4: SOP and case-statement RTL agree on every input word."""
    _, _, net, tables = _toy(seed=4)
    case_files = PLN.to_verilog(net, optimize_level=4)
    sop_files = PLN.to_verilog(net, optimize_level=4, sop=True)
    assert any("assign M1[" in t for t in sop_files.values())
    n_layers = len(tables)
    for word in range(2 ** (net.cfg.bw * net.cfg.in_features)):
        assert (PV.evaluate_verilog(sop_files, word, n_layers=n_layers)
                == PV.evaluate_verilog(case_files, word,
                                       n_layers=n_layers)), word


def test_sop_flag_without_covers_is_case_form():
    """``generate_verilog(sop=True)`` on a netlist nobody synthesized keeps
    every module in case form, as the reference does."""
    jcfg, model, net, tables = _toy(seed=4)
    nl = PNL.build_netlist(tables, net.cfg.in_features)
    files = PV.generate_verilog(nl, sop=True)
    assert not any("assign M1[" in t for t in files.values())
    assert any("case (M0)" in t for t in files.values())
    assert files == PV.generate_verilog(nl)
    assert files == JV.generate_verilog(
        JNL.build_netlist(JLN.generate_tables(jcfg, model),
                          jcfg.in_features), sop=True)


# ---------------------------------------------------------------------------
# model A (fpga4hep, 16 -> 64 x 3 at fan-in 3, 3-bit) from the fixture's raw
# tables, compiled by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_a():
    triples = ref_triples(load_ref())
    return {"triples": triples,
            "ref": {lv: JC.optimize(JC.tables_from_triples(triples), lv,
                                    in_features=16) for lv in (3, 4)},
            "port": {lv: PC.optimize(PC.tables_from_triples(triples), lv,
                                     in_features=16) for lv in (3, 4)}}


def _model_a_words(n=24):
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 8, (n, 16), dtype=np.int64)
    return rows, [int(sum(int(c) << (3 * f) for f, c in enumerate(r)))
                  for r in rows]


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("level,sop", [(3, False), (4, False), (4, True)],
                         ids=["L3", "L4", "L4-sop"])
def test_model_a_text_identical(model_a, level, sop, pipeline):
    want = JV.generate_verilog(model_a["ref"][level].netlist, pipeline,
                               sop=sop)
    got = PV.generate_verilog(model_a["port"][level].netlist, pipeline,
                              sop=sop)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def test_model_a_level3_rtl_equals_table_forward(model_a):
    """Model A at level 3: 24 words through the RTL equal the raw tables'
    forward and the compiled tables' forward."""
    res = model_a["port"][3]
    files = PV.generate_verilog(res.netlist)
    rows, words = _model_a_words()
    raw = _forward(PC.tables_from_triples(model_a["triples"]), rows)
    np.testing.assert_array_equal(_forward(res.tables, rows), raw)
    n_layers, last = len(res.tables), res.tables[-1]
    for word, want in zip(words, raw):
        out = PV.evaluate_verilog(files, word, n_layers=n_layers)
        assert _out_codes(out, last.bw_out, last.out_features) == list(want)


def test_model_a_sop_rtl_equals_case_form(model_a):
    """Model A at level 4 (every neuron covered): SOP RTL equals case-form
    RTL and the table forward on 24 words."""
    res = model_a["port"][4]
    assert all(n.sop is not None for layer in res.netlist.layers
               for n in layer)
    sop = PV.generate_verilog(res.netlist, sop=True)
    case = PV.generate_verilog(res.netlist)
    rows, words = _model_a_words()
    want = _forward(res.tables, rows)
    n_layers, last = len(res.tables), res.tables[-1]
    for word, row in zip(words, want):
        o_sop = PV.evaluate_verilog(sop, word, n_layers=n_layers)
        assert o_sop == PV.evaluate_verilog(case, word, n_layers=n_layers)
        assert _out_codes(o_sop, last.bw_out, last.out_features) == list(row)
