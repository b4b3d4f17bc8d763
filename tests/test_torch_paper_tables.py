"""The port's paper tables (``repro_torch.launch.paper_tables``) and
quickstart (``repro_torch.launch.quickstart``) against the reference's
``benchmarks/paper_tables.py`` and ``examples/quickstart.py``, on the CPU.

The untrained tables (2.1, 5.1, 6.1) give the reference's rows exactly,
timings aside.  The trained tables run at a tiny budget (2 steps) in both
packages: the same row names, the same LUT columns (exact: they are
functions of the configuration), accuracies in [0, 1] and AUCs in [0,
100]; the minimization proxy of Table 5.2 depends on the trained weights,
so it is held to the analytical bound instead.  A table that raises
becomes an ``ERROR`` row, which ``check_rows`` and the CLI refuse, as
they refuse an inexact column (Tables 2.1 and 6.1's ``exact=``, Table
7.3's ``sparse_luts``).  Table 7.4's training loop is held against the
reference's in ``tests/test_torch_table_7_4.py``.
"""

import importlib.util
import os
import re

import numpy as np
import pytest

from torch_port_util import ROOT, one_torch_thread  # noqa: F401

from repro_torch.launch import paper_tables as PPT


def _reference_tables():
    """``benchmarks/paper_tables.py``, loaded from its file (the benchmarks
    folder is not a package on the test path)."""
    spec = importlib.util.spec_from_file_location(
        "reference_paper_tables",
        os.path.join(ROOT, "benchmarks", "paper_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JPT = _reference_tables()

BUDGET = 2
LUT_KEYS = ("luts", "analytical", "sparse_luts", "entries", "n6luts",
            "expected")
FRACTION_KEYS = ("acc",)
PERCENT_KEYS = ("avg_auc", "apriori", "iterative")


@pytest.mark.parametrize("name", ["table_2_1", "table_5_1", "table_6_1"])
def test_untrained_tables_equal_reference(name):
    want = getattr(JPT, name)()
    got = getattr(PPT, name)(device="cpu")
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]
    assert all(us > 0 for _, us, _ in got)


def test_mnist_data_equal_reference():
    for g, w in zip(PPT._mnist_data(), JPT._mnist_data()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


TRAINED = ["table_5_2", "table_6_2", "table_6_3", "table_7_1",
           "fig_7_2_bitwidth", "table_7_2", "table_7_3", "table_7_4"]


@pytest.mark.parametrize("name", TRAINED)
def test_trained_table_rows_and_lut_columns(name):
    want = getattr(JPT, name)(budget=BUDGET)
    got = getattr(PPT, name)(budget=BUDGET, device="cpu")
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (n, _, gd), (_, _, wd) in zip(got, want):
        g, w = PPT._fields(gd), PPT._fields(wd)
        assert set(g) == set(w), n
        for k in g:
            if k in LUT_KEYS:
                assert g[k] == w[k], (n, k)
            elif k in FRACTION_KEYS:
                assert 0.0 <= float(g[k]) <= 1.0, (n, k)
            elif k in PERCENT_KEYS:
                assert 0.0 <= float(g[k]) <= 100.0, (n, k)
        if name == "table_5_2":
            assert 0 < int(g["minimized"]) <= int(g["analytical"])
            assert g["reduction"] == (
                f"{int(g['analytical']) / int(g['minimized']):.2f}x")


def test_all_tables_at_a_tiny_budget(monkeypatch):
    """Every table of ``all_tables`` runs on the CPU without an ``ERROR``
    row at 2 steps a training run."""
    monkeypatch.setitem(PPT.BUDGETS, True, (BUDGET, BUDGET, BUDGET))
    rows = PPT.all_tables(quick=True, device="cpu")
    PPT.check_rows(rows)
    assert [n.split("/")[0] for n, _, _ in rows] == (
        ["table2.1"] * 6 + ["table5.1"] * 3 + ["table5.2"] * 2
        + ["table6.1"] * 5 + ["table6.2"] * 5 + ["table6.3"] * 2
        + ["table7.1"] * 5 + ["fig7.2"] * 3 + ["table7.2"] * 3
        + ["table7.3"] * 3 + ["table7.4"] * 3)


def test_error_rows_are_refused(monkeypatch, tmp_path, capsys):
    """A table that raises gives one ``ERROR`` row and the others stay;
    ``check_rows`` refuses it, and the CLI exits non-zero after writing
    every row to its CSV.  (The trained tables are stubbed here: the test
    above runs them.)"""
    def stub(name):
        return lambda **kw: [(f"{name}/row", 1.0, f"budget={kw['budget']}")]

    def boom(**_):
        raise ValueError("table failed")

    for fn in ("table_5_2", "table_6_2", "table_6_3", "table_7_1",
               "fig_7_2_bitwidth", "table_7_2", "table_7_4"):
        monkeypatch.setattr(PPT, fn, stub(fn))
    monkeypatch.setattr(PPT, "table_7_3", lambda **kw: [
        (f"table7.3/skip{k}", 0.0, "acc=0.5 sparse_luts=130560")
        for k in range(3)])
    path = tmp_path / "tables.csv"
    PPT.main(["--quick", "--device", "cpu", "--csv", str(path)])
    out = capsys.readouterr().out
    assert out.startswith("name,us_per_call,derived")
    assert "table_7_4/row,1.0,budget=80" in out and "# table7.4:" in out
    assert "table_6_2/row,1.0,budget=120" in path.read_text()
    assert "table7.3/skip2,0.0,acc=0.5 sparse_luts=130560" in out

    monkeypatch.setattr(PPT, "table_7_3", boom)
    rows, walls = PPT.timed_tables(quick=False, device="cpu")
    assert ("table7.3/ERROR", 0.0, "ValueError('table failed')") in rows
    assert ("table_7_4/row", 1.0, "budget=200") in rows
    assert len(rows) == 6 + 3 + 5 + 1 * 7 + 1
    assert list(walls) == ["table2.1", "table5.1", "table5.2", "table6.1",
                           "table6.2", "table6.3", "table7.1", "fig7.2",
                           "table7.2", "table7.3", "table7.4"]
    with pytest.raises(RuntimeError, match="table7.3/ERROR"):
        PPT.check_rows(rows)
    with pytest.raises(SystemExit, match="table failed"):
        PPT.main(["--quick", "--device", "cpu", "--csv", str(path)])
    lines = path.read_text().splitlines()
    assert lines[0] == "name,us_per_call,derived" and len(lines) == 1 + 22
    assert any(line.startswith("table7.3/ERROR") for line in lines)


def _good_rows():
    rows = [(f"table2.1/fanin{f}", 1.0, f"n6luts={n} expected={n} "
             f"util=1.00% exact=True")
            for f, n in zip(range(6, 12), (1, 3, 5, 11, 21, 43))]
    rows += [(f"table6.1/model{m}", 1.0, "luts=[1, 2] expected=[1, 2] "
              "exact=True") for m in "ABCDE"]
    rows += [(f"table7.3/skip{k}", 0.0, "acc=0.5 sparse_luts=130560")
             for k in range(3)]
    return rows + [("table7.4/FP_DW", 0.0, "acc=0.1")]


def test_table_checks_pass_the_expected_rows():
    assert PPT.row_failures(_good_rows()) == []
    PPT.check_rows(_good_rows())


@pytest.mark.parametrize("edit,what", [
    (lambda r: r + [("table6.2/ERROR", 0.0, "RuntimeError('x')")],
     "table6.2/ERROR"),
    (lambda r: [(n, u, d.replace("exact=True", "exact=False"))
                if n == "table2.1/fanin9" else (n, u, d) for n, u, d in r],
     "table2.1"),
    (lambda r: [(n, u, d.replace("exact=True", "exact=False"))
                if n == "table6.1/modelD" else (n, u, d) for n, u, d in r],
     "table6.1"),
    (lambda r: [x for x in r if x[0] != "table6.1/modelE"], "table6.1"),
    (lambda r: [x for x in r if not x[0].startswith("table2.1/")],
     "table2.1"),
    (lambda r: [(n, u, d.replace("130560", "130561"))
                if n == "table7.3/skip2" else (n, u, d) for n, u, d in r],
     "table7.3"),
    (lambda r: [x for x in r if x[0] != "table7.3/skip1"], "table7.3"),
], ids=["error-row", "2.1-inexact", "6.1-inexact", "6.1-missing",
        "2.1-missing", "7.3-luts-change", "7.3-missing"])
def test_table_checks_refuse_a_wrong_value(edit, what):
    """``row_failures`` names the one wrong table; ``check_rows`` (the
    CLI's check, and through ``row_failures`` the smoke's) raises on it."""
    rows = edit(_good_rows())
    bad = PPT.row_failures(rows)
    assert len(bad) == 1 and bad[0].startswith(what)
    with pytest.raises(RuntimeError, match=re.escape(what)):
        PPT.check_rows(rows)


def test_cli_refuses_an_inexact_column(monkeypatch, tmp_path):
    """The CLI exits non-zero on a Table 2.1 row with ``exact=False``
    after writing every row, as the smoke refuses it."""
    def stub(name):
        return lambda **kw: [(f"{name}/row", 1.0, "x=1")]

    for fn in ("table_5_1", "table_5_2", "table_6_2", "table_6_3",
               "table_7_1", "fig_7_2_bitwidth", "table_7_2", "table_7_4"):
        monkeypatch.setattr(PPT, fn, stub(fn))
    monkeypatch.setattr(PPT, "table_7_3", lambda **kw: [
        r for r in _good_rows() if r[0].startswith("table7.3/")])
    real = PPT.table_2_1
    monkeypatch.setattr(PPT, "table_2_1", lambda **kw: [
        (n, u, d.replace("exact=True", "exact=False")
         if n.endswith("fanin8") else d) for n, u, d in real(**kw)])
    path = tmp_path / "tables.csv"
    with pytest.raises(SystemExit, match="table2.1: exact="):
        PPT.main(["--quick", "--device", "cpu", "--csv", str(path)])
    assert "fanin8" in path.read_text() and "exact=False" in path.read_text()


def test_quickstart_on_cpu(capsys):
    """The quickstart end to end at a cut step count: the reference
    example's lines, every check exact."""
    from repro_torch.launch import quickstart

    quickstart.main(["--device", "cpu", "--steps", "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("model C: per-layer LUTs [128, 64, 64, 1423]  "
                      "total 1679")
    assert re.fullmatch(r"test accuracy: \d\.\d{3}", out[1])
    assert out[2] == ("truth-table functional verification (fused "
                      "kernel): EXACT MATCH")
    assert re.fullmatch(r"compiled artifact: layout=mixed table slab \d+ B "
                        r"\(raw 8192 B\)", out[3])
    assert re.fullmatch(r"artifact round-trip \(\d+ B npz\): EXACT MATCH",
                        out[4])
    assert re.fullmatch(r"generated 132 Verilog modules \(\d+\.\d kB\)",
                        out[5])
    assert out[6] == "module LogicNetModule (input [31:0] M0, output " \
                     "[63:0] M3);"
    assert len(out) == 10
    res = quickstart.run(steps=2, device="cpu")
    capsys.readouterr()
    assert res["verify_exact"] and res["roundtrip_exact"]
    assert (res["layout"], res["modules"], res["raw_table_bytes"]) == (
        "mixed", 132, 8192)
    assert 0.0 <= res["accuracy"] <= 1.0 and res["verilog_bytes"] > 0
