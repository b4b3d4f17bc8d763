"""A cell, a traffic mix and a per-layer metric are added by adding files
and entries: a copy of ``portbench/`` and ``BENCHMARK.json`` with one more
of each lists and validates the new cell, no other file edited.  Also the
names, units and metric-to-cell rules of the repository's own
BENCHMARK.json."""

import json
import re
import shutil

import pytest

from portbench.harness import spec
from portbench.tests.smoke import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_files_only_extension(copy):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    before = {p.relative_to(copy): p.read_bytes()
              for p in copy.rglob("*") if p.is_file()}
    pb = copy / "portbench"
    cfg = json.loads((pb / "configs" / "qwen3-1.7b-lnffn.json").read_text())
    (pb / "configs" / "qwen3-1.7b-lnffn-copy.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "train.4x2048.json").read_text())
    (pb / "traffic" / "train.2x1024.json").write_text(
        json.dumps(dict(traffic, batch=2, seq_len=1024)))
    name = "qwen3-1.7b-lnffn-copy.train.2x1024"
    (pb / "limits" / f"{name}.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-3, "grad_gap": 0.1, "change_gap": 0.5}}))
    (pb / "metrics" / "steps_run.train.py").write_text(
        "def read(run):\n    return run.window.get('steps')\n")
    bench["configs"].append({
        "name": "qwen3-1.7b-lnffn-copy", "source": "https://example.org",
        "file": "portbench/configs/qwen3-1.7b-lnffn-copy.json",
        "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name,
                               "config": "qwen3-1.7b-lnffn-copy",
                               "traffic": "train.2x1024", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append(name)
    bench["per_layer"].append({
        "name": "steps_run.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "window",
        "moves": "train_tokens_per_s", "workloads": [name]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    cells = {c.name: c for c in spec.cells(copy)}
    assert name in cells and len(cells) == len(bench["workloads"])
    new = cells[name]
    assert new.traffic["seq_len"] == 1024 and new.kind == "train"
    assert [e["name"] for e in new.end_to_end] == ["train_tokens_per_s",
                                                   "setup_s"]
    assert [e["name"] for e in new.per_layer] == ["steps_run.train"]
    assert new.reader("steps_run.train")(
        type("R", (), {"window": {"steps": 7}})) == 7
    after = {p.relative_to(copy): p.read_bytes()
             for p in copy.rglob("*") if p.is_file()}
    edited = {p for p in before if before[p] != after[p]}
    assert edited == {copy.joinpath("BENCHMARK.json").relative_to(copy)}


def test_a_metric_whose_cell_lacks_its_end_to_end_metric_is_refused(copy):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == "step_mfu.train":
            m["workloads"].append("qwen3-1.7b-lnffn.prefill.mix")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match="does not report"):
        spec.cells(copy)


def test_benchmark_names_units_and_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(set(names)) == len(names)
        for e in bench[section]:
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
    for w in bench["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    cells = {c.name: c for c in spec.cells(ROOT)}
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in cells[w].end_to_end]
