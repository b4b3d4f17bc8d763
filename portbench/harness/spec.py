"""``BENCHMARK.json`` and the files it names, loaded and checked.

A cell is found by name: its configuration in ``portbench/configs/<config>
.json`` (the path ``BENCHMARK.json`` gives), its traffic in
``portbench/traffic/<traffic>.json``, the limits of its output check in
``portbench/limits/<workload>.json``, each per-layer metric's reader in
``portbench/metrics/<metric>.py``.  A cell, a mix or a metric is added by
adding files and entries; no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = "portbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
# the end-to-end metrics each kind of traffic produces
KIND_METRICS = {"train": ("train_tokens_per_s", "setup_s"),
                "prefill": ("prefill_tokens_per_s", "prefill_p95_ms",
                            "setup_s")}
# what each kind of traffic's file must give
KIND_KEYS = {"train": ("batch", "seq_len", "lr", "b1", "b2", "eps",
                       "weight_decay", "clip_norm", "check_steps",
                       "trace_steps"),
             "prefill": ("tokens_per_call", "lengths", "check_per_length",
                         "trace_calls")}
# the configuration file's keys that describe it and are not run
CONFIG_NOTES = ("published", "assumed", "departures")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names breaks the rules."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list         # the same for the per-layer metrics
    root: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's file."""
        return load_reader(self.root / BENCH_DIR / "metrics" / f"{metric}.py")


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise SpecError(f"{path}: {e}") from e


def run_keys(config: dict) -> dict:
    """The configuration as it is run: its file without the notes."""
    return {k: v for k, v in config.items() if k not in CONFIG_NOTES}


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def _check_names(bench: dict, problems: list) -> None:
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench.get(section, []):
            if not NAME.fullmatch(str(e.get("name", ""))):
                problems.append(f"{section}: bad name {e.get('name')!r}")
            if "unit" in e and not UNIT.fullmatch(str(e["unit"])):
                problems.append(f"{e['name']}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                problems.append(f"{e['name']}: better is {e['better']!r}")
    for w in bench.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME.fullmatch(str(w.get(key, ""))):
                problems.append(f"{w.get('name')}: bad {key} {w.get(key)!r}")
    for c in bench.get("configs", []):
        for key in c.get("reduced", []):
            if not NAME.fullmatch(key):
                problems.append(f"{c['name']}: bad reduced key {key!r}")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e.get("name") for e in bench.get(section, [])]
        if len(names) != len(set(names)):
            problems.append(f"{section}: a name appears twice")


def cell(root: Path, workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, its files
    read."""
    root = Path(root)
    bench = bench or _json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"{workload}: no config {w['config']!r}")
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = _json(root / BENCH_DIR / "limits" / f"{workload}.json")
    return Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=run_keys(config),
                traffic_name=w["traffic"], traffic=traffic,
                limits=limits["limits"],
                end_to_end=[e for e in bench["end_to_end"]
                            if _reports(e, workload)],
                per_layer=[e for e in bench["per_layer"]
                           if _reports(e, workload)],
                root=root)


def cells(root: Path) -> list[Cell]:
    """Every cell of ``root``'s BENCHMARK.json, checked: raises
    :class:`SpecError` listing every rule a file breaks."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    problems: list[str] = []
    _check_names(bench, problems)
    e2e = {e["name"] for e in bench.get("end_to_end", [])}
    out = []
    for w in bench.get("workloads", []):
        try:
            c = cell(root, w["name"], bench)
        except (SpecError, KeyError) as e:
            problems.append(f"{w.get('name')}: {e}")
            continue
        kind = c.traffic.get("kind")
        if kind not in KIND_METRICS:
            problems.append(f"{c.name}: traffic kind {kind!r}")
            continue
        missing = [k for k in KIND_KEYS[kind] if k not in c.traffic]
        if missing:
            problems.append(f"{c.name}: traffic lacks {missing}")
        reported = [e["name"] for e in c.end_to_end]
        for name in reported:
            if name not in KIND_METRICS[kind]:
                problems.append(f"{c.name}: {kind} traffic does not "
                                f"produce {name}")
        if "setup_s" not in reported or len(reported) < 2:
            problems.append(f"{c.name}: reports {reported}; needs setup_s "
                            f"and another end-to-end metric")
        if not c.per_layer:
            problems.append(f"{c.name}: reports no per-layer metric")
        for m in c.per_layer:
            if m.get("moves") not in e2e:
                problems.append(f"{m['name']}: moves {m.get('moves')!r}, "
                                f"no end-to-end metric")
            elif m["moves"] not in reported:
                problems.append(f"{m['name']}: {c.name} does not report "
                                f"{m['moves']}, which it moves")
            path = root / BENCH_DIR / "metrics" / f"{m['name']}.py"
            if not path.is_file():
                problems.append(f"{m['name']}: no reader {path}")
        out.append(c)
    for m in bench.get("per_layer", []):
        for name in m.get("workloads", []):
            if name not in {w["name"] for w in bench.get("workloads", [])}:
                problems.append(f"{m['name']}: lists unknown cell {name}")
    if problems:
        raise SpecError("; ".join(problems))
    return out
