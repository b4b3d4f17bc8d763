"""One run of one cell: the kind's driver, then the result line.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, each read by its own file's
``read(run)`` from a :class:`Run` (a reader that finds nothing returns
None and the metric is left out).
"""

from __future__ import annotations

import dataclasses
import importlib

from portbench.harness import counts


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""
    cell: object           # spec.Cell: config, traffic, kind
    window: dict           # seconds, steps or calls
    trace: object          # trace.Trace or None
    peak_bytes: int
    counts = counts


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """The result line (a dict) of one run of ``cell``."""
    driver = importlib.import_module(f"portbench.harness.{cell.kind}")
    out = driver.run(cell, seed, seconds, trace, device, t_start)
    units = {e["name"]: e["unit"] for e in cell.end_to_end}
    metrics = {name: {"value": out["metrics"][name], "unit": unit}
               for name, unit in units.items()}
    tr = out["trace"]
    if trace:
        ctx = Run(cell=cell, window=out["window"], trace=tr,
                  peak_bytes=out["peak_bytes"])
        metrics = {}
        for e in cell.per_layer:
            value = cell.reader(e["name"])(ctx)
            if value is not None:
                metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info(device, cell.chips, out["peak_bytes"])}
    if trace:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = tr.breakdown()
    line["compared"] = out["compared"]
    return line


def device_info(device, chips: int, peak: int) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
