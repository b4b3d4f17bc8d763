"""The benchmark's boundary: a run of each cell loads neither JAX nor the
JAX package (``repro``) nor the JAX-era ``benchmarks``; the reference loads
nothing of the program.  Top-level module names are compared whole, so
``repro_torch`` is not ``repro``."""

import json
import subprocess
import sys

from portbench.tests.smoke import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")

# a run of every cell's driver at smoke size on the CPU, each per-layer
# metric's reader loaded, then the top-level names of every module loaded
RUN_CELLS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench.harness import runner, spec
from portbench.tests import smoke
for c in spec.cells({root!r}):
    for e in c.per_layer:
        c.reader(e["name"])
    small = smoke.cell("qwen3" if "qwen3" in c.config_name else "zamba2",
                       c.kind)
    small.per_layer, small.end_to_end = c.per_layer, c.end_to_end
    runner.run(small, 3, 0.0, False, "cpu", 0.0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import portbench.reference.model, portbench.reference.adamw
import portbench.reference.train
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_load_no_jax():
    names = loaded(RUN_CELLS)
    assert "repro_torch" in names and "portbench" in names
    assert not set(names) & set(FORBIDDEN), set(names) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE_ONLY)
    assert "torch" in names
    assert not set(names) & {"repro_torch", *FORBIDDEN}
