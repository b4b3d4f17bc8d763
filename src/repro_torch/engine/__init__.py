"""Compile-once serving engine for LUT networks on one torch device.

``load(path)`` serves an artifact of either package; ``compile_network``
builds one from raw truth-table triples (see ``repro_torch.engine.engine``).
"""

from repro_torch.engine.autotune import ExecutionPlan
from repro_torch.engine.engine import (ARTIFACT_KIND, FORMAT_VERSION,
                                       CompiledLUTNet, compile_network,
                                       compile_runs, load)

__all__ = ["ARTIFACT_KIND", "FORMAT_VERSION", "CompiledLUTNet",
           "ExecutionPlan", "compile_network", "compile_runs", "load"]
