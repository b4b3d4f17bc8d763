"""Compile-once serving engine for LUT networks on one torch device.

``load(path)`` serves an artifact of either package; ``compile_network``
builds one from raw truth-table triples (see ``repro_torch.engine.engine``),
by the heuristic ladder or, with ``autotune=True``, by timing every
variant on the device (``autotune_network``); ``cached_compile`` memoizes
it for the legacy flag API (``cache_size`` / ``cache_clear``).
"""

from repro_torch.engine.autotune import ExecutionPlan, autotune_network
from repro_torch.engine.engine import (ARTIFACT_KIND, FORMAT_VERSION,
                                       CompiledLUTNet, cache_clear,
                                       cache_size, cached_compile,
                                       compile_network, compile_runs, load)

__all__ = ["ARTIFACT_KIND", "FORMAT_VERSION", "CompiledLUTNet",
           "ExecutionPlan", "autotune_network", "cache_clear", "cache_size",
           "cached_compile", "compile_network", "compile_runs", "load"]
