"""Collective traffic of a step, from a record of the collectives it
issued.

The port of ``repro.launch.hlo_stats`` (the name kept so that a reader
finds the counterpart).  The reference regexes the compiled HLO; PyTorch
compiles nothing, so :class:`CollectiveRecorder` (a dispatch mode) records
the functional collectives a step issues as it runs (DTensor's
redistributions are functional collectives), each with its result's
per-device bytes, and :func:`collective_bytes` sums them by kind with the
reference's wire factors: an all-reduce moves ~2x its buffer on a ring
(reduce-scatter + all-gather), the others ~1x their result.  The
reference's ``op_histogram`` (op kinds counted in HLO text) has no
counterpart: no program of the port reads one.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# functional collective ops (``torch.ops._c10d_functional``) by kind
_KIND_OF_OP = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _result_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(o) for o in out)
    return 0


def op_kind(func) -> str | None:
    """The collective kind of an op (``all-gather``, ...), or None."""
    pkt = getattr(func, "_overloadpacket", None)
    if pkt is None or "c10d_functional" not in str(pkt):
        return None
    return _KIND_OF_OP.get(pkt.__name__)


def dtensor_call(types) -> bool:
    """True for a call on DTensors: a dispatch mode passes it on
    (``NotImplemented``), and sees the local ops DTensor then runs."""
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class CollectiveRecorder(TorchDispatchMode):
    """``with CollectiveRecorder() as rec:`` a step; ``rec.record`` then
    lists ``(kind, result bytes)`` of every functional collective issued
    on this rank's local tensors, in order."""

    def __init__(self):
        super().__init__()
        self.record: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dtensor_call(types):
            # let DTensor run it: its local ops then come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = op_kind(func)
        if kind is not None:
            self.record.append((kind, _result_bytes(out)))
        return out


def collective_bytes(record) -> dict[str, float]:
    """Per-collective-type wire bytes (per device) + 'total', and
    ``n_<kind>`` counts, from ``(kind, result bytes)`` pairs."""
    out: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for kind, nbytes in record:
        out[kind] += nbytes * _WIRE_FACTOR[kind]
        counts[kind] += 1
    out["total"] = float(sum(v for k, v in out.items() if k != "total"))
    out.update({f"n_{k}": float(v) for k, v in counts.items()})
    return dict(out)

