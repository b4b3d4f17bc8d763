"""A traced segment of a run: device time by kernel, busy and idle time,
and the host phase each idle gap falls in.

The segment runs after the measured window: ``lead`` units (steps or
calls) whose records are not read (a trace loses records at its start),
then ``n`` measured units, each opened by a spin kernel
(``torch.cuda._sleep``) whose record marks it, a last marker, and one
more unit.  A unit's device time is the sum of the kernel, copy and fill
records between its marker and the next.  The trace stands when it holds
all ``n + 1`` markers and every measured unit of one shape holds as many
records as the others (a lost record shows as a shorter unit); otherwise
it is taken again, up to ``tries`` times.  This is the arithmetic of
``chip_smoke.py``'s ``step_profile`` and ``trace_accepted``.

The first marker is issued on an idle device right after a host clock
reading, which places the host's phases on the device's timeline: an idle
gap is named by the phase the host was in at the gap's midpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

# clock cycles of a marker (about 0.1 ms): short beside any unit
MARKER_CYCLES = 200_000
# kernel kinds by name, first match wins (cuBLAS names many Hopper GEMMs
# nvjet_*); the rest is elementwise and reductions
KINDS = (("masked_matmul", ("masked_matmul",)),
         ("flash", ("flash_attention",)),
         ("gemm", ("gemm", "gemv", "cutlass", "cublas", "nvjet", "xmma")),
         ("copy", ("memcpy", "memset")))


class Phases:
    """The harness's host phases of a loop, as (name, start, end) in
    seconds of ``time.perf_counter``."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))


def no_phases(name: str):
    """A phase recorder that records nothing (the untraced window)."""
    return contextlib.nullcontext()


@dataclasses.dataclass
class Trace:
    units: list          # per measured unit: {"key", "by_name": {name: s}}
    busy_s: float
    window_s: float
    gaps: dict           # {phase: idle seconds}
    tries: int

    def kernel_s(self, substrings) -> float:
        """Device seconds of kernels whose name holds one of
        ``substrings``, over the measured units."""
        return sum(s for u in self.units for name, s in u["by_name"].items()
                   if any(sub in name for sub in substrings))

    def by_kind(self) -> dict:
        """Device seconds a unit by kind of kernel (``KINDS``, else
        ``other``)."""
        out: dict[str, float] = {}
        for u in self.units:
            for name, s in u["by_name"].items():
                low = name.lower()
                kind = next((k for k, subs in KINDS
                             if any(x in low for x in subs)), "other")
                out[kind] = out.get(kind, 0.0) + s / len(self.units)
        return out

    def breakdown(self, n: int = 10) -> dict:
        total: dict[str, float] = {}
        for u in self.units:
            for name, s in u["by_name"].items():
                total[name] = total.get(name, 0.0) + s
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _read(prof, n: int, phases: Phases, host0_us: float, keys: list):
    """A Trace from a profile, or None when the trace does not stand."""
    from torch.autograd import DeviceType
    # the profiler's raw records: building its event tree takes longer
    # than the traced steps
    records = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA
                     and not e.is_user_annotation())
    marks = [i for i, r in enumerate(records) if "spin_kernel" in r[2]]
    if len(marks) != n + 1:
        return None, f"{len(marks)} of {n + 1} markers"
    units, counts = [], {}
    for key, a, b in zip(keys, marks, marks[1:]):
        run = records[a + 1:b]
        by_name: dict[str, float] = {}
        for start, end, name in run:
            by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
        units.append({"key": key, "by_name": by_name})
        counts.setdefault(key, []).append(len(run))
    if any(len(set(c)) > 1 for c in counts.values()):
        return None, f"records a unit by shape {counts}"
    w0, w1 = records[marks[0]][1], records[marks[-1]][0]
    busy = _union((s, e) for s, e, name in records[marks[0] + 1:marks[-1]]
                  if "spin_kernel" not in name)
    busy_us = sum(b - a for a, b in busy)
    offset = records[marks[0]][0] - host0_us
    spans = sorted((a * 1e6 + offset, b * 1e6 + offset, name)
                   for name, a, b in phases.spans)
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = next((nm for s, e, nm in spans if s <= mid <= e), "loop")
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return Trace(units=units, busy_s=busy_us / 1e6,
                 window_s=(w1 - w0) / 1e6, gaps=gaps, tries=0), ""


def traced(run_unit, n: int, lead: int = 1, tries: int = 3) -> Trace:
    """Trace ``n`` units of ``run_unit(phases) -> key`` (the unit's shape)
    as the module's docstring says; raises when no try stands."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    why = ""
    for attempt in range(1, tries + 1):
        phases, keys = Phases(), []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                run_unit(no_phases)
            torch.cuda.synchronize()
            host0 = time.perf_counter() * 1e6
            for k in range(n):
                torch.cuda._sleep(MARKER_CYCLES)
                keys.append(run_unit(phases))
            torch.cuda._sleep(MARKER_CYCLES)
            run_unit(no_phases)
            torch.cuda.synchronize()
        trace, why = _read(prof, n, phases, host0, keys)
        if trace is not None:
            trace.tries = attempt
            return trace
    raise RuntimeError(f"no trace of {tries} stood: {why}")
