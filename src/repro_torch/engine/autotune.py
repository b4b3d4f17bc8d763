"""Compile-time variant autotuner: measure once on the card, persist, replay.

The port of ``repro.engine.autotune``.  The heuristic ladder in
``compile_network`` picks a layout from a static byte estimate; this module
measures instead: it enumerates the
:class:`~repro_torch.kernels.plan.PlanVariant` space (layout x block_b x
pack), builds each eligible variant's payload once per (layout, pack)
through the slab builders on the caller's device, times the forward that
``CompiledLUTNet.__call__`` runs (padding, wrapper, launches) over a
representative batch, and records the winner in an :class:`ExecutionPlan`
that rides in the artifact: deployment replays the measured choice with
zero search.

The timing protocol: a seeded synthetic batch (or the caller's) shaped
like serving traffic, ``warmup`` untimed calls, then ``reps`` timed passes
of ``iters`` calls each, each pass ending in ``torch.cuda.synchronize`` on
the host clock; the median pass survives.  The host clock is the right one
here: a LUT forward's wrapper and launch cost 31-61 us of host time
against 4-10 us on the device, so what serving pays is mostly host time.

A plan the search makes records where it was timed (``backend``: for
example ``"cuda:NVIDIA H100 80GB HBM3"`` or ``"cpu"``) and the route each
variant's kernel took (``routes``).  A loaded plan is replayed as saved,
whoever timed it; ``CompiledLUTNet.measured_here`` is true only for a plan
this package timed on the device the artifact is loaded on.

Search cost and coverage are observable: ``engine_autotune_seconds``
(histogram, one observation per search) and
``engine_autotune_variants_total`` (counter, labeled by layout).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.kernels.lut_lookup import DEFAULT_BLOCK_B, lut_lookup
from repro_torch.kernels.lut_network import (build_mixed_network_slabs,
                                             build_network_slabs,
                                             lut_network, lut_network_mixed)
from repro_torch.kernels.plan import (DEFAULT_BLOCK_BS,
                                      FUSED_SMEM_BUDGET_BYTES, FusedPlan,
                                      PlanVariant, default_variant,
                                      enumerate_variants)

# The card's counts.  Warmup covers the first launch, which builds or loads
# the kernel library, and the first use of each payload (its shared-memory
# layout is derived and cached on the slabs then).  A forward costs 30-130
# us of host time (one fused launch, or one launch a layer), so a pass of
# 50 calls spans 1.5-6.5 ms, well over the host clock's scheduling jitter
# (tens of us); the median of 7 passes drops a stray preemption.
AUTOTUNE_WARMUP = 3
AUTOTUNE_ITERS = 50
AUTOTUNE_REPS = 7
# The CPU runs the kernels' plain versions, for tests: milliseconds a call,
# timed with the reference's interpret-mode counts
CPU_AUTOTUNE_COUNTS = (1, 2, 3)

_M_AUTOTUNE_SECONDS = obs.registry().histogram(
    "engine_autotune_seconds",
    "wall-clock seconds per compile-time variant search")
_M_AUTOTUNE_VARIANTS = obs.registry().counter(
    "engine_autotune_variants_total",
    "plan variants built and timed by the autotuner", labels=("layout",))


def backend_of(device) -> str:
    """The name a plan records for where it was timed."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The execution strategy of an artifact, and why.

    * ``source`` — ``"heuristic"`` (the static ladder chose),
      ``"autotune"`` (measured) or ``"synthesized"`` (made while loading a
      format-1 artifact);
    * ``timings_us`` — variant key -> median microseconds per forward from
      the search that chose it (empty unless autotuned);
    * ``batch`` — rows of the batch those timings were taken over;
    * ``default_key`` — the heuristic default's variant key;
    * ``backend`` — where this package's search took the timings (None for
      a heuristic plan, or one another package measured);
    * ``routes`` — variant key -> the kernel route(s) its timed forwards
      launched (``"plain"`` on the CPU).

    ``backend`` and ``routes`` are saved only when set, so a heuristic
    plan's record equals the reference's and the reference reads every
    record (its ``from_dict`` ignores the two keys).
    """

    variant: PlanVariant
    source: str = "heuristic"
    timings_us: dict = dataclasses.field(default_factory=dict)
    batch: int = 0
    default_key: str | None = None
    backend: str | None = None
    routes: dict = dataclasses.field(default_factory=dict)

    @property
    def layout(self) -> str:
        return self.variant.layout

    @property
    def block_b(self) -> int:
        return self.variant.block_b

    @property
    def pack(self) -> bool:
        return self.variant.pack

    @property
    def fused(self) -> bool:
        return self.variant.cost.fused

    @property
    def reason(self) -> str:
        return self.variant.cost.reason

    @property
    def slab_bytes(self) -> int:
        return self.variant.cost.slab_bytes

    def as_dict(self) -> dict:
        d = {"variant": self.variant.as_dict(), "source": self.source,
             "timings_us": dict(self.timings_us), "batch": self.batch,
             "default_key": self.default_key}
        if self.backend is not None:
            d["backend"] = self.backend
        if self.routes:
            d["routes"] = dict(self.routes)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        return cls(variant=PlanVariant.from_dict(d["variant"]),
                   source=str(d["source"]),
                   timings_us=dict(d.get("timings_us") or {}),
                   batch=int(d.get("batch") or 0),
                   default_key=d.get("default_key"),
                   backend=d.get("backend"),
                   routes=dict(d.get("routes") or {}))

    @classmethod
    def from_fused(cls, cost: FusedPlan, layout: str, block_b: int, *,
                   source: str = "heuristic") -> "ExecutionPlan":
        """Wrap a heuristic costing (or a format-1 artifact's bare
        ``FusedPlan``) into a plan with no timing table."""
        pack = cost.pack if layout in ("mixed", "uniform") else False
        return cls(variant=PlanVariant(layout, int(block_b), pack, cost),
                   source=source)


def _synthetic_codes(in_features: int, bw: int, batch: int,
                     seed: int = 0) -> np.ndarray:
    """Seeded stand-in for serving traffic: uniform codes over the first
    layer's input alphabet (every LUT entry reachable)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bw, (batch, in_features), dtype=np.int32)


def _time_forward(fn, *, warmup: int, iters: int, reps: int,
                  device) -> float:
    """Median microseconds per call of the zero-arg ``fn``; each pass ends
    when the device has finished its calls."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn()
    sync()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        samples.append((time.perf_counter() - t0) / iters * 1e6)
    samples.sort()
    return samples[len(samples) // 2]


# the kernel wrapper each layout's forward launches
_WRAPPERS = {"mixed": lut_network_mixed, "uniform": lut_network,
             "per_layer": lut_lookup}


def autotune_network(uniform_triples, mixed_tables=None, *,
                     in_features: int,
                     block_b: int = DEFAULT_BLOCK_B,
                     budget_bytes: int = FUSED_SMEM_BUDGET_BYTES,
                     codes=None, block_bs=None, seed: int = 0,
                     warmup: int | None = None, iters: int | None = None,
                     reps: int | None = None, device=None):
    """Time every eligible variant on ``device`` and return the winner.

    ``uniform_triples`` is the ``(indices, table, bw_in)`` triple list,
    ``mixed_tables`` the compiler's mixed-width lowering when one exists.
    ``codes`` supplies the representative batch (None: a seeded synthetic
    batch of ``max(block_bs)`` rows).  ``block_b`` joins the sweep, so the
    heuristic default is always among the timed candidates.  ``warmup`` /
    ``iters`` / ``reps`` default to the card's counts (``AUTOTUNE_*``), or
    ``CPU_AUTOTUNE_COUNTS`` on the CPU.  The winner is the argmin of the
    timing table, the first minimum in enumeration order.

    On ``cuda`` every variant launches its kernel: one that fails to build
    or launch raises, and none is skipped or replaced by its plain version.

    Returns ``(plan, built)``: the :class:`ExecutionPlan` (``source=
    "autotune"``, the full timing table, ``backend`` and ``routes``) and
    the winner's already-built payload — ``NetworkSlabs`` /
    ``MixedNetworkSlabs`` for fused layouts, the ``(idx, table, bw)``
    tensor tuple for per-layer — so ``compile_network`` never builds the
    winning slabs twice.
    """
    from repro_torch.engine import engine as _eng   # lazy: engine imports us

    t_start = time.perf_counter()
    dev = resolve_device(device)
    counts = (CPU_AUTOTUNE_COUNTS if dev.type == "cpu" else
              (AUTOTUNE_WARMUP, AUTOTUNE_ITERS, AUTOTUNE_REPS))
    warmup, iters, reps = (c if v is None else v
                           for v, c in zip((warmup, iters, reps), counts))
    uniform_triples = list(uniform_triples)
    sweep = tuple(sorted({int(b) for b in (block_bs or DEFAULT_BLOCK_BS)}
                         | {int(block_b)}))
    variants = enumerate_variants(uniform_triples, mixed_tables,
                                  block_bs=sweep, budget_bytes=budget_bytes)
    default = default_variant(uniform_triples, mixed_tables,
                              block_b=block_b, budget_bytes=budget_bytes)

    if codes is None:
        bw = int(uniform_triples[0][2])
        codes = _synthetic_codes(in_features, bw, max(sweep), seed)
    codes = _eng._tensor(np.asarray(codes, dtype=np.int32), dev)
    batch = int(codes.shape[0])
    n_out = int(np.asarray(uniform_triples[-1][1]).shape[0])

    # one build per (layout, pack): slabs do not depend on block_b
    built: dict[tuple[str, bool], object] = {}

    def payload(v: PlanVariant):
        k = (v.layout, v.pack)
        if k not in built:
            if v.layout == "mixed":
                built[k] = build_mixed_network_slabs(
                    mixed_tables, pack=v.pack, device=dev)
            elif v.layout == "uniform":
                built[k] = build_network_slabs(uniform_triples,
                                               pack=v.pack, device=dev)
            else:
                built[k] = tuple(
                    (_eng._tensor(np.asarray(i, dtype=np.int32), dev),
                     _eng._tensor(np.asarray(t, dtype=np.int32), dev),
                     int(b))
                    for i, t, b in uniform_triples)
        return built[k]

    def candidate(v: PlanVariant, p) -> "_eng.CompiledLUTNet":
        """The artifact this variant would be: timing calls it, so the
        padding, the wrapper and the launches are what serving runs."""
        fused = v.layout in ("mixed", "uniform")
        return _eng.CompiledLUTNet(
            layout=v.layout, n_in=in_features,
            n_out=p.n_out if fused else n_out, block_b=v.block_b,
            plan=ExecutionPlan(variant=v), stats=None, device=dev,
            slabs=p if fused else None, layers=None if fused else p)

    timings: dict[str, float] = {}
    routes: dict[str, str] = {}
    by_key: dict[str, PlanVariant] = {}
    for v in variants:
        net = candidate(v, payload(v))
        wrapper = _WRAPPERS[v.layout]
        before = dict(wrapper.launches_by_route)
        timings[v.key] = _time_forward(lambda: net(codes), warmup=warmup,
                                       iters=iters, reps=reps, device=dev)
        used = [r for r, n in wrapper.launches_by_route.items()
                if n > before.get(r, 0)]
        if dev.type == "cuda" and not used:
            raise RuntimeError(f"autotune: {v.key} launched no kernel on "
                               f"{dev}")
        routes[v.key] = "+".join(used) or "plain"
        by_key[v.key] = v
        _M_AUTOTUNE_VARIANTS.labels(layout=v.layout).inc()

    winner = by_key[min(timings, key=timings.get)]
    plan = ExecutionPlan(variant=winner, source="autotune",
                         timings_us=timings, batch=batch,
                         default_key=default.key, backend=backend_of(dev),
                         routes=routes)
    _M_AUTOTUNE_SECONDS.observe(time.perf_counter() - t_start)
    return plan, payload(winner)
