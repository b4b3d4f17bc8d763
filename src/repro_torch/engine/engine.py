"""Compile-once serving artifact on one torch device: ``CompiledLUTNet``.

The port of ``repro.engine.engine``::

    from repro_torch import engine
    net = engine.compile_network(tables, optimize_level=3, in_features=16)
    net.stats                                    # the compiler run's CompileStats
    net = engine.load("model_a_l3.npz")          # on cuda; device="cpu" asks
    out = net(codes)                             # (batch, n_out) int32
    net.save("copy.npz")                         # readable by repro.engine

An artifact runs one of three layouts, each through one hand-written
kernel (``repro_torch.kernels``): ``"mixed"`` (fused, compiler-exact
slabs), ``"uniform"`` (fused, row-stacked slabs) or ``"per_layer"`` (one
kernel launch per layer); ``"reference"`` is the plain-torch oracle
chain.  ``save`` / ``load`` use the reference's ``.npz`` artifact format
(versions 1-3), so either package serves what the other wrote.

``compile_network`` runs the reference's layout ladder: with
``optimize_level`` the truth-table compiler (``repro_torch.compile``) runs
once and its mixed-width lowering takes the fused mixed layout when its
slabs fit the shared-memory budget; otherwise the uniform layout when
its slabs fit, else per-layer.

``autotune=True`` replaces the ladder with measurement on the device
(``repro_torch.engine.autotune``): the artifact carries the winner, its
timing table and the name of the card that took it.

``stats`` is the ``CompileStats`` of the build's one compiler run
(``None`` when the compiler did not run); ``save`` writes it as
``as_dict()`` and ``load`` reads it back with ``from_dict``, as the
reference does.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.checkpoint.ckpt import load_arrays, save_arrays
from repro_torch.compile.pipeline import CompileStats, OptimizeResult
from repro_torch.engine.autotune import (ExecutionPlan, autotune_network,
                                        backend_of)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.lut_lookup import DEFAULT_BLOCK_B, lut_lookup
from repro_torch.kernels.lut_network import (LayerMeta, MixedGroupMeta,
                                             MixedLayerMeta,
                                             MixedNetworkSlabs, NetworkSlabs,
                                             build_mixed_network_slabs,
                                             build_network_slabs,
                                             lut_network, lut_network_mixed)
from repro_torch.kernels.plan import (FUSED_SMEM_BUDGET_BYTES, FusedPlan,
                                      fused_plan)

# the reference's artifact format: format 2 carries the ExecutionPlan
# record, format 3 lets mixed layer groups carry row-dedup offsets
FORMAT_VERSION = 3
ARTIFACT_KIND = "repro.engine.CompiledLUTNet"

# process-wide count of optimize() runs issued by this module; the tier
# and the serving tests assert it stays flat after warmup
_compile_runs = 0

_M_COMPILER_RUNS = obs.registry().counter(
    "engine_compiler_runs_total",
    "truth-table compiler invocations issued by the engine")
_M_BUILDS = obs.registry().counter(
    "engine_builds_total", "CompiledLUTNet builds by chosen layout",
    labels=("layout",))
_M_SLAB_BUILD = obs.registry().histogram(
    "engine_slab_build_seconds",
    "host-side slab construction time per compile_network build")
_M_LOADS = obs.registry().counter(
    "engine_artifact_loads_total",
    "CompiledLUTNet artifacts rebuilt from disk via engine.load")


def compile_runs() -> int:
    """How many times this module has invoked the truth-table compiler."""
    return _compile_runs


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@dataclasses.dataclass(frozen=True)
class CompiledLUTNet:
    """An ahead-of-time compiled LUT network on one device, ready to serve.

    Exactly one of ``slabs`` (mixed / uniform) and ``layers`` (per_layer /
    reference: ``(idx, table, bw_in)`` with int32 tensors) is set.  ``plan``
    is the :class:`ExecutionPlan` that chose the layout; ``layout`` and
    ``block_b`` mirror it.
    """

    layout: str
    n_in: int
    n_out: int
    block_b: int
    plan: ExecutionPlan
    stats: CompileStats | None
    device: torch.device
    slabs: NetworkSlabs | MixedNetworkSlabs | None = None
    layers: tuple[tuple[torch.Tensor, torch.Tensor, int], ...] | None = None

    def __call__(self, codes) -> torch.Tensor:
        """(batch, n_in) int codes -> (batch, n_out) int32 codes on
        ``device``.

        Ragged batches are padded with zero codes up to the next ``block_b``
        multiple and sliced back, as in the reference.
        """
        codes = torch.as_tensor(codes, dtype=torch.int32,
                                device=self.device).contiguous()
        if codes.dim() != 2 or codes.shape[1] != self.n_in:
            raise ValueError(
                f"expected (batch, {self.n_in}) codes, got "
                f"{tuple(codes.shape)}")
        batch = codes.shape[0]
        if batch == 0:
            return torch.zeros((0, self.n_out), dtype=torch.int32,
                               device=self.device)
        padded = -(-batch // self.block_b) * self.block_b
        if padded != batch:
            codes = torch.cat([codes, codes.new_zeros(
                (padded - batch, self.n_in))])
        out = self._apply(codes)
        return out[:batch] if padded != batch else out

    def _apply(self, codes: torch.Tensor) -> torch.Tensor:
        if self.layout == "mixed":
            return lut_network_mixed(codes, self.slabs)
        if self.layout == "uniform":
            return lut_network(codes, self.slabs)
        step = lut_lookup if self.layout == "per_layer" else ref.lut_lookup_ref
        for idx, tab, bw in self.layers:
            codes = step(codes, idx, tab, bw)
        return codes

    @property
    def measured_here(self) -> bool:
        """Whether the plan's timings were taken by this package on this
        artifact's kind of device.  A plan another package or another card
        timed is replayed as saved, but never reported as measured here."""
        return (self.plan.source == "autotune"
                and self.plan.backend == backend_of(self.device))

    def kernel_builds(self) -> int:
        """Kernel-library builds and loads in this process.

        The port's counterpart of the reference's ``jit_cache_size``: the
        library is built once, at the first forward on the card, so a
        steady-state serving loop must not grow it.
        """
        return _build.builds()

    def slab_breakdown(self) -> dict:
        """Per-slab bytes of the chosen layout (the reference's
        ``vmem_breakdown`` keys)."""
        if self.slabs is not None:
            return {**self.slabs.slab_breakdown(), "layout": self.layout}
        idx = sum(i.numel() * i.element_size() for i, _, _ in self.layers)
        tab = sum(t.numel() * t.element_size() for _, t, _ in self.layers)
        return {"idx_slab_bytes": idx, "table_slab_bytes": tab,
                "total_bytes": idx + tab, "packed_int8": False,
                "layout": self.layout}

    def save(self, path: str) -> str:
        """Write the artifact as one ``.npz`` in the reference's format."""
        meta: dict = {
            "kind": ARTIFACT_KIND, "format": FORMAT_VERSION,
            "layout": self.layout, "n_in": self.n_in, "n_out": self.n_out,
            "block_b": self.block_b, "plan": self.plan.as_dict(),
            "stats": None if self.stats is None else self.stats.as_dict(),
        }
        s = self.slabs
        if self.layout == "mixed":
            arrays = {"idx_slab": s.idx_slab, "shift_slab": s.shift_slab,
                      "width_slab": s.width_slab, "table_slab": s.table_slab}
            meta["packed"] = s.packed
            meta["out_perm"] = (None if s.out_perm is None
                                else list(s.out_perm))
            meta["layer_meta"] = [
                {"n_out": m.n_out, "fan_in": m.fan_in,
                 # 2-element groups: contiguous tables; a third element
                 # carries the row-dedup flat offsets (format 3)
                 "groups": [[g.n_out, g.entry_bits] if g.offs is None
                            else [g.n_out, g.entry_bits, list(g.offs)]
                            for g in m.groups]}
                for m in s.meta]
            meta["dedup_entries_saved"] = int(s.dedup_entries_saved)
        elif self.layout == "uniform":
            arrays = {"idx_slab": s.idx_slab, "table_slab": s.table_slab}
            meta["packed"] = s.packed
            meta["layer_meta"] = [list(m) for m in s.meta]
        else:
            arrays = {}
            meta["bws"] = [int(bw) for _, _, bw in self.layers]
            for li, (idx, tab, _) in enumerate(self.layers):
                arrays[f"idx_{li}"] = idx
                arrays[f"table_{li}"] = tab
        return save_arrays(path, {k: v.cpu().numpy()
                                  for k, v in arrays.items()}, meta)


def load(path: str, device=None) -> CompiledLUTNet:
    """Rebuild a ``CompiledLUTNet`` from an artifact of either package.

    Reads formats 1-3 with no compiler run, no slab build and no search:
    an autotuned plan is replayed as saved (the artifact holds only its
    variant's slabs), whoever timed it (see ``measured_here``); ``device``
    defaults to ``cuda``.
    """
    dev = resolve_device(device)
    arrays, meta = load_arrays(path)
    if meta.get("kind") != ARTIFACT_KIND:
        raise ValueError(
            f"{path} is not a {ARTIFACT_KIND} artifact "
            f"(kind={meta.get('kind')!r})")
    if meta.get("format", 0) > FORMAT_VERSION:
        raise ValueError(
            f"{path} has artifact format {meta['format']}; this build "
            f"reads <= {FORMAT_VERSION}")
    pd = meta["plan"]
    if "variant" in pd:
        plan = ExecutionPlan.from_dict(pd)
    else:
        # format 1: the record is a bare FusedPlan
        plan = ExecutionPlan.from_fused(
            FusedPlan.from_dict(pd), meta["layout"], int(meta["block_b"]),
            source="synthesized")
    layout = meta["layout"]
    slabs = None
    layers = None
    if layout == "mixed":
        lm = tuple(
            MixedLayerMeta(int(m["n_out"]), int(m["fan_in"]), tuple(
                MixedGroupMeta(int(g[0]), int(g[1]),
                               tuple(int(o) for o in g[2])
                               if len(g) > 2 else None)
                for g in m["groups"]))
            for m in meta["layer_meta"])
        out_perm = (None if meta["out_perm"] is None
                    else tuple(int(p) for p in meta["out_perm"]))
        slabs = MixedNetworkSlabs(
            _tensor(arrays["idx_slab"], dev),
            _tensor(arrays["shift_slab"], dev),
            _tensor(arrays["width_slab"], dev),
            _tensor(arrays["table_slab"], dev),
            lm, out_perm, bool(meta["packed"]),
            dedup_entries_saved=int(meta.get("dedup_entries_saved", 0)))
    elif layout == "uniform":
        lm = tuple(LayerMeta(*(int(v) for v in m))
                   for m in meta["layer_meta"])
        slabs = NetworkSlabs(_tensor(arrays["idx_slab"], dev),
                             _tensor(arrays["table_slab"], dev),
                             lm, bool(meta["packed"]))
    elif layout in ("per_layer", "reference"):
        layers = tuple(
            (_tensor(arrays[f"idx_{li}"].astype(np.int32), dev),
             _tensor(arrays[f"table_{li}"].astype(np.int32), dev), int(bw))
            for li, bw in enumerate(meta["bws"]))
    else:
        raise ValueError(f"{path} has unknown layout {layout!r}")
    stats = (None if meta["stats"] is None
             else CompileStats.from_dict(meta["stats"]))
    _M_LOADS.inc()
    return CompiledLUTNet(layout=layout, n_in=int(meta["n_in"]),
                          n_out=int(meta["n_out"]),
                          block_b=int(meta["block_b"]), plan=plan,
                          stats=stats, device=dev, slabs=slabs,
                          layers=layers)


def _as_triples(layers) -> list[tuple[np.ndarray, np.ndarray, int]]:
    out = []
    for lay in layers:
        if hasattr(lay, "indices") and hasattr(lay, "table"):
            out.append((lay.indices, lay.table, int(lay.bw_in)))
        else:
            idx, tab, bw = lay
            out.append((idx, tab, int(bw)))
    if not out:
        raise ValueError("compile_network needs at least one layer")
    return out


def compile_network(layers, *, optimize_level: int | None = None,
                    in_features: int | None = None, fused: bool = True,
                    use_pallas: bool = True, block_b: int = DEFAULT_BLOCK_B,
                    budget_bytes: int = FUSED_SMEM_BUDGET_BYTES,
                    autotune: bool = False, autotune_codes=None,
                    autotune_block_bs=None, device=None) -> CompiledLUTNet:
    """Build a serving artifact, running the truth-table compiler at most
    once.

    ``layers`` is a ``LayerTruthTable`` list, a sequence of ``(indices,
    table, bw_in)`` triples, or an already-computed
    ``repro_torch.compile.OptimizeResult`` (the compiler is then skipped
    and its lowerings reused; ``optimize_level`` must be None).  The
    reference's ladder:

    1. ``optimize_level`` set -> run ``compile.optimize`` once; cost the
       compiler's mixed-width lowering with ``fused_plan`` and take the
       fused mixed layout when it fits ``budget_bytes``;
    2. otherwise the fused uniform layout (of the compiler's uniform
       lowering when it ran) when its slabs fit and ``fused`` is set;
    3. otherwise one per-layer kernel launch per layer; ``use_pallas=False``
       (the reference's name) pins the plain-torch reference chain.

    ``autotune=True`` replaces the ladder with measurement: every eligible
    variant (layout x block_b x pack) is built on ``device`` and its
    forward timed there (``repro_torch.engine.autotune``); the artifact
    serves the winner at its ``block_b`` and carries the timing table.
    ``autotune_codes`` supplies the batch (None: seeded synthetic codes),
    ``autotune_block_bs`` the ``block_b`` sweep (``block_b`` always joins
    it).  ``autotune`` is ignored under ``fused=False`` or
    ``use_pallas=False``: the caller pinned the path.

    ``in_features`` is the input bus width (default: the widest first-layer
    index + 1, or the compiler's own record of it); ``device`` defaults to
    ``cuda``.
    """
    global _compile_runs
    dev = resolve_device(device)
    res: OptimizeResult | None = None
    if isinstance(layers, OptimizeResult):
        if optimize_level is not None:
            raise ValueError(
                "layers is already an OptimizeResult; optimize_level must "
                "be None (the compiler does not run again)")
        res = layers
    else:
        triples = _as_triples(layers)
        if in_features is None:
            # only the first layer's indices address the input bus
            in_features = int(np.max(np.asarray(triples[0][0]))) + 1
        if optimize_level is not None:
            from repro_torch.compile import optimize, tables_from_triples
            res = optimize(tables_from_triples(triples), optimize_level,
                           in_features=in_features)
            _compile_runs += 1
            _M_COMPILER_RUNS.inc()
    stats = res.stats if res is not None else None

    if autotune and use_pallas and fused:
        mixed = res.mixed_tables if res is not None else None
        if res is not None:
            triples = [(tt.indices, tt.table, tt.bw_in)
                       for tt in res.tables]
            if in_features is None:
                in_features = res.cnet.in_features
        # the search's cost is observed by engine_autotune_seconds, not by
        # the slab-build histogram
        plan, built = autotune_network(
            triples, mixed, in_features=in_features, block_b=block_b,
            budget_bytes=budget_bytes, codes=autotune_codes,
            block_bs=autotune_block_bs, device=dev)
        _M_BUILDS.labels(layout=plan.layout).inc()
        if plan.layout in ("mixed", "uniform"):
            return CompiledLUTNet(layout=plan.layout, n_in=in_features,
                                  n_out=built.n_out, block_b=plan.block_b,
                                  plan=plan, stats=stats, device=dev,
                                  slabs=built)
        n_out = int(np.asarray(triples[-1][1]).shape[0])
        return CompiledLUTNet(layout="per_layer", n_in=in_features,
                              n_out=n_out, block_b=plan.block_b, plan=plan,
                              stats=stats, device=dev, layers=built)

    if res is not None and use_pallas and fused:
        mixed = res.mixed_tables
        cost = fused_plan(mixed, budget_bytes)
        if cost.fused:
            t0 = time.perf_counter()
            slabs = build_mixed_network_slabs(mixed, pack=cost.pack,
                                              device=dev)
            _M_SLAB_BUILD.observe(time.perf_counter() - t0)
            _M_BUILDS.labels(layout="mixed").inc()
            return CompiledLUTNet(
                layout="mixed",
                n_in=(res.cnet.in_features if in_features is None
                      else in_features),
                n_out=slabs.n_out, block_b=block_b,
                plan=ExecutionPlan.from_fused(cost, "mixed", block_b),
                stats=stats, device=dev, slabs=slabs)
    if res is not None:
        # the padded uniform lowering, built only once the mixed layout is
        # ruled out; the optimized first layer may have pruned its widest
        # input feature, so the bus width comes from the IR
        triples = [(tt.indices, tt.table, tt.bw_in) for tt in res.tables]
        if in_features is None:
            in_features = res.cnet.in_features
    n_out = int(np.asarray(triples[-1][1]).shape[0])

    cost = fused_plan(triples, budget_bytes)
    if not use_pallas or not fused:
        cost = dataclasses.replace(cost, fused=False,
                                   reason="fused_disabled")
    t0 = time.perf_counter()
    if cost.fused:
        slabs = build_network_slabs(triples, pack=cost.pack, device=dev)
        _M_SLAB_BUILD.observe(time.perf_counter() - t0)
        _M_BUILDS.labels(layout="uniform").inc()
        return CompiledLUTNet(
            layout="uniform", n_in=in_features, n_out=slabs.n_out,
            block_b=block_b,
            plan=ExecutionPlan.from_fused(cost, "uniform", block_b),
            stats=stats, device=dev, slabs=slabs)
    built = tuple((_tensor(np.asarray(i, dtype=np.int32), dev),
                   _tensor(np.asarray(t, dtype=np.int32), dev), int(b))
                  for i, t, b in triples)
    _M_SLAB_BUILD.observe(time.perf_counter() - t0)
    layout = "per_layer" if use_pallas else "reference"
    _M_BUILDS.labels(layout=layout).inc()
    return CompiledLUTNet(
        layout=layout, n_in=in_features, n_out=n_out, block_b=block_b,
        plan=ExecutionPlan.from_fused(cost, layout, block_b),
        stats=stats, device=dev, layers=built)
