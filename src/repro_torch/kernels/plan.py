"""Execution-plan variants: the space the engine autotunes over.

The port of ``repro.kernels.plan``.  ``fused_plan`` says whether a stack
takes a fused kernel: its projected slabs must fit
:data:`FUSED_SMEM_BUDGET_BYTES` and every code must lie in the range both
packages' fused layouts hold.  :class:`PlanVariant` is one point of the
space (layout x ``block_b`` x pack), :func:`enumerate_variants` lists
every eligible one for a stack (``repro_torch.engine.autotune`` times
them), and :func:`default_variant` is the engine's heuristic ladder:
mixed if eligible, else uniform if eligible, else the per-layer kernel.

The budget is Hopper's, not the TPU's: a block may use 232 448 bytes of
shared memory, of which the fused kernels' activation tile takes up to
``ACT_SMEM_BYTES``; the slabs get the rest, and the smem kernels stage
them whole in shared memory (``lut_network.fused_smem_layout``, which
pays for the metadata the estimate does not count out of the activation
tile).  The serialized field keeps the
reference's name, ``vmem_budget_bytes``, so artifacts stay readable by
both packages.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.lut_lookup import DEFAULT_BLOCK_B
from repro_torch.kernels.lut_network import (ACT_SMEM_BYTES,
                                             SMEM_PER_BLOCK_BYTES,
                                             estimate_mixed_slab_bytes,
                                             estimate_slab_bytes)

# block_b sweep the autotuner explores by default (the engine adds the
# caller's requested block_b to this set when it differs)
DEFAULT_BLOCK_BS = (64, 128, 256)

FUSED_SMEM_BUDGET_BYTES = SMEM_PER_BLOCK_BYTES - ACT_SMEM_BYTES


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Why a stack will (or won't) take a fused kernel.

    ``reason`` is ``"fused"`` (eligible), ``"slab_exceeds_smem_budget"``,
    ``"codes_exceed_f32_exact_range"``, or ``"fused_disabled"`` when the
    caller opted out (``fused=False`` / ``use_pallas=False``).  ``layout``
    records which slab layout was costed.  ``vmem_budget_bytes`` holds the
    budget the decision used (the name is the artifact format's).
    """

    fused: bool
    reason: str
    slab_bytes: int
    vmem_budget_bytes: int
    pack: bool
    f32_exact: bool
    layout: str = "uniform"

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "headroom_bytes": self.vmem_budget_bytes - self.slab_bytes}

    @classmethod
    def from_dict(cls, d: dict) -> "FusedPlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def fused_plan(layers, budget_bytes: int = FUSED_SMEM_BUDGET_BYTES, *,
               pack: bool | None = None) -> FusedPlan:
    """Evaluate the fused-path gate without building slabs.

    ``layers`` is the uniform ``(indices, table, bw_in)`` triple list or the
    compiler's mixed-width layer tables (costed at their exact footprint).
    ``pack`` forces the int8 table-slab choice when given.
    """
    layers = list(layers)
    mixed = bool(layers) and hasattr(layers[0], "entry_bits")
    estimate = estimate_mixed_slab_bytes if mixed else estimate_slab_bytes
    est_bytes, use_pack, f32_exact = estimate(layers, pack)
    if not f32_exact:
        fused, reason = False, "codes_exceed_f32_exact_range"
    elif est_bytes > budget_bytes:
        fused, reason = False, "slab_exceeds_smem_budget"
    else:
        fused, reason = True, "fused"
    return FusedPlan(fused, reason, est_bytes, budget_bytes, use_pack,
                     f32_exact, "mixed" if mixed else "uniform")


@dataclasses.dataclass(frozen=True)
class PlanVariant:
    """One execution strategy: layout x block_b x pack, with its costing.

    ``key`` is the stable identity timing tables are keyed on, e.g.
    ``"mixed/b128/packed"``.
    """

    layout: str
    block_b: int
    pack: bool
    cost: FusedPlan

    @property
    def key(self) -> str:
        return (f"{self.layout}/b{self.block_b}/"
                f"{'packed' if self.pack else 'unpacked'}")

    def as_dict(self) -> dict:
        return {"layout": self.layout, "block_b": self.block_b,
                "pack": self.pack, "cost": self.cost.as_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanVariant":
        return cls(layout=str(d["layout"]), block_b=int(d["block_b"]),
                   pack=bool(d["pack"]),
                   cost=FusedPlan.from_dict(d["cost"]))


def enumerate_variants(uniform_triples=None, mixed_tables=None, *,
                       block_bs=DEFAULT_BLOCK_BS,
                       budget_bytes: int = FUSED_SMEM_BUDGET_BYTES
                       ) -> tuple[PlanVariant, ...]:
    """Every buildable variant for a stack, in the reference's order.

    For each available layout (``mixed_tables`` when the compiler's
    lowering exists, ``uniform_triples`` always) the auto-pack costing is
    computed once; pack=False is also enumerated where auto-pack chose
    int8, and each eligible (layout, pack) is crossed with every
    ``block_bs`` tile.  Fused combinations over the budget or the code
    range are dropped; the per-layer kernel is always enumerable and
    closes the space, so the result is non-empty whenever
    ``uniform_triples`` is given.
    """
    variants: list[PlanVariant] = []
    pools = []
    if mixed_tables is not None:
        pools.append(list(mixed_tables))
    if uniform_triples is not None:
        pools.append(list(uniform_triples))
    for layers in pools:
        auto = fused_plan(layers, budget_bytes)
        packs = [auto.pack] + ([False] if auto.pack else [])
        for p in packs:
            plan = (auto if p == auto.pack
                    else fused_plan(layers, budget_bytes, pack=p))
            if not plan.fused:
                continue
            for bb in block_bs:
                variants.append(PlanVariant(plan.layout, int(bb), p, plan))
    if uniform_triples is not None:
        base = fused_plan(list(uniform_triples), budget_bytes)
        cost = dataclasses.replace(
            base, fused=False,
            reason=base.reason if not base.fused else "per_layer_variant")
        for bb in block_bs:
            variants.append(PlanVariant("per_layer", int(bb), False, cost))
    return tuple(variants)


def default_variant(uniform_triples=None, mixed_tables=None, *,
                    block_b: int = DEFAULT_BLOCK_B,
                    budget_bytes: int = FUSED_SMEM_BUDGET_BYTES
                    ) -> PlanVariant:
    """The heuristic ladder: mixed if eligible, else uniform if eligible,
    else per-layer — at ``block_b`` with auto pack."""
    if mixed_tables is not None:
        plan = fused_plan(list(mixed_tables), budget_bytes)
        if plan.fused:
            return PlanVariant("mixed", int(block_b), plan.pack, plan)
    if uniform_triples is None:
        raise ValueError("default_variant needs uniform_triples when the "
                         "mixed lowering is absent or ineligible")
    plan = fused_plan(list(uniform_triples), budget_bytes)
    if plan.fused:
        return PlanVariant("uniform", int(block_b), plan.pack, plan)
    return PlanVariant("per_layer", int(block_b), False,
                       dataclasses.replace(plan, fused=False))
