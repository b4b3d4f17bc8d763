"""The execution plan a ``CompiledLUTNet`` runs (``ExecutionPlan``).

The port of ``repro.engine.autotune.ExecutionPlan``; the variant search
(``autotune_network``) is not ported yet, so every plan the port makes is
``"heuristic"``, and a loaded plan is replayed as it was saved.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.plan import FusedPlan, PlanVariant


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The execution strategy of an artifact, and why.

    * ``source`` — ``"heuristic"`` (the static ladder chose),
      ``"autotune"`` (measured by the reference's search) or
      ``"synthesized"`` (made while loading a format-1 artifact);
    * ``timings_us`` — variant key -> median microseconds per forward from
      the search that chose it (empty unless autotuned);
    * ``batch`` — rows of the batch those timings were taken over;
    * ``default_key`` — the heuristic default's variant key.
    """

    variant: PlanVariant
    source: str = "heuristic"
    timings_us: dict = dataclasses.field(default_factory=dict)
    batch: int = 0
    default_key: str | None = None

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
        return {"variant": self.variant.as_dict(), "source": self.source,
                "timings_us": dict(self.timings_us), "batch": self.batch,
                "default_key": self.default_key}

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        return cls(variant=PlanVariant.from_dict(d["variant"]),
                   source=str(d["source"]),
                   timings_us=dict(d.get("timings_us") or {}),
                   batch=int(d.get("batch") or 0),
                   default_key=d.get("default_key"))

    @classmethod
    def from_fused(cls, cost: FusedPlan, layout: str, block_b: int, *,
                   source: str = "heuristic") -> "ExecutionPlan":
        """Wrap a heuristic costing (or a format-1 artifact's bare
        ``FusedPlan``) into a plan with no timing table."""
        pack = cost.pack if layout in ("mixed", "uniform") else False
        return cls(variant=PlanVariant(layout, int(block_b), pack, cost),
                   source=source)
