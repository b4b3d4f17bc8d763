"""Hand-written Hopper LUT kernels, their plain-torch versions and costing.

Each kernel wrapper launches its CUDA kernel (``csrc/lut_kernels.cu``) on
CUDA tensors and runs its plain version on CPU tensors; ``launches`` on
the wrapper counts kernel launches.

* ``lut_network.lut_network_mixed`` — fused network, mixed slabs;
* ``lut_network.lut_network`` — fused network, uniform slabs;
* ``lut_lookup.lut_lookup`` — one LUT layer.
"""

from repro_torch.kernels.lut_lookup import DEFAULT_BLOCK_B
from repro_torch.kernels.plan import (FUSED_SMEM_BUDGET_BYTES, FusedPlan,
                                      PlanVariant, default_variant,
                                      fused_plan)

__all__ = ["DEFAULT_BLOCK_B", "FUSED_SMEM_BUDGET_BYTES", "FusedPlan",
           "PlanVariant", "default_variant", "fused_plan"]
