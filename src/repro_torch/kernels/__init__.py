"""Hand-written Hopper LUT kernels, their plain-torch versions and costing.

Each kernel wrapper launches its CUDA kernel on CUDA tensors and runs its
plain version on CPU tensors; ``launches`` on the wrapper counts kernel
launches.

* ``lut_network.lut_network_mixed`` — fused network, mixed slabs
  (``csrc/lut_fused_smem.cu``, route ``smem``; ``csrc/lut_kernels.cu``,
  route ``global``, for slabs no shared-memory layout fits);
* ``lut_network.lut_network`` — fused network, uniform slabs (the same
  two routes);
* ``lut_lookup.lut_lookup`` — one LUT layer (``csrc/lut_layer_smem.cu``,
  a programmatic dependent launch: route ``smem``, tables staged in shared
  memory, or ``direct``, tables read in place).
"""

from repro_torch.kernels.lut_lookup import DEFAULT_BLOCK_B
from repro_torch.kernels.plan import (DEFAULT_BLOCK_BS,
                                      FUSED_SMEM_BUDGET_BYTES, FusedPlan,
                                      PlanVariant, default_variant,
                                      enumerate_variants, fused_plan)

__all__ = ["DEFAULT_BLOCK_B", "DEFAULT_BLOCK_BS", "FUSED_SMEM_BUDGET_BYTES",
           "FusedPlan", "PlanVariant", "default_variant",
           "enumerate_variants", "fused_plan"]
