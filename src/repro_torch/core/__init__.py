"""LogicNet core of the port: quantizers, sparsity, layers, truth tables,
table inference, network assembly and training (``repro.core``'s
counterparts, in PyTorch)."""

from repro_torch.core.layers import (SparseConv, SparseConvCfg,
                                     sparse_conv_from_reference,
                                     sparse_conv_to_reference)

__all__ = ["SparseConv", "SparseConvCfg", "sparse_conv_from_reference",
           "sparse_conv_to_reference"]
