"""LogicNet core of the port: quantizers, sparsity, layers, truth tables,
table inference, network assembly and training (``repro.core``'s
counterparts, in PyTorch)."""
