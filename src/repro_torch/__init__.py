"""PyTorch / CUDA port of the LogicNets serving stack, beside ``repro``.

The JAX package ``repro`` is the reference; this package serves the same
compiled LUT artifacts on one NVIDIA H100 through LUT kernels written by
hand for Hopper (``repro_torch.kernels.csrc``).  It imports torch and
numpy only — never ``jax`` and nothing of ``repro`` — and keeps its own
copies of the host code it needs.

Entry points (``engine.load``, ``engine.compile_network``,
``serve.ServingTier``, ``python -m repro_torch.launch.serve``) run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
