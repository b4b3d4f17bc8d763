"""The legacy flag API over the port's kernels: the counterpart of
``repro.kernels.ops``.

Thin functions, one a kernel, each taking the reference's flags:
``use_pallas=True`` (the reference's name, kept) launches the port's
hand-written CUDA kernel through its wrapper on CUDA tensors, counted by
that wrapper's ``launches``; ``use_pallas=False`` runs the plain version
(:mod:`repro_torch.kernels.ref` for the LUT layer, the wrapper module's
``*_plain`` for the others).  On CPU tensors the wrappers run their
plain versions too, so these functions compute the same numbers on either
device.  Inputs that are not tensors go to ``cuda`` unless ``device``
says otherwise.

``lut_network`` compiles through the engine's identity-keyed memo
(``repro_torch.engine.cached_compile``): a loop of calls over the same
layer arrays compiles once.  New code should hold a ``CompiledLUTNet``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.lut_lookup import DEFAULT_BLOCK_B
from repro_torch.kernels.lut_lookup import lut_lookup as _lut_lookup
from repro_torch.kernels.masked_matmul import masked_matmul as _masked_matmul
from repro_torch.kernels.masked_matmul import masked_matmul_plain
# the fused-path costing lives in kernels.plan; re-exported here as the
# reference's ops module does
from repro_torch.kernels.plan import (FUSED_SMEM_BUDGET_BYTES,  # noqa: F401
                                      FusedPlan, fused_plan)


def _device_of(x, device) -> torch.device:
    if device is not None or not isinstance(x, torch.Tensor):
        return resolve_device(device)
    return x.device


def _int32(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def lut_lookup(codes, indices, table, bw_in: int, use_pallas: bool = True,
               block_b: int = DEFAULT_BLOCK_B, *,
               device=None) -> torch.Tensor:
    """One LUT layer: (B, I) codes -> (B, O) int32 codes, on ``codes``'
    device (or ``device``).

    ``block_b`` is accepted for the reference's signature; the kernel picks
    its own tiles (``lut_layer_route``).
    """
    del block_b
    dev = _device_of(codes, device)
    c, idx, tab = (_int32(a, dev) for a in (codes, indices, table))
    if not use_pallas:
        return ref.lut_lookup_ref(c, idx, tab, bw_in)
    return _lut_lookup(c, idx, tab, bw_in)


def lut_network(codes, layers, *, fused: bool = True,
                use_pallas: bool = True, block_b: int = DEFAULT_BLOCK_B,
                budget_bytes: int = FUSED_SMEM_BUDGET_BYTES,
                optimize_level: int | None = None,
                device=None) -> torch.Tensor:
    """Whole sparse-stack LUT inference: (B, I0) codes -> (B, O_last) codes.

    ``layers`` is a sequence of ``(indices, table, bw_in)`` triples, one a
    sparse layer (``LayerTruthTable``'s fields).  With ``fused`` the stack
    runs as one fused kernel launch when its slabs fit ``budget_bytes``;
    otherwise, and always with ``fused=False``, one per-layer launch a
    layer.  ``optimize_level`` (0-4) runs the truth-table compiler first;
    the fused path then serves its mixed-width lowering.  Every path is
    bit-exact with ``core.table_infer.network_table_forward``.

    The build is memoized (``repro_torch.engine.cached_compile``) on the
    layer arrays' identity, the flags and the device, so repeated calls
    with the same layers reuse one artifact.  Arrays handed here must be
    treated as immutable: after an in-place table edit call
    ``repro_torch.engine.cache_clear()``.

    Example::

        import numpy as np
        import torch
        from repro_torch.kernels.ops import lut_network
        rng = np.random.default_rng(0)
        idx = np.stack([np.sort(rng.choice(6, 2, replace=False))
                        for _ in range(4)]).astype(np.int32)
        tab = rng.integers(0, 4, (4, 16), dtype=np.int32)
        codes = torch.from_numpy(rng.integers(0, 4, (3, 6),
                                              dtype=np.int32))
        out = lut_network(codes, [(idx, tab, 2)], fused=True)
        assert out.shape == (3, 4)
    """
    from repro_torch import engine

    dev = _device_of(codes, device)
    c = _int32(codes, dev)
    net = engine.cached_compile(layers, optimize_level=optimize_level,
                                in_features=int(c.shape[-1]), fused=fused,
                                use_pallas=use_pallas, block_b=block_b,
                                budget_bytes=budget_bytes, device=dev)
    return net(c)


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                  b: torch.Tensor | None = None,
                  use_pallas: bool = True) -> torch.Tensor:
    """``y = x @ (w * mask) + b`` on ``x``'s device."""
    if not use_pallas:
        return masked_matmul_plain(x, w, mask, b)
    return _masked_matmul(x, w, mask, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    use_pallas: bool = True) -> torch.Tensor:
    """Blocked attention on ``q``'s device; GQA via Hq % Hkv == 0."""
    if not use_pallas:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _flash(q, k, v, causal=causal, window=window)
