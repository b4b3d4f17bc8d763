"""Blocked flash attention (forward): the LM-zoo prefill kernel.

``flash_attention(q, k, v, causal=, window=, scale=)`` computes softmax
attention with GQA head sharing in the reference's ``(B, H, S, D)``
layout: q ``(B, Hq, S, D)``, k and v ``(B, Hkv, S, D)``, ``Hq % Hkv == 0``,
query head ``h`` reading KV head ``h // (Hq / Hkv)``.  ``causal`` keeps
keys at or before the query; ``window`` (None, or at least 1) keeps only
the last ``window`` keys of each query.  Arithmetic is float32 and the
output has q's dtype.

On CUDA tensors it launches ``flash_attention_forward``
(``csrc/flash_attention.cu``), which replaces the Pallas
``repro.kernels.flash_attention.flash_attention_pallas``; on CPU tensors
it runs :func:`flash_attention_plain`, the dense masked softmax of
``repro.kernels.ref.flash_attention_ref`` in plain torch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lut_lookup import stream_of

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 256
_MAX_GRID_YZ = 65535
# Largest (B, Hq, rows, S) float32 score block the plain version holds at
# once (1 GiB); it takes the query rows in blocks of that size, each row's
# softmax whole.
_PLAIN_BLOCK_ELEMS = 2 ** 28


def _check_shapes(q, k, v, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                             f"(B, H, S, D)")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if v.shape != k.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0; got Hq {hq}, Hkv {hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window is {window}; pass None for no window (a "
                         f"window of 0 would mask every key)")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Plain-torch version: dense masked softmax in float32, output in q's
    dtype (``repro.kernels.ref.flash_attention_ref``)."""
    _check_shapes(q, k, v, window)
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kq = k.float().repeat_interleave(group, dim=1)
    vq = v.float().repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    rows = max(1, min(s, _PLAIN_BLOCK_ELEMS // max(1, b * hq * s)))
    kpos = torch.arange(s, device=q.device)[None, :]
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                              kq) * scale
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        mask = torch.ones((r1 - r0, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = logits.masked_fill(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1)
        out[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, S, D); k, v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.

    CUDA tensors launch the kernel (``launches`` counts those launches):
    float32 or bfloat16, one dtype and one device for all three,
    contiguous, ``D <= 256``.  CPU tensors run :func:`flash_attention_plain`.
    """
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    _check_shapes(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}; expected {dev}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"one of {tuple(_DTYPE_CODES)} for q, k and v")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, hq, s, d = q.shape
    if d > _MAX_DIM or d < 1:
        raise ValueError(f"head_dim {d} is outside the kernel's 1..{_MAX_DIM}")
    if max(b, hq) > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {hq} exceed the kernel's grid "
                         f"({_MAX_GRID_YZ})")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], s, d, int(causal), window or 0, float(scale),
            _DTYPE_CODES[q.dtype], stream_of(dev))
    _build.check(err, "flash_attention_forward")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
