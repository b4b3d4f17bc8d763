"""Blocked flash attention (forward): the LM-zoo prefill kernel.

``flash_attention(q, k, v, causal=, window=, scale=)`` computes softmax
attention with GQA head sharing in the reference's ``(B, H, S, D)``
layout: q ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Skv, D)``, ``Hq % Hkv ==
0``, query head ``h`` reading KV head ``h // (Hq / Hkv)``.  ``causal``
keeps keys at or before the query; ``window`` (None, or at least 1) keeps
only the last ``window`` keys of each query.  ``Sq != Skv`` is
cross-attention (whisper's decoder against its encoder frames) and is
taken only with ``causal=False`` and no window: the reference's causal
mask has no offset, and it never asks for one.  Arithmetic is float32 and
the output has q's dtype.

On CUDA tensors it launches one of three kernels that replace the Pallas
``repro.kernels.flash_attention.flash_attention_pallas``, chosen by
:func:`flash_attention_route`:

* ``"wgmma"``: bfloat16 with ``D % 8 == 0`` runs
  ``flash_attention_wgmma_forward`` (``csrc/flash_attention_wgmma.cu``) on
  the tensor cores, P split into two bfloat16 halves (hi + lo) for the
  P V product, so P keeps its float32 precision;
* ``"tf32x3"``: float32 with ``D % 8 == 0`` runs
  ``flash_attention_tf32_forward`` (``csrc/flash_attention_tf32.cu``) on
  the tensor cores, each product as three TF32 products on a big + small
  split of both operands (float32-accurate);
* ``"simt"``: any other D, float32 or bfloat16, runs
  ``flash_attention_forward`` (``csrc/flash_attention.cu``) on CUDA cores
  in float32, on contiguous copies.

The two tensor-core routes read q, k and v through their strides (any
(B, H, S, D) view whose last dimension is contiguous, such as the
transpose of the LM's (B, S, H, D) projections) and write a (B, S, Hq, D)
buffer whose (B, Hq, S, D) view they return.

``flash_attention.launches`` counts every launch and
``flash_attention.launches_by_route`` each route's.  A failed build or
launch raises; no route falls back to another or to the plain version.
On CPU tensors it runs :func:`flash_attention_plain`, the dense masked
softmax of ``repro.kernels.ref.flash_attention_ref`` in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch._device import plain_device
from repro_torch.kernels import _build
from repro_torch.kernels.lut_lookup import stream_of
from repro_torch.parallel.local import any_dtensor, head_parallel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 256
_MAX_GRID_YZ = 65535
_TMA_ALIGN = 16


def flash_attention_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a CUDA call launches: for ``head_dim % 8 == 0`` (up to
    256) ``"wgmma"`` in bfloat16 and ``"tf32x3"`` in float32, else
    ``"simt"``."""
    if head_dim % 8 == 0 and 1 <= head_dim <= _MAX_DIM:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "tf32x3"
    return "simt"


def _tma_view(t: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """``t`` (B, H, S, D) with its (batch, head, seq) strides as TMA (and
    ``cp.async``) take them: 16-byte aligned start and strides, or else a
    contiguous copy.  A dimension of size 1 is never stepped, so it gets
    its contiguous stride."""
    b, h, s, d = t.shape
    natural = (h * s * d, s * d, d)
    strides = [st if n > 1 else nat for st, n, nat in
               zip(t.stride()[:3], t.shape[:3], natural)]
    if t.data_ptr() % _TMA_ALIGN or any(st * t.element_size() % _TMA_ALIGN
                                        for st in strides):
        return t.contiguous() if not t.is_contiguous() else t.clone(), \
            list(natural)
    return t, strides


# Largest (B, Hq, rows, S) float32 score block the plain version holds at
# once (1 GiB); it takes the query rows in blocks of that size, each row's
# softmax whole.
_PLAIN_BLOCK_ELEMS = 2 ** 28


def _check_shapes(q, k, v, causal, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                             f"(B, H, S, D)")
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if v.shape != k.shape or (k.shape[0], k.shape[3]) != (b, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0; got Hq {hq}, Hkv {hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window is {window}; pass None for no window (a "
                         f"window of 0 would mask every key)")
    if skv != s and (causal or window is not None):
        raise ValueError(f"q's {s} rows and k's {skv} keys do not match: "
                         f"a causal or windowed call takes Sq == Skv "
                         f"(cross-attention passes causal=False and no "
                         f"window)")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Plain-torch version: dense masked softmax in float32, output in q's
    dtype (``repro.kernels.ref.flash_attention_ref``; q ``(B, Hq, Sq,
    D)`` against k, v ``(B, Hkv, Skv, D)``)."""
    _check_shapes(q, k, v, causal, window)
    b, hq, s, d = q.shape
    skv = k.shape[2]
    group = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kq = k.float().repeat_interleave(group, dim=1)
    vq = v.float().repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    rows = max(1, min(s, _PLAIN_BLOCK_ELEMS // max(1, b * hq * skv)))
    if q.device.type == "meta":
        rows = s            # shapes only: one block
    kpos = torch.arange(skv, device=q.device)[None, :]
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                              kq) * scale
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        mask = torch.ones((r1 - r0, skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = logits.masked_fill(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1)
        out[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
    return out


def _launch_simt(q, k, v, out, causal: bool, window: int | None,
                 scale: float) -> None:
    """``flash_attention_forward`` on checked operands (contiguous copies of
    q, k and v), into the contiguous ``out``."""
    b, hq, s, d = q.shape
    q, k, v = (t.contiguous() for t in (q, k, v))
    with torch.cuda.device(q.device):
        err = _build.library().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], s, k.shape[2], d, int(causal), window or 0,
            float(scale), _DTYPE_CODES[q.dtype], stream_of(q.device))
    _build.check(err, "flash_attention_forward")


def _launch_wgmma(q, k, v, out, causal: bool, window: int | None,
                  scale: float, split_p: bool = True) -> None:
    """``flash_attention_wgmma_forward`` on checked bfloat16 operands with
    ``D % 8 == 0``, into ``out`` through its strides (``out`` 16-byte
    aligned, its last dimension contiguous).  ``split_p=False`` runs the
    kernel with P rounded to bfloat16 (one P V product; built for
    64 < D <= 128 with Hq / Hkv >= 2 only): a yardstick for what the
    hi + lo split costs, never taken by :func:`flash_attention`."""
    b, hq, s, d = q.shape
    views = [_tma_view(t) for t in (q, k, v)]
    strides = [st for _, sts in views for st in sts] + list(out.stride()[:3])
    q, k, v = (t for t, _ in views)
    with torch.cuda.device(q.device):
        err = _build.library().flash_attention_wgmma_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 12)(*strides), b, hq, k.shape[1], s,
            k.shape[2], d, int(causal), window or 0, int(split_p),
            float(scale), stream_of(q.device))
    _build.check(err, "flash_attention_wgmma_forward")


def _launch_tf32(q, k, v, out, causal: bool, window: int | None,
                 scale: float) -> None:
    """``flash_attention_tf32_forward`` on checked float32 operands with
    ``D % 8 == 0``, into ``out`` through its strides (``out`` 8-byte
    aligned with even strides, its last dimension contiguous)."""
    b, hq, s, d = q.shape
    views = [_tma_view(t) for t in (q, k, v)]
    strides = [st for _, sts in views for st in sts] + list(out.stride()[:3])
    q, k, v = (t for t, _ in views)
    with torch.cuda.device(q.device):
        err = _build.library().flash_attention_tf32_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 12)(*strides), b, hq, k.shape[1], s,
            k.shape[2], d, int(causal), window or 0, float(scale),
            stream_of(q.device))
    _build.check(err, "flash_attention_tf32_forward")


_LAUNCH = {"simt": _launch_simt, "wgmma": _launch_wgmma,
           "tf32x3": _launch_tf32}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype; ``Sq != Skv`` only with ``causal=False`` and no window.

    CUDA tensors launch the kernel :func:`flash_attention_route` names
    (``launches`` counts every launch, ``launches_by_route`` each route's):
    float32 or bfloat16, one dtype and one device for all three, the last
    dimension contiguous, ``D <= 256``.  CPU tensors run
    :func:`flash_attention_plain` (``meta`` tensors inside
    ``_device.abstract_run``, the dry-run's, its shapes).  DTensors
    (heads sharded on the model axis, batch on the others) run the kernel
    on each rank's local heads (``parallel.local.head_parallel``, which
    gives each rank the kv heads its q heads read).  Inputs that require
    grad raise on both devices: the kernel has no backward, and its
    output would silently cut the graph.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention has no backward: q, k or v "
                         "requires grad (train through attn_apply(..., "
                         "train=True), the chunked attention, or call it "
                         "under torch.no_grad())")
    if any_dtensor(q, k, v):
        return head_parallel(
            lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal,
                                               window=window, scale=scale),
            q, k, v, head_dim=1)
    dev = q.device
    if plain_device(dev):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    _check_shapes(q, k, v, causal, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}; expected {dev}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"one of {tuple(_DTYPE_CODES)} for q, k and v")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"dimension")
    b, hq, s, d = q.shape
    if d > _MAX_DIM or d < 1:
        raise ValueError(f"head_dim {d} is outside the kernel's 1..{_MAX_DIM}")
    if max(b, hq) > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {hq} exceed the kernel's grid "
                         f"({_MAX_GRID_YZ})")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    route = flash_attention_route(q.dtype, d)
    if route == "simt":
        out = torch.empty((b, hq, s, d), dtype=q.dtype, device=dev)
    else:
        out = torch.empty((b, s, hq, d), dtype=q.dtype,
                          device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    _LAUNCH[route](q, k, v, out, causal, window, scale)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"simt": 0, "wgmma": 0, "tf32x3": 0}
