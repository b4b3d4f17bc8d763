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

``flash_attention`` has no backward and raises on inputs that require
grad.  Training takes :func:`flash_attention_train` (the autograd
function :class:`FlashAttentionFn`) where :func:`attn_train_route` names
``"flash"``: its forward is the ``wgmma`` kernel with two more outputs
(``flash_attention_wgmma_forward_train``: each row's log-sum-exp and the
float32 output), its backward :func:`flash_attention_backward`, two
kernels of ``csrc/flash_attention_wgmma_bwd.cu`` (the dq pass, which also
computes ``D = rowsum(dO o O)``, then the dk/dv pass).  Each has its own
``launches`` and ``launches_by_route``.  The plain versions of both
halves, :func:`flash_attention_train_plain` and
:func:`flash_attention_backward_plain`, are their arithmetic in plain
torch (P recomputed from the log-sum-exp), which CPU tensors run.
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


def _plain_rows(b: int, hq: int, sq: int, skv: int) -> int:
    """Query rows a plain version takes at once: (B, Hq, rows, Skv) float32
    scores within ``_PLAIN_BLOCK_ELEMS``."""
    return max(1, min(sq, _PLAIN_BLOCK_ELEMS // max(1, b * hq * skv)))


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


def _masked_scores(q, kq, scale, r0, r1, causal, window=None):
    """Scaled scores of query rows r0:r1 of ``q`` against every key of
    ``kq`` (k repeated to q's heads), in ``kq``'s dtype, -inf where masked:
    causal, keys after the row; a window, keys ``window`` or more before
    it."""
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].to(kq.dtype),
                     kq) * scale
    if causal or window is not None:
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(kq.shape[2], device=q.device)[None, :]
        masked = torch.zeros((r1 - r0, kq.shape[2]), dtype=torch.bool,
                             device=q.device)
        if causal:
            masked |= kpos > qpos
        if window is not None:
            masked |= kpos <= qpos - window
        s = s.masked_fill(masked, float("-inf"))
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None, stats: bool = False):
    """Plain-torch version: dense masked softmax in float32 (float64 for
    float64 inputs), output in q's dtype (``repro.kernels.ref.
    flash_attention_ref``; q ``(B, Hq, Sq, D)`` against k, v ``(B, Hkv,
    Skv, D)``).  With ``stats`` it returns ``(out, lse, o32)``: also each
    row's log-sum-exp of the scaled, masked scores (B, Hq, Sq) and the
    output before its rounding (B, Hq, Sq, D), in the compute dtype."""
    _check_shapes(q, k, v, causal, window)
    b, hq, s, d = q.shape
    skv = k.shape[2]
    group = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    ct = torch.promote_types(q.dtype, torch.float32)
    kq = k.to(ct).repeat_interleave(group, dim=1)
    vq = v.to(ct).repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    if stats:
        lse = torch.empty((b, hq, s), dtype=ct, device=q.device)
        o32 = torch.empty((b, hq, s, d), dtype=ct, device=q.device)
    rows = _plain_rows(b, hq, s, skv)
    if q.device.type == "meta":
        rows = s            # shapes only: one block
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        logits = _masked_scores(q, kq, scale, r0, r1, causal, window)
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vq)
        out[:, :, r0:r1] = o.to(q.dtype)
        if stats:
            lse[:, :, r0:r1] = torch.logsumexp(logits, dim=-1)
            o32[:, :, r0:r1] = o
    return (out, lse, o32) if stats else out


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
                  scale: float) -> None:
    """``flash_attention_wgmma_forward`` on checked bfloat16 operands with
    ``D % 8 == 0``, into ``out`` through its strides (``out`` 16-byte
    aligned, its last dimension contiguous)."""
    b, hq, s, d = q.shape
    views = [_tma_view(t) for t in (q, k, v)]
    strides = [st for _, sts in views for st in sts] + list(out.stride()[:3])
    q, k, v = (t for t, _ in views)
    with torch.cuda.device(q.device):
        err = _build.library().flash_attention_wgmma_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 12)(*strides), b, hq, k.shape[1], s,
            k.shape[2], d, int(causal), window or 0, float(scale),
            stream_of(q.device))
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


# ---------------------------------------------------------------- training

# rows of a tile of the backward kernels: the log-sum-exp and D are kept
# (B, Hq, rows) with rows a multiple of it, so a tile's values are one
# bulk copy
_TRAIN_TILE = 64


def attn_train_route(dtype: torch.dtype, head_dim: int, seq: int,
                     seq_kv: int, chunk: int, window: int,
                     device_type: str) -> str:
    """The path of a training attention call (``attn_apply(...,
    train=True)``), from what its inputs show: ``"flash"``
    (:func:`flash_attention_train`: the ``wgmma`` forward and the backward
    kernels) for bfloat16 on the card with ``head_dim % 8 == 0`` up to
    256, self-attention (``seq == seq_kv``) without a window, where the
    chunked form computes the true function (``chunk >= seq`` or ``seq %
    chunk == 0``); else ``"chunked"`` (``models.attention.
    _chunked_attention``, differentiated by autograd): float32 (whisper's
    encoder), the CPU, decode lengths, windows (gemma3's local layers stay
    chunked: the kernels skip no tiles by window), and ragged chunks,
    where the reference's clamp mislabels keys and the chunked form keeps
    that fault as the reference has it."""
    if (device_type == "cuda" and dtype == torch.bfloat16
            and head_dim % 8 == 0 and 8 <= head_dim <= _MAX_DIM
            and seq == seq_kv and window == 0
            and (chunk >= seq or seq % chunk == 0)):
        return "flash"
    return "chunked"


def _train_rows(seq: int) -> int:
    return -(-seq // _TRAIN_TILE) * _TRAIN_TILE


def flash_attention_train_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                scale: float | None = None):
    """The training forward in plain torch: ``(out, lse, o32)`` of
    :func:`flash_attention_plain` with ``stats``, for Sq == Skv and no
    window."""
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 stats=True)


def flash_attention_backward_plain(q, k, v, o32, lse, dout, *,
                                   causal: bool = True,
                                   scale: float | None = None):
    """The backward kernels' arithmetic in plain torch: ``(dq, dk, dv)`` in
    the dtypes of q, k and v, computed in float32 (float64 for float64
    inputs) from the forward's ``lse`` and float32 output ``o32``::

        P = exp(q k^T * scale - lse)    (masked: 0)
        dV = P^T dO,  dP = dO V^T,  D = rowsum(dO o o32)
        dS = P o (dP - D),  dQ = dS K * scale,  dK = dS^T Q * scale

    dK and dV summed over the query heads of each KV head."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = 1.0 / d ** 0.5 if scale is None else scale
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, do = q.to(ct), dout.to(ct)
    kq = k.to(ct).repeat_interleave(group, dim=1)
    vq = v.to(ct).repeat_interleave(group, dim=1)
    delta = (do * o32.to(ct)).sum(-1)
    lse = lse.to(ct)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kq)
    dv = torch.zeros_like(vq)
    rows = _plain_rows(b, hq, s, s)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        p = torch.exp(_masked_scores(qf, kq, scale, r0, r1, causal)
                      - lse[:, :, r0:r1, None])
        dob = do[:, :, r0:r1]
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vq)
        ds = p * (dp - delta[:, :, r0:r1, None])
        dq[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", ds, kq) * scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qf[:, :, r0:r1]) * scale
    dk = dk.reshape(b, hkv, group, s, d).sum(2)
    dv = dv.reshape(b, hkv, group, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_train(q, k, v) -> None:
    """What the training kernels take: bfloat16 q, k, v on one card,
    ``D % 8 == 0`` up to 256, Sq == Skv, last dimensions contiguous."""
    _check_shapes(q, k, v, True, None)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}; expected {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} has dtype {t.dtype}; the training "
                            f"kernels take bfloat16 (attn_train_route "
                            f"sends other dtypes to the chunked form)")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"dimension")
    b, hq, _, d = q.shape
    if d % 8 or not 8 <= d <= _MAX_DIM:
        raise ValueError(f"head_dim {d}: the training kernels take a "
                         f"multiple of 8 up to {_MAX_DIM}")
    if max(b, hq) > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {hq} exceed the kernels' grid "
                         f"({_MAX_GRID_YZ})")


def _train_forward(q, k, v, causal: bool, scale: float):
    """``(out, lse, o32)`` as :func:`flash_attention_train_plain` gives
    them; on the card one ``flash_attention_wgmma_forward_train`` launch,
    ``out`` a (B, Hq, S, D) view of a (B, S, Hq, D) buffer and ``lse`` a
    (B, Hq, S) view of a (B, Hq, rows) buffer (rows a multiple of 64)."""
    if plain_device(q.device):
        return flash_attention_train_plain(q, k, v, causal=causal,
                                           scale=scale)
    _check_train(q, k, v)
    b, hq, s, d = q.shape
    dev = q.device
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=dev).transpose(
        1, 2)
    lse = torch.empty((b, hq, _train_rows(s)), dtype=torch.float32,
                      device=dev)
    o32 = torch.empty((b, hq, s, d), dtype=torch.float32, device=dev)
    views = [_tma_view(t) for t in (q, k, v)]
    strides = [st for _, sts in views for st in sts] + list(out.stride()[:3])
    q, k, v = (t for t, _ in views)
    with torch.cuda.device(dev):
        err = _build.library().flash_attention_wgmma_forward_train(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 12)(*strides), lse.data_ptr(),
            o32.data_ptr(), lse.shape[-1], b, hq, k.shape[1], s, d,
            int(causal), float(scale), stream_of(dev))
    _build.check(err, "flash_attention_wgmma_forward_train")
    flash_attention_train.launches += 1
    flash_attention_train.launches_by_route["wgmma"] += 1
    return out, lse[:, :, :s], o32


def flash_attention_backward(q, k, v, o32, lse, dout, *, causal: bool = True,
                             scale: float | None = None):
    """``(dq, dk, dv)`` of the attention :func:`flash_attention_train`
    computes, from its forward's ``lse`` (B, Hq, S) and float32 output
    ``o32`` (B, Hq, S, D) and the output's gradient ``dout`` (B, Hq, S,
    D).  On the card two launches of ``csrc/flash_attention_wgmma_bwd.cu``
    (``launches`` counts both): the dq pass, which first computes D for
    its rows, then the dk/dv pass; the gradients are (B, H, S, D) views of
    (B, S, H, D) buffers, as the forward's output.  CPU tensors run
    :func:`flash_attention_backward_plain`."""
    b, hq, s, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    if plain_device(q.device):
        return flash_attention_backward_plain(q, k, v, o32, lse, dout,
                                              causal=causal, scale=scale)
    _check_train(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if dout.stride(-1) != 1 or 0 in dout.stride():
        dout = dout.contiguous()      # an expanded gradient (a sum's)
    dev = q.device
    hkv = k.shape[1]
    rows = _train_rows(s)
    if lse.dtype != torch.float32 or lse.stride() != (hq * rows, rows, 1):
        padded = torch.zeros((b, hq, rows), dtype=torch.float32, device=dev)
        padded[:, :, :s] = lse
        lse = padded
    o32 = o32.float().contiguous()
    dq = torch.empty((b, s, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dk, dv = (torch.empty((b, s, hkv, d), dtype=t.dtype,
                          device=dev).transpose(1, 2) for t in (k, v))
    delta = torch.empty((b, hq, rows), dtype=torch.float32, device=dev)
    views = [_tma_view(t) for t in (q, k, v, dout)]
    strides = [st for _, sts in views for st in sts]
    for t in (dq, dk, dv):
        strides += list(t.stride()[:3])
    q, k, v, dout = (t for t, _ in views)
    with torch.cuda.device(dev):
        err = _build.library().flash_attention_wgmma_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            (ctypes.c_longlong * 21)(*strides), b, hq, hkv, s, rows, d,
            int(causal), float(scale), stream_of(dev))
    _build.check(err, "flash_attention_wgmma_backward")
    flash_attention_backward.launches += 2
    flash_attention_backward.launches_by_route["wgmma"] += 2
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient: the forward keeps q, k, v, the row
    log-sum-exp and the float32 output; the backward recomputes P from the
    log-sum-exp (:func:`flash_attention_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse, o32 = _train_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o32, lse, dout,
                                              causal=ctx.causal,
                                              scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, S, D); k, v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype,
    differentiable (:class:`FlashAttentionFn`): causal or unmasked
    self-attention, no window.  On the card bfloat16 with ``D % 8 == 0``
    up to 256 (``flash_attention_train.launches`` counts the forward's
    launches, :func:`flash_attention_backward`'s the backward's); CPU
    tensors run the plain versions of both halves.  A call that needs no
    gradient (grad mode off, or no input requires grad) is
    :func:`flash_attention`, whose output the training forward gives bit
    for bit, without the log-sum-exp and float32 output it would keep."""
    _check_shapes(q, k, v, causal, None)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"q's {q.shape[2]} rows and k's {k.shape[2]} keys "
                         f"differ: training attention is self-attention")
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        if q.device.type == "cuda":
            _check_train(q, k, v)
        return flash_attention(q, k, v, causal=causal, scale=float(scale))
    return FlashAttentionFn.apply(q, k, v, causal, float(scale))


flash_attention_train.launches = 0
flash_attention_train.launches_by_route = {"wgmma": 0}
flash_attention_backward.launches = 0
flash_attention_backward.launches_by_route = {"wgmma": 0}
