"""Fan-in-masked matrix product: the LogicNet training kernel and its gradient.

``masked_matmul(x, w, mask, b)`` computes ``x (M, K) @ (w * mask) (K, N) +
b (N,)`` with a float32 accumulator, output in ``x``'s dtype.  On CUDA
tensors it launches ``masked_matmul_forward`` (``csrc/masked_matmul.cu``),
which replaces the Pallas ``repro.kernels.masked_matmul.masked_matmul_pallas``;
on CPU tensors it runs :func:`masked_matmul_plain`, the same function in
plain torch.

:class:`MaskedMatmulFn` is its autograd function: the forward and the
input gradient ``dx = dy @ (w * mask)^T`` launch the kernel (the latter on
the transposed operands); ``dw = (x^T @ dy) * mask`` and ``db = dy.sum(0)``
stay torch ops, as the reference leaves its gradient to XLA's autodiff of
plain jnp.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lut_lookup import require, stream_of

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_N = 64
_MAX_GRID_Y = 65535


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                        b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-torch version: ``(x @ (w * mask) + b)`` accumulated in at least
    float32, returned in ``x``'s dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    out = x.to(acc) @ (w * mask).to(acc)
    if b is not None:
        out = out + b.to(acc)
    return out.to(x.dtype)


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """``x (M, K) @ (w * mask) (K, N) + b (N,) -> (M, N)``.

    CUDA tensors launch the kernel (``launches`` counts those launches):
    float32 or bfloat16, one dtype for all operands, contiguous.  CPU
    tensors run :func:`masked_matmul_plain`.
    """
    dev = x.device
    if dev.type == "cpu":
        return masked_matmul_plain(x, w, mask, b)
    if dev.type != "cuda":
        raise ValueError(f"masked_matmul runs on cuda or cpu, not {dev}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes "
                        f"{tuple(_DTYPE_CODES)}")
    dtypes = (x.dtype,)
    require(x, "x", dtypes, 2, dev)
    require(w, "w", dtypes, 2, dev)
    require(mask, "mask", dtypes, 2, dev)
    if b is not None:
        require(b, "b", dtypes, 1, dev)
    m_dim, k_dim = x.shape
    n_dim = w.shape[1]
    if w.shape[0] != k_dim or mask.shape != w.shape:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and mask "
                         f"{tuple(mask.shape)} do not chain")
    if b is not None and b.shape != (n_dim,):
        raise ValueError(f"b has shape {tuple(b.shape)}; expected ({n_dim},)")
    if -(-n_dim // _TILE_N) > _MAX_GRID_Y:
        raise ValueError(f"N = {n_dim} exceeds the kernel's grid "
                         f"({_MAX_GRID_Y} tiles of {_TILE_N})")
    out = torch.empty((m_dim, n_dim), dtype=x.dtype, device=dev)
    if m_dim == 0 or n_dim == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.masked_matmul_forward(
            x.data_ptr(), w.data_ptr(), mask.data_ptr(),
            None if b is None else b.data_ptr(), m_dim, n_dim, k_dim,
            _DTYPE_CODES[x.dtype], out.data_ptr(), stream_of(dev))
    _build.check(err, "masked_matmul_forward")
    masked_matmul.launches += 1
    return out


masked_matmul.launches = 0


class MaskedMatmulFn(torch.autograd.Function):
    """Differentiable ``x @ (w * mask) + b``; the mask gets no gradient.

    Only the gradients in ``ctx.needs_input_grad`` are computed, so a first
    layer whose input is data launches no ``dx`` kernel.
    """

    @staticmethod
    def forward(ctx, x, w, mask, b=None):
        ctx.save_for_backward(x, w, mask)
        return masked_matmul(x, w, mask, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, mask = ctx.saved_tensors
        dy = dy.contiguous()
        n_in = len(ctx.needs_input_grad)
        need_x, need_w, _, need_b = (*ctx.needs_input_grad, False)[:4]
        dx = dw = db = None
        if need_x:
            dx = masked_matmul(dy, w.t().contiguous(), mask.t().contiguous())
        if need_w:
            dw = (x.t() @ dy) * mask
        if need_b:
            db = dy.sum(0)
        return (dx, dw, None, db)[:n_in]
