"""Fan-in-masked matrix product: the LogicNet training kernel and its gradient.

``masked_matmul(x, w, mask, b)`` computes ``x (M, K) @ (w * mask) (K, N) +
b (N,)`` with a float32 accumulator, output in ``x``'s dtype.  On CUDA
tensors it launches one of three kernels that replace the Pallas
``repro.kernels.masked_matmul.masked_matmul_pallas``, chosen by
:func:`masked_matmul_route`:

* ``"ffma"``: float32 runs ``masked_matmul_ffma_forward``
  (``csrc/masked_matmul_ffma.cu``) on CUDA cores, in the tile
  :func:`masked_matmul_tile` picks.  One ``fmaf`` accumulator per output
  in ascending k, which keeps ``verify_tables`` exact: its output equals
  ``masked_matmul_forward``'s bit for bit;
* ``"wgmma"``: bfloat16 with K and N multiples of 8 (TMA's 16-byte
  strides) runs ``masked_matmul_wgmma_forward``
  (``csrc/masked_matmul_wgmma.cu``) on the tensor cores;
* ``"simt"``: bfloat16 of any other K or N runs ``masked_matmul_forward``
  (``csrc/masked_matmul.cu``), the first design, which is also the
  float32 order oracle the ``ffma`` kernel is held against on the card.

``transposed=True`` takes ``w`` and ``mask`` as (N, K) and computes ``x @
(w * mask)^T + b``: the ``ffma`` kernel reads them so; no other route
takes it.

``masked_matmul.launches`` counts every launch and
``masked_matmul.launches_by_route`` each route's.  A failed build or
launch raises; no route falls back to another or to the plain version.
On CPU tensors it runs :func:`masked_matmul_plain`, the same function in
plain torch.

:class:`MaskedMatmulFn` is its autograd function: the forward and the
input gradient ``dx = dy @ (w * mask)^T`` launch the kernel (in float32
through the transposed read, else on transposed copies); ``dw = (x^T @
dy) * mask``, the mask's ``dmask = (x^T @ dy) * w`` (from the same
product, when the mask requires grad) and ``db = dy.sum(0)`` stay torch
ops, as the reference leaves its gradient to XLA's autodiff of plain jnp.

The LogicNet-FFN's ``wi`` stage without grad has a path of its own, chosen
by :func:`logicnet_ffn_route`: :func:`quant_relu` quantizes the FFN's input
in one pass (``quant_relu_bf16_forward``) and
:func:`masked_matmul_swiglu_quant` computes ``Q(silu(xq @ (w_gate * mask))
* (xq @ (w_up * mask)))`` in one launch
(``masked_matmul_swiglu_quant_wgmma_forward``), both in
``csrc/masked_matmul_swiglu_quant_wgmma.cu``, with every rounding of the
composed path, so their outputs equal it bit for bit.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.nn.functional as F

from repro_torch._device import plain_device
from repro_torch.kernels import _build
from repro_torch.kernels.lut_lookup import require, stream_of
from repro_torch.parallel.local import any_dtensor, matmul_shards

if TYPE_CHECKING:
    from repro_torch.core.quantize import QuantizerCfg

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_N = 64
_WGMMA_TILE = (256, 128)
_SWIGLU_TILE = (256, 64)        # hq rows x columns a block of the fused kernel
# the ffma kernel's tiles (M, N) by name, in the order of its tile argument
FFMA_TILES = {"large": (128, 256), "small": (32, 32)}
_SMS = 132                      # an H100 SXM's streaming multiprocessors
_MAX_GRID_Y = 65535
_MAX_GRID_X = 2 ** 31 - 1
_TMA_ALIGN = 16


def masked_matmul_route(dtype: torch.dtype, k: int, n: int) -> str:
    """Which kernel a CUDA call of these operands launches: ``"ffma"`` for
    float32, ``"wgmma"`` for bfloat16 with K >= 1 and K, N multiples of 8,
    else ``"simt"``."""
    if dtype == torch.float32:
        return "ffma"
    if dtype == torch.bfloat16 and k >= 1 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "simt"


def masked_matmul_tile(m: int, k: int, n: int) -> str:
    """The ``ffma`` kernel's tile for an (M, K) @ (K, N) product:
    ``"large"`` (128 x 256 outputs a block, 8 x 16 a thread) where its grid
    gives every SM of an H100 a block, or where N has more 32-column tiles
    than the grid's y limit; else ``"small"`` (32 x 32, 4 x 4 a thread, K
    panels of 64): model A's 256 x 64 x 64 gets 16 blocks instead of 2.
    K does not change the choice."""
    bm, bn = FFMA_TILES["large"]
    if (-(-m // bm) * -(-n // bn) >= _SMS
            or -(-n // FFMA_TILES["small"][1]) > _MAX_GRID_Y):
        return "large"
    return "small"


def ffma_grid(m: int, k: int, n: int) -> tuple[int, int]:
    """The ``ffma`` kernel's grid (row tiles on x, column tiles on y) in
    the tile :func:`masked_matmul_tile` picks; raises ``ValueError`` past
    CUDA's grid limits."""
    bm, bn = FFMA_TILES[masked_matmul_tile(m, k, n)]
    grid = (-(-m // bm), -(-n // bn))
    if grid[0] > _MAX_GRID_X or grid[1] > _MAX_GRID_Y:
        raise ValueError(f"({m}, {n}) exceeds the kernel's grid "
                         f"({_MAX_GRID_X} x {_MAX_GRID_Y} tiles of "
                         f"{(bm, bn)})")
    return grid


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                        b: torch.Tensor | None = None, *,
                        transposed: bool = False) -> torch.Tensor:
    """Plain-torch version: ``(x @ (w * mask) + b)`` accumulated in at least
    float32, returned in ``x``'s dtype; with ``transposed``, ``w`` and
    ``mask`` are (N, K) and the product is ``x @ (w * mask)^T`` (the same
    numbers as on transposed copies)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    wm = w * mask
    if transposed:
        wm = wm.t().contiguous()
    out = x.to(acc) @ wm.to(acc)
    if b is not None:
        out = out + b.to(acc)
    return out.to(x.dtype)


def _launch_simt(x, w, mask, b, out) -> None:
    """``masked_matmul_forward`` on checked operands, into ``out``."""
    (m_dim, k_dim), n_dim = x.shape, w.shape[1]
    with torch.cuda.device(x.device):
        err = _build.library().masked_matmul_forward(
            x.data_ptr(), w.data_ptr(), mask.data_ptr(),
            None if b is None else b.data_ptr(), m_dim, n_dim, k_dim,
            _DTYPE_CODES[x.dtype], out.data_ptr(), stream_of(x.device))
    _build.check(err, "masked_matmul_forward")


def _launch_ffma(x, w, mask, b, out, transposed: bool) -> None:
    """``masked_matmul_ffma_forward`` on checked float32 operands, into
    ``out``, in the tile :func:`masked_matmul_tile` picks."""
    m_dim, k_dim = x.shape
    n_dim = out.shape[1]
    tile = list(FFMA_TILES).index(masked_matmul_tile(m_dim, k_dim, n_dim))
    with torch.cuda.device(x.device):
        err = _build.library().masked_matmul_ffma_forward(
            x.data_ptr(), w.data_ptr(), mask.data_ptr(),
            None if b is None else b.data_ptr(), m_dim, n_dim, k_dim,
            int(transposed), tile, out.data_ptr(), stream_of(x.device))
    _build.check(err, "masked_matmul_ffma_forward")


def _launch_wgmma(x, w, mask, b, out) -> None:
    """``masked_matmul_wgmma_forward`` on checked bfloat16 operands whose K
    and N are multiples of 8, into ``out``."""
    (m_dim, k_dim), n_dim = x.shape, w.shape[1]
    # TMA reads from 16-byte aligned addresses: a view that starts
    # elsewhere is copied once
    x, w, mask = (t if t.data_ptr() % _TMA_ALIGN == 0 else t.clone()
                  for t in (x, w, mask))
    with torch.cuda.device(x.device):
        err = _build.library().masked_matmul_wgmma_forward(
            x.data_ptr(), w.data_ptr(), mask.data_ptr(),
            None if b is None else b.data_ptr(), m_dim, n_dim, k_dim,
            out.data_ptr(), stream_of(x.device))
    _build.check(err, "masked_matmul_wgmma_forward")


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                  b: torch.Tensor | None = None, *,
                  transposed: bool = False) -> torch.Tensor:
    """``x (M, K) @ (w * mask) (K, N) + b (N,) -> (M, N)``; with
    ``transposed``, ``w`` and ``mask`` are (N, K) and the product is ``x @
    (w * mask)^T + b``.

    CUDA tensors launch the kernel :func:`masked_matmul_route` names
    (``launches`` counts every launch, ``launches_by_route`` each route's):
    float32 or bfloat16, one dtype for all operands, contiguous;
    ``transposed`` only on the ``ffma`` route (float32).  CPU tensors run
    :func:`masked_matmul_plain` (``meta`` tensors inside
    ``_device.abstract_run``, the dry-run's, its shapes).  DTensors run
    the kernel on local shards (``parallel.local.matmul_shards``): a
    column-sharded w gives columns, a row-sharded one a partial sum, a
    batch-sharded x rows.
    """
    if any_dtensor(x, w, mask, b):
        return matmul_shards(
            lambda *a: masked_matmul(*a, transposed=transposed),
            x, w, mask, b, transposed=transposed)
    dev = x.device
    if plain_device(dev):
        return masked_matmul_plain(x, w, mask, b, transposed=transposed)
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
    w_k, n_dim = w.shape[::-1] if transposed else w.shape
    if w_k != k_dim or mask.shape != w.shape:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and mask "
                         f"{tuple(mask.shape)} do not chain"
                         + (" (w and mask as (N, K))" if transposed else ""))
    if b is not None and b.shape != (n_dim,):
        raise ValueError(f"b has shape {tuple(b.shape)}; expected ({n_dim},)")
    route = masked_matmul_route(x.dtype, k_dim, n_dim)
    if transposed and route != "ffma":
        raise ValueError(f"transposed operands run on the ffma route "
                         f"(float32) only, not on {route} ({x.dtype})")
    if route == "ffma":
        ffma_grid(m_dim, k_dim, n_dim)
    if route == "simt" and -(-n_dim // _TILE_N) > _MAX_GRID_Y:
        raise ValueError(f"N = {n_dim} exceeds the kernel's grid "
                         f"({_MAX_GRID_Y} tiles of {_TILE_N})")
    if route == "wgmma" and (-(-m_dim // _WGMMA_TILE[0])
                             * -(-n_dim // _WGMMA_TILE[1])) > _MAX_GRID_X:
        raise ValueError(f"({m_dim}, {n_dim}) exceeds the kernel's grid "
                         f"({_MAX_GRID_X} tiles of {_WGMMA_TILE})")
    out = torch.empty((m_dim, n_dim), dtype=x.dtype, device=dev)
    if m_dim == 0 or n_dim == 0:
        return out
    if route == "ffma":
        _launch_ffma(x, w, mask, b, out, transposed)
    elif route == "wgmma":
        _launch_wgmma(x, w, mask, b, out)
    else:
        _launch_simt(x, w, mask, b, out)
    masked_matmul.launches += 1
    masked_matmul.launches_by_route[route] += 1
    return out


masked_matmul.launches = 0
masked_matmul.launches_by_route = {"simt": 0, "wgmma": 0, "ffma": 0}


class MaskedMatmulFn(torch.autograd.Function):
    """Differentiable ``x @ (w * mask) + b``.

    Only the gradients in ``ctx.needs_input_grad`` are computed, so a first
    layer whose input is data launches no ``dx`` kernel, and a mask that
    does not require grad (model A's, MNIST's) gets none.  A mask that
    does gets ``(x^T @ dy) * w``, the derivative of the product the
    reference differentiates (``xq @ (w * mask)``): the LM's masks are
    parameters whose gradient counts in the clipped global norm, though
    AdamW never updates them.
    """

    @classmethod
    def apply(cls, x, w, mask, b=None):
        """On DTensors, the function itself (forward and backward, so
        every product a kernel launch) runs on local shards
        (``parallel.local.matmul_shards``)."""
        if any_dtensor(x, w, mask, b):
            def local(*args):
                return super(MaskedMatmulFn, cls).apply(*args)
            return matmul_shards(local, x, w, mask, b)
        if b is None:
            return super().apply(x, w, mask)
        return super().apply(x, w, mask, b)

    @staticmethod
    def forward(ctx, x, w, mask, b=None):
        ctx.save_for_backward(x, w, mask)
        return masked_matmul(x, w, mask, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, mask = ctx.saved_tensors
        dy = dy.contiguous()
        n_in = len(ctx.needs_input_grad)
        need_x, need_w, need_mask, need_b = (*ctx.needs_input_grad, False)[:4]
        dx = dw = dmask = db = None
        if need_x:
            if masked_matmul_route(dy.dtype, w.shape[1], w.shape[0]) == "ffma":
                dx = masked_matmul(dy, w, mask, transposed=True)
            else:
                dx = masked_matmul(dy, w.t().contiguous(),
                                   mask.t().contiguous())
        if need_w or need_mask:
            g = x.t() @ dy
            dw = g * mask if need_w else None
            dmask = g * w if need_mask else None
        if need_b:
            db = dy.sum(0)
        return (dx, dw, dmask, db)[:n_in]


def logicnet_ffn_route(device_type: str, dtype: torch.dtype, k: int, n: int,
                       bit_width: int, act_fn: str, *, dtensor: bool,
                       needs_grad: bool) -> str:
    """Which path a LogicNet-FFN's ``wi`` stage takes, from its operands'
    device type and dtype, ``w_gate``'s (K, N), the quantizer's bit width,
    the activation, whether an operand is a DTensor and whether a gradient
    is to be taken (grad enabled and an operand requires it):
    ``"fused"`` (:func:`quant_relu`, then
    :func:`masked_matmul_swiglu_quant`) for bfloat16 on CUDA on the
    ``wgmma`` route of :func:`masked_matmul_route`, a QuantReLU
    (``bit_width >= 2``), SiLU, no DTensor and no gradient; else
    ``"composed"``: the quantizers and the two masked products of
    :class:`MaskedMatmulFn` one by one, whose backward training needs."""
    fused = (device_type == "cuda" and not dtensor and not needs_grad
             and masked_matmul_route(dtype, k, n) == "wgmma"
             and bit_width >= 2 and act_fn == "silu")
    return "fused" if fused else "composed"


def quant_relu_plain(x: torch.Tensor, q: QuantizerCfg) -> torch.Tensor:
    """Plain-torch version: ``quantize(q, x)``'s forward value in float32,
    returned in ``x``'s dtype."""
    # imported here: repro_torch.core imports this module
    from repro_torch.core.quantize import quantize
    return quantize(q, x.float()).value.to(x.dtype)


def quant_relu(x: torch.Tensor, q: QuantizerCfg) -> torch.Tensor:
    """The QuantReLU's forward value of ``x`` (``q.bit_width >= 2``), in
    ``x``'s dtype.  CUDA tensors: bfloat16, contiguous, one
    ``quant_relu_bf16_forward`` launch (``quant_relu.launches``); CPU
    tensors (``meta`` inside ``_device.abstract_run``) run
    :func:`quant_relu_plain`."""
    dev = x.device
    if plain_device(dev):
        return quant_relu_plain(x, q)
    if dev.type != "cuda":
        raise ValueError(f"quant_relu runs on cuda or cpu, not {dev}")
    if q.bit_width < 2:
        raise ValueError(f"quant_relu is the QuantReLU (bit_width >= 2), "
                         f"not bit_width {q.bit_width}")
    require(x, "x", (torch.bfloat16,), x.dim(), dev)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.data_ptr() % _TMA_ALIGN:
        x = x.clone()
    with torch.cuda.device(dev):
        err = _build.library().quant_relu_bf16_forward(
            x.data_ptr(), x.numel(), q.max_val, q.step, out.data_ptr(),
            stream_of(dev))
    _build.check(err, "quant_relu_bf16_forward")
    quant_relu.launches += 1
    return out


quant_relu.launches = 0


def masked_matmul_swiglu_quant_plain(x: torch.Tensor, w_gate: torch.Tensor,
                                     w_up: torch.Tensor, mask: torch.Tensor,
                                     q: QuantizerCfg) -> torch.Tensor:
    """Plain-torch version: ``Q(silu(x @ (w_gate * mask)) * (x @ (w_up *
    mask)))``, each product from :func:`masked_matmul_plain`, SiLU and the
    product in ``x``'s dtype, ``Q`` by :func:`quant_relu_plain`."""
    h = (F.silu(masked_matmul_plain(x, w_gate, mask))
         * masked_matmul_plain(x, w_up, mask))
    return quant_relu_plain(h, q)


def masked_matmul_swiglu_quant(x: torch.Tensor, w_gate: torch.Tensor,
                               w_up: torch.Tensor, mask: torch.Tensor,
                               q: QuantizerCfg) -> torch.Tensor:
    """``Q(silu(x (M, K) @ (w_gate * mask)) * (x @ (w_up * mask))) -> (M,
    N)``: the LogicNet-FFN's ``wi`` stage, ``Q`` the QuantReLU ``q``
    (``bit_width >= 2``).

    CUDA tensors: bfloat16, contiguous, K and N multiples of 8 (the
    ``wgmma`` route); one ``masked_matmul_swiglu_quant_wgmma_forward``
    launch (``launches``, ``launches_by_route``), equal bit for bit to the
    composed path on the card (the two products by :func:`masked_matmul`,
    then ``F.silu``, the product and ``core.quantize``).  CPU tensors
    (``meta`` inside ``_device.abstract_run``) run
    :func:`masked_matmul_swiglu_quant_plain`.  No gradient:
    :func:`logicnet_ffn_route` sends only calls without one here."""
    dev = x.device
    if plain_device(dev):
        return masked_matmul_swiglu_quant_plain(x, w_gate, w_up, mask, q)
    if dev.type != "cuda":
        raise ValueError(f"masked_matmul_swiglu_quant runs on cuda or cpu, "
                         f"not {dev}")
    dtypes = (torch.bfloat16,)
    require(x, "x", dtypes, 2, dev)
    require(w_gate, "w_gate", dtypes, 2, dev)
    require(w_up, "w_up", dtypes, 2, dev)
    require(mask, "mask", dtypes, 2, dev)
    (m_dim, k_dim), n_dim = x.shape, mask.shape[1]
    if mask.shape[0] != k_dim or w_gate.shape != mask.shape \
            or w_up.shape != mask.shape:
        raise ValueError(f"x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)} and mask "
                         f"{tuple(mask.shape)} do not chain")
    if masked_matmul_route(x.dtype, k_dim, n_dim) != "wgmma":
        raise ValueError(f"K = {k_dim} and N = {n_dim} must be multiples "
                         f"of 8 (the wgmma route)")
    if q.bit_width < 2:
        raise ValueError(f"the quantizer is the QuantReLU (bit_width >= "
                         f"2), not bit_width {q.bit_width}")
    if (-(-m_dim // _SWIGLU_TILE[0]) * -(-n_dim // _SWIGLU_TILE[1])
            > _MAX_GRID_X):
        raise ValueError(f"({m_dim}, {n_dim}) exceeds the kernel's grid "
                         f"({_MAX_GRID_X} tiles of {_SWIGLU_TILE})")
    out = torch.empty((m_dim, n_dim), dtype=x.dtype, device=dev)
    if m_dim == 0 or n_dim == 0:
        return out
    x, w_gate, w_up, mask = (t if t.data_ptr() % _TMA_ALIGN == 0
                             else t.clone() for t in (x, w_gate, w_up, mask))
    with torch.cuda.device(dev):
        err = _build.library().masked_matmul_swiglu_quant_wgmma_forward(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            mask.data_ptr(), m_dim, n_dim, k_dim, q.max_val, q.step,
            out.data_ptr(), stream_of(dev))
    _build.check(err, "masked_matmul_swiglu_quant_wgmma_forward")
    masked_matmul_swiglu_quant.launches += 1
    masked_matmul_swiglu_quant.launches_by_route["wgmma"] += 1
    return out


masked_matmul_swiglu_quant.launches = 0
masked_matmul_swiglu_quant.launches_by_route = {"wgmma": 0}
