"""The port's masked matmul against the reference's Pallas kernel.

``masked_matmul`` runs its plain version on CPU tensors; here it runs
beside ``repro.kernels.masked_matmul.masked_matmul_pallas`` in interpret
mode on the same seeded numpy inputs.  Tolerances: float32 atol 1e-5
(products summed in another order), bfloat16 atol 5e-2 and rtol 1e-3 (the
reference's own, ``tests/test_kernels.py``).  ``MaskedMatmulFn``'s
gradients are held against ``jax.grad`` of the reference expression
(atol 1e-5) and checked by ``torch.autograd.gradcheck`` in float64.  The
CUDA kernels themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``); here the rule that picks one of them
(``masked_matmul_route``) and the float32 kernel's tile rule
(``masked_matmul_tile``, ``ffma_grid``) are checked as pure functions, the
plain version on strided views and with the transposed-operand argument
against contiguous or transposed copies (exactly equal), and the input
gradient against the Pallas kernel run on the transposed operands
(``jax.grad`` does not differentiate through ``pallas_call``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro.kernels.masked_matmul import masked_matmul_pallas
from repro_torch.kernels.masked_matmul import (FFMA_TILES, MaskedMatmulFn,
                                               ffma_grid, masked_matmul,
                                               masked_matmul_plain,
                                               masked_matmul_route,
                                               masked_matmul_tile)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(m, k, n, seed, density=0.4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = (rng.random((k, n)) < density).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, w, mask, b


def _both(arrays, dtype):
    jdt, tdt, _ = _DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("m,k,n,blocks", [
    (8, 16, 8, 32), (33, 70, 19, 32), (128, 256, 64, 32), (130, 100, 50, 32),
    (130, 700, 50, None),       # default (128, 128, 512) blocks: a K tail
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(m, k, n, blocks, dtype):
    (jx, jw, jm, jb), (tx, tw, tm, tb) = _both(_inputs(m, k, n, m * n),
                                               dtype)
    kw = {} if blocks is None else dict(block_m=blocks, block_n=blocks,
                                        block_k=blocks)
    want = masked_matmul_pallas(jx, jw, jm, jb, interpret=True, **kw)
    got = masked_matmul(tx, tw, tm, tb)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=_DTYPES[dtype][2], rtol=1e-3)


def test_no_bias_matches_pallas():
    (jx, jw, jm, _), (tx, tw, tm, _) = _both(_inputs(33, 70, 19, 3),
                                             "float32")
    want = masked_matmul_pallas(jx, jw, jm, block_m=32, block_n=32,
                                block_k=32, interpret=True)
    np.testing.assert_allclose(masked_matmul(tx, tw, tm).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-3)


def test_mask_is_exact():
    """Masked-out weights of 1e9 contribute nothing, in both packages."""
    x = np.ones((4, 8), np.float32)
    w = np.full((8, 4), 1e9, np.float32)
    mask = np.zeros((8, 4), np.float32)
    mask[0] = 1.0
    got = masked_matmul(*(torch.from_numpy(a) for a in (x, w, mask)))
    want = masked_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(mask), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 1e9).all()


def test_cpu_tensors_launch_nothing():
    before = masked_matmul.launches
    x, w, mask, b = (torch.from_numpy(a) for a in _inputs(5, 6, 7, 0))
    out = masked_matmul(x, w, mask, b)
    assert torch.equal(out, masked_matmul_plain(x, w, mask, b))
    assert masked_matmul.launches == before


def test_gradients_match_jax_grad():
    """dx, dw and db of ``sum(cot * (x @ (w*mask) + b))`` against JAX."""
    x, w, mask, b = _inputs(33, 70, 19, 7)
    cot = np.random.default_rng(8).standard_normal((33, 19)).astype(
        np.float32)

    def ref(x, w, b):
        return jnp.sum((jnp.dot(x, w * mask) + b) * cot)

    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = MaskedMatmulFn.apply(tx, tw, torch.from_numpy(mask), tb)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, exp in zip((tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5,
                                   rtol=1e-5)
    # masked-out weights get exactly zero gradient
    assert (tw.grad[mask == 0] == 0).all()


def test_only_needed_gradients_are_computed():
    x, w, mask, b = (torch.from_numpy(a) for a in _inputs(6, 5, 4, 1))
    w.requires_grad_()
    MaskedMatmulFn.apply(x, w, mask, b).sum().backward()
    assert w.grad is not None and x.grad is None and b.grad is None
    # without a bias argument the function takes three inputs
    x.requires_grad_()
    MaskedMatmulFn.apply(x, w, mask).sum().backward()
    assert x.grad is not None


def test_gradcheck_float64():
    rng = np.random.default_rng(2)
    x, w, b = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((5, 7), (7, 3), (3,)))
    mask = torch.from_numpy((rng.random((7, 3)) < 0.5).astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda x, w, b: MaskedMatmulFn.apply(x, w, mask, b), (x, w, b))


@pytest.mark.parametrize("dtype,k,n,route", [
    (torch.bfloat16, 4096, 4096, "wgmma"), (torch.bfloat16, 712, 56, "wgmma"),
    (torch.bfloat16, 8, 8, "wgmma"), (torch.bfloat16, 16, 64, "wgmma"),
    (torch.bfloat16, 700, 56, "simt"), (torch.bfloat16, 712, 50, "simt"),
    (torch.bfloat16, 1, 1, "simt"), (torch.bfloat16, 0, 8, "simt"),
    (torch.float32, 4096, 4096, "ffma"), (torch.float32, 64, 64, "ffma"),
    (torch.float32, 700, 50, "ffma"), (torch.float32, 1, 1, "ffma"),
    (torch.float32, 65, 127, "ffma"), (torch.float32, 0, 8, "ffma"),
    (torch.float16, 64, 64, "simt")])
def test_route_rule(dtype, k, n, route):
    """float32 of every shape goes to the CUDA-core ffma kernel; bfloat16
    with K >= 1 and K, N multiples of 8 (TMA's 16-byte strides) to the
    tensor-core kernel; every other shape to the SIMT kernel (M never
    matters)."""
    assert masked_matmul_route(dtype, k, n) == route


@pytest.mark.parametrize("m,k,n,tile", [
    (256, 16, 64, "small"), (256, 64, 64, "small"),   # model A forwards
    (256, 64, 16, "small"),                           # and input gradients
    (130, 700, 50, "small"), (1, 1, 1, "small"), (129, 65, 127, "small"),
    (4096, 4096, 4096, "large"), (1056, 4104, 4096, "large"),
    (1000, 4104, 4096, "small"),                      # 8 x 16 large tiles
    # 12 x 11 = 132 large tiles fill the card's SMs; 12 x 10 do not
    (1536, 64, 2816, "large"), (1536, 64, 2560, "small"),
    # past 65535 columns of 32-wide tiles only the large tile fits grid.y
    (1, 8, 65535 * 32 + 1, "large")])
def test_tile_rule(m, k, n, tile):
    """The large tile where its grid fills the card's 132 SMs (4096^3: 32 x
    16 blocks), else the small one (model A's 256 x 64 x 64: 8 x 2 blocks,
    where the large tile would give 2)."""
    assert masked_matmul_tile(m, k, n) == tile
    bm, bn = FFMA_TILES[tile]
    assert ffma_grid(m, k, n) == (-(-m // bm), -(-n // bn))


def test_ffma_grid_refuses_past_the_grid_limit():
    assert ffma_grid(8, 8, 65535 * 256) == (1, 65535)
    with pytest.raises(ValueError, match="grid"):
        ffma_grid(8, 8, 65535 * 256 + 1)


def test_route_counters_exist_and_cpu_counts_nothing():
    before = dict(masked_matmul.launches_by_route)
    assert set(before) == {"simt", "wgmma", "ffma"}
    x, w, mask, b = (torch.from_numpy(a).bfloat16()
                     for a in _inputs(16, 64, 64, 4))
    masked_matmul(x, w, mask, b)
    assert masked_matmul.launches_by_route == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_on_strided_views_matches_contiguous(dtype):
    """x, w and mask as transposed and sliced views give exactly what their
    contiguous copies give."""
    x, w, mask, b = (torch.from_numpy(a).to(dtype)
                     for a in _inputs(40, 72, 48, 6))
    xv = x.t().contiguous().t()                  # column-major x
    wv = torch.cat([w, w], 1)[:, ::2]            # every other column
    mv = mask.t().contiguous().t()
    assert not (xv.is_contiguous() or wv.is_contiguous()
                or mv.is_contiguous())
    want = masked_matmul_plain(xv.contiguous(), wv.contiguous(),
                               mv.contiguous(), b)
    torch.testing.assert_close(masked_matmul_plain(xv, wv, mv, b), want,
                               atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_transposed_matches_transposed_copies(dtype, with_bias):
    """``transposed=True`` on (N, K) operands gives exactly what the plain
    version gives on their contiguous (K, N) transposes, through the
    wrapper as well (CPU tensors)."""
    x, w, mask, b = (torch.from_numpy(a).to(dtype)
                     for a in _inputs(37, 70, 45, 11))
    wt, mt = w.t().contiguous(), mask.t().contiguous()     # (N, K)
    b = b if with_bias else None
    want = masked_matmul_plain(x, w, mask, b)
    for fn in (masked_matmul_plain, masked_matmul):
        torch.testing.assert_close(fn(x, wt, mt, b, transposed=True), want,
                                   atol=0, rtol=0)


def test_dx_matches_pallas_on_transposed_operands():
    """``MaskedMatmulFn``'s dx (through the transposed read on float32)
    against the Pallas kernel in interpret mode computing dy @ (w *
    mask)^T from transposed copies, atol 1e-5 (another summation order),
    and exactly against the plain version on the copies."""
    x, w, mask, b = _inputs(33, 70, 19, 12)
    cot = np.random.default_rng(13).standard_normal((33, 19)).astype(
        np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    out = MaskedMatmulFn.apply(tx, torch.from_numpy(w),
                               torch.from_numpy(mask), torch.from_numpy(b))
    (out * torch.from_numpy(cot)).sum().backward()
    want = masked_matmul_pallas(jnp.asarray(cot), jnp.asarray(w.T.copy()),
                                jnp.asarray(mask.T.copy()), block_m=32,
                                block_n=32, block_k=32, interpret=True)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    copies = masked_matmul_plain(torch.from_numpy(cot),
                                 torch.from_numpy(w.T.copy()),
                                 torch.from_numpy(mask.T.copy()))
    torch.testing.assert_close(tx.grad, copies, atol=0, rtol=0)
