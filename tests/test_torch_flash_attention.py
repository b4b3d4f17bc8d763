"""The port's flash-attention wrapper and plain version against the reference.

``flash_attention_plain`` (what the wrapper runs on CPU tensors) is held
against the Pallas ``flash_attention_pallas`` run in interpret mode, as the
reference's own tests run it on the CPU, on every case of
``tests/test_kernels.py``'s flash-attention tests and at sizes that cross
the port kernel's 64-row tiles.  The same seeded numpy inputs go to both.
Tolerances are the reference tests': float32 atol 2e-5 / rtol 1e-4 (the
Pallas kernel's online softmax against a dense softmax: another summation
order), bfloat16 atol 3e-2 (both round a float32 result to bfloat16).
The rule that picks the CUDA kernel (``flash_attention_route``) and the
strides the tensor-core routes hand to TMA and ``cp.async`` are checked as
pure functions; strided (B, H, S, D) views, as the LM passes them, give
exactly what contiguous copies give.  A plain-torch emulation of the
float32 tensor-core route's arithmetic (each product as three TF32
products on a big + small split of both operands) stays within the
card's float32 tolerance of the plain version, where one TF32 product
does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels.flash_attention import (_tma_view, flash_attention,
                                                 flash_attention_plain,
                                                 flash_attention_route)

F32_TOL = {"atol": 2e-5, "rtol": 1e-4}


def _qkv(b, hq, hkv, s, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _both(arrays, block=32, **kw):
    want = flash_attention_pallas(*(jnp.asarray(a) for a in arrays),
                                  block_q=block, block_k=block,
                                  interpret=True, **kw)
    got = flash_attention_plain(*(torch.from_numpy(np.asarray(a, np.float32))
                                  for a in arrays), **kw)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 64, 16),       # MHA
    (2, 4, 2, 96, 32),       # GQA, non-divisible seq vs block
    (1, 8, 1, 128, 16),      # MQA
    (2, 4, 4, 250, 8),       # ragged seq
    (1, 4, 2, 65, 16),       # one row past the port kernel's 64-row tile
    (1, 2, 1, 130, 32),      # two tiles and a ragged third
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas(b, hq, hkv, s, d, causal):
    got, want = _both(_qkv(b, hq, hkv, s, d, seed=s + hq), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, hq, s, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("window,causal,s", [(16, True, 128), (64, True, 128),
                                             (1024, True, 128),
                                             (16, False, 130),
                                             (100, True, 130)])
def test_plain_matches_pallas_sliding_window(window, causal, s):
    got, want = _both(_qkv(1, 2, 2, s, 16, seed=7), causal=causal,
                      window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_plain_matches_pallas_bf16():
    arrays = _qkv(1, 2, 2, 64, 32, seed=3, dtype=jnp.bfloat16)
    want = flash_attention_pallas(*(jnp.asarray(a) for a in arrays),
                                  causal=True, block_q=32, block_k=32,
                                  interpret=True)
    got = flash_attention_plain(*(torch.from_numpy(a.astype(np.float32))
                                  .bfloat16() for a in arrays), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


def test_plain_scale_and_row_blocks_change_nothing(monkeypatch):
    """An explicit scale is the reference's; the plain version's query-row
    blocks (which bound its score memory at long sequences) give the same
    rows as one block."""
    import repro_torch.kernels.flash_attention as FA
    arrays = _qkv(1, 4, 2, 96, 16, seed=11)
    got, want = _both(arrays, causal=True, window=40, scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    monkeypatch.setattr(FA, "_PLAIN_BLOCK_ELEMS", 4 * 96 * 7)
    blocked = FA.flash_attention_plain(*(torch.from_numpy(a) for a in arrays),
                                       causal=True, window=40, scale=0.3)
    torch.testing.assert_close(blocked, got, atol=0, rtol=0)


def test_wrapper_runs_plain_on_cpu_without_launching():
    arrays = [torch.from_numpy(a) for a in _qkv(2, 4, 2, 33, 8, seed=1)]
    before = flash_attention.launches
    got = flash_attention(*arrays, causal=True)
    assert flash_attention.launches == before
    torch.testing.assert_close(got, flash_attention_plain(*arrays),
                               atol=0, rtol=0)


@pytest.mark.parametrize("shapes,kw,match", [
    (((1, 3, 8, 4), (1, 2, 8, 4)), {}, "Hq % Hkv"),
    (((1, 2, 8, 4), (1, 2, 9, 4)), {}, "do not match"),
    (((2, 8, 4), (2, 8, 4)), {}, "expected"),
    (((1, 2, 8, 4), (1, 2, 8, 4)), {"window": 0}, "window"),
])
def test_wrapper_refuses_bad_shapes_and_window_zero(shapes, kw, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k.clone(), **kw)


def test_wrapper_refuses_devices_it_cannot_run_on():
    meta = torch.empty((1, 2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(meta, meta, meta)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 200, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 12, "simt"),
    (torch.bfloat16, 6, "simt"), (torch.bfloat16, 264, "simt"),
    (torch.float32, 128, "tf32x3"), (torch.float32, 8, "tf32x3"),
    (torch.float32, 6, "simt"), (torch.float32, 264, "simt"),
    (torch.float16, 128, "simt")])
def test_route_rule(dtype, d, route):
    """D % 8 == 0 (up to 256) goes to a tensor-core kernel, bfloat16 to
    wgmma and float32 to tf32x3; every other head_dim to the SIMT
    kernel."""
    assert flash_attention_route(dtype, d) == route


def test_tma_view_keeps_strided_views_and_fixes_size_one_dims():
    """The transpose of a (B, S, H, D) tensor is handed to TMA as it is,
    with its (batch, head, seq) strides; a dimension of size 1 gets its
    contiguous stride (it is never stepped); a stride TMA cannot take (not
    a multiple of 16 bytes) gets a contiguous copy."""
    t = torch.zeros((2, 300, 8, 128), dtype=torch.bfloat16).transpose(1, 2)
    view, strides = _tma_view(t)
    assert view is t and strides == [300 * 8 * 128, 128, 8 * 128]
    one = torch.zeros((1, 16, 4, 8), dtype=torch.bfloat16).transpose(1, 2)
    assert _tma_view(one)[1] == [4 * 16 * 8, 8, 4 * 8]
    odd = torch.zeros((2, 5, 3, 12), dtype=torch.bfloat16)[..., :8]
    view, strides = _tma_view(odd.transpose(1, 2))
    assert view.is_contiguous() and strides == [3 * 5 * 8, 5 * 8, 8]
    torch.testing.assert_close(view, odd.transpose(1, 2), atol=0, rtol=0)
    # float32: 16-byte strides are multiples of 4 elements
    f32 = torch.zeros((2, 300, 8, 128)).transpose(1, 2)
    view, strides = _tma_view(f32)
    assert view is f32 and strides == [300 * 8 * 128, 128, 8 * 128]
    odd = torch.zeros((2, 5, 3, 10))[..., :8].transpose(1, 2)
    view, strides = _tma_view(odd)
    assert view.is_contiguous() and strides == [3 * 5 * 8, 5 * 8, 8]


def test_route_counters_exist_and_cpu_counts_nothing():
    before = dict(flash_attention.launches_by_route)
    assert set(before) == {"simt", "wgmma", "tf32x3"}
    arrays = [torch.from_numpy(a).bfloat16()
              for a in _qkv(1, 2, 2, 16, 8, seed=2)]
    flash_attention(*arrays)
    assert flash_attention.launches_by_route == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
def test_plain_on_strided_views_matches_contiguous(dtype, window):
    """q, k and v as the (B, H, S, D) transposes of (B, S, H, D) tensors
    (what ``attn_apply`` passes) give exactly what contiguous copies give,
    through the plain version and the wrapper on the CPU."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype).transpose(1, 2)
               for shape in ((2, 70, 4, 16), (2, 70, 2, 16), (2, 70, 2, 16)))
    assert not q.is_contiguous()
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True, window=window)
    for fn in (flash_attention_plain, flash_attention):
        torch.testing.assert_close(fn(q, k, v, causal=True, window=window),
                                   want, atol=0, rtol=0)


# FA_TOL["float32"] of chip_smoke.py and FLASH_TOL of test_torch_cuda.py:
# the float32 routes on the card against the plain version
CARD_F32_TOL = (1e-5, 1e-5)


def _tf32(x: torch.Tensor, rounding: str = "rna") -> torch.Tensor:
    """x as a TF32 value (10 mantissa bits): ``"rna"`` to nearest, ties away
    from zero (the ``cvt.rna`` rule on the float32 bits, as the kernel
    rounds big), ``"toward_zero"`` its top 19 bits (what ``mma`` reads of
    an operand that is not TF32, as the kernel passes small)."""
    bits = x.view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_product(eq, a, b, products, small="toward_zero"):
    """einsum ``eq`` of float32 a and b as the tensor cores take it: one
    TF32 product, or three on big + small splits (small_a big_b +
    big_a small_b + big_a big_b, the small x small term dropped), small =
    x - big rounded by ``small``."""
    ab, bb = _tf32(a), _tf32(b)
    if products == 1:
        return torch.einsum(eq, ab, bb)
    a_s, b_s = _tf32(a - ab, small), _tf32(b - bb, small)
    return (torch.einsum(eq, a_s, bb) + torch.einsum(eq, ab, b_s)
            + torch.einsum(eq, ab, bb))


def _tf32_attention(q, k, v, products, causal=True, window=None,
                    small="toward_zero"):
    """The dense masked softmax with both of its products (S = Q K^T and
    P V) in TF32, P unnormalised and divided by its row sums at the end,
    as the kernel does; everything else float32."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    logits = _tf32_product("bhqd,bhkd->bhqk", q, kq, products,
                           small) / d ** 0.5
    pos = torch.arange(s)
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = _tf32_product("bhqk,bhkd->bhqd", p, vq, products, small)
    return out / p.sum(dim=-1, keepdim=True)


# phase 7's float32 cases (chip_smoke.py), but its (4, 16, 8, 2048, 128)
# prefill shape (a 1 GiB score block on the CPU: the card checks it), and
# (1, 4, 2, 512, 128) causal at qwen3-1.7b's head_dim
_TF32_CASES = [((b, hq, hkv, s, d), dict(causal=c))
               for b, hq, hkv, s, d in ((1, 2, 2, 64, 16), (2, 4, 2, 96, 32),
                                        (1, 8, 1, 128, 16), (2, 4, 4, 250, 8))
               for c in (True, False)]
_TF32_CASES += [((1, 2, 2, 128, 16), dict(causal=True, window=w))
                for w in (16, 64, 1024)]
_TF32_CASES += [((1, 4, 2, 1000, 64), dict(causal=True)),
                ((1, 16, 8, 1000, 128), dict(causal=False)),
                ((1, 4, 2, 512, 128), dict(causal=True))]


@pytest.mark.parametrize("small", ["toward_zero", "rna"])
@pytest.mark.parametrize("shape,kw", _TF32_CASES)
def test_three_tf32_products_are_float32_accurate(shape, kw, small):
    """Three TF32 products a product (the tf32x3 route's arithmetic, small
    rounded toward zero as the kernel's mma reads it, or to nearest) stay
    within the card's float32 tolerance of the plain version; one TF32
    product a product exceeds it.  So three are needed, and enough."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(*shape, seed=sum(shape)))
    want = flash_attention_plain(q, k, v, **kw)
    atol, rtol = CARD_F32_TOL
    limit = atol + rtol * want.abs()
    ratio = {n: float(((_tf32_attention(q, k, v, n, small=small, **kw)
                        - want).abs() / limit).max()) for n in (1, 3)}
    print(f"{shape} {kw}, small {small}: max |emulation - plain| over the "
          f"float32 limit: three products {ratio[3]:.3g}, one product "
          f"{ratio[1]:.3g}")
    assert ratio[3] <= 1, ratio
    assert ratio[1] > 1, ratio
