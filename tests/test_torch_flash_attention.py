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
strides the tensor-core route hands to TMA are checked as pure functions;
strided (B, H, S, D) views, as the LM passes them, give exactly what
contiguous copies give.
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
    (torch.float32, 128, "simt"), (torch.float32, 8, "simt"),
    (torch.float16, 128, "simt")])
def test_route_rule(dtype, d, route):
    """bfloat16 with D % 8 == 0 (up to 256) goes to the tensor-core kernel;
    float32 and every other head_dim to the SIMT kernel."""
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


def test_route_counters_exist_and_cpu_counts_nothing():
    before = dict(flash_attention.launches_by_route)
    assert set(before) == {"simt", "wgmma"}
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
