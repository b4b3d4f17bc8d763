"""The port's flash-attention wrapper and plain version against the reference.

``flash_attention_plain`` (what the wrapper runs on CPU tensors) is held
against the Pallas ``flash_attention_pallas`` run in interpret mode, as the
reference's own tests run it on the CPU, on every case of
``tests/test_kernels.py``'s flash-attention tests and at sizes that cross
the port kernel's 64-row tiles.  The same seeded numpy inputs go to both.
Tolerances are the reference tests': float32 atol 2e-5 / rtol 1e-4 (the
Pallas kernel's online softmax against a dense softmax: another summation
order), bfloat16 atol 3e-2 (both round a float32 result to bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

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
