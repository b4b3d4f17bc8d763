"""Training attention's flash route on the CPU: the route rule, the plain
transcription of the backward kernels' arithmetic, and the chunked path
left as it was.

``attn_train_route`` is checked as a pure function over the inputs the
zoo's training calls show.  ``flash_attention_train_plain`` and
``flash_attention_backward_plain`` (the arithmetic of
``csrc/flash_attention_wgmma{,_bwd}.cu``: P recomputed from the row
log-sum-exp, D = rowsum(dO o O)) are held at float64 inputs to autograd
through a dense float64 softmax attention at rtol 1e-10 / atol 1e-12 (the
same function in float64, summed in another order: the two differ by
float64 rounding, some 1e-15 of the gradients' size), and to autograd
through ``models.attention._chunked_attention`` (chunks of 16 keys where
16 divides the length, else one chunk, where it computes the true
function) at rtol 2e-5 / atol 2e-6: the chunked form casts to float32
whatever its inputs, so the two differ by float32 rounding, a few 1e-7 of
the outputs' and gradients' size.  ``FlashAttentionFn`` on CPU tensors passes
``torch.autograd.gradcheck``.  A plain emulation of the kernels' split
(P and dS as hi + lo bfloat16 halves, exact products summed in float32)
stays within float32-class error of the float64 gradients, where P and
dS rounded to bfloat16 alone do not.  ``attn_apply(train=True)`` on the
CPU takes the chunked path and gives its bits exactly.  A training call
that needs no gradient is the prefill entry's, with no graph.
"""

import dataclasses

import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, attn_train_route, flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain, flash_attention_train,
    flash_attention_train_plain)
from repro_torch.models import attention as A
from repro_torch.parallel.local import contract_heads

F64_TOL = {"rtol": 1e-10, "atol": 1e-12}
F32_TOL = {"rtol": 2e-5, "atol": 2e-6}
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,seq,chunk,window,device,want", [
    (BF, 128, 2048, 1024, 0, "cuda", "flash"),       # qwen3's training
    (BF, 224, 2048, 1024, 0, "cuda", "flash"),       # zamba2-7b's blocks
    (BF, 80, 2048, 1024, 0, "cuda", "flash"),        # zamba2-2.7b
    (BF, 12, 2048, 1024, 0, "cuda", "chunked"),      # not a multiple of 8
    (BF, 264, 2048, 1024, 0, "cuda", "chunked"),     # past 256
    (BF, 128, 2048, 2048, 0, "cuda", "flash"),       # one chunk
    (BF, 128, 512, 1024, 0, "cuda", "flash"),        # shorter than a chunk
    (BF, 64, 1500, 1024, 0, "cuda", "chunked"),      # whisper: ragged chunk
    (BF, 128, 2048, 1024, 1024, "cuda", "chunked"),  # gemma3's local layers
    (F32, 128, 2048, 1024, 0, "cuda", "chunked"),    # float32 training
    (F32, 64, 1500, 1024, 0, "cuda", "chunked"),     # whisper's encoder
    (F32, 224, 2048, 1024, 0, "cuda", "chunked"),
    (BF, 128, 2048, 1024, 0, "cpu", "chunked"),
    (BF, 128, 2048, 1024, 0, "meta", "chunked"),     # the dry-run's shapes
    (F32, 80, 2048, 1024, 0, "cpu", "chunked"),
])
def test_attn_train_route_table(dtype, d, seq, chunk, window, device, want):
    assert attn_train_route(dtype, d, seq, seq, chunk, window,
                            device) == want


@pytest.mark.parametrize("seq,seq_kv", [(1, 2048), (5, 40), (2048, 1500)])
def test_attn_train_route_keeps_unequal_lengths_chunked(seq, seq_kv):
    assert attn_train_route(BF, 128, seq, seq_kv, 1024, 0,
                            "cuda") == "chunked"


def _inputs(b, hq, hkv, s, d, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                          (b, hq, s, d))]


def _chunked_grads(q, k, v, do, causal, scale):
    """Output and (dq, dk, dv) by autograd through the chunked form, in
    the kernels' (B, H, S, D) layout, at a chunk that computes the true
    function."""
    s = q.shape[2]
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = A._chunked_attention(qs, ks, vs, q_offset=0, window=0,
                               causal=causal, chunk=16 if s % 16 == 0 else s,
                               scale=scale)
    out.backward(do.transpose(1, 2))
    return (out.detach().transpose(1, 2),
            *(t.grad.transpose(1, 2) for t in (qs, ks, vs)))


def _scores(q, k, causal, scale):
    hq, s, d = q.shape[1:]
    sc = torch.einsum("bhqd,bhkd->bhqk", q,
                      k.repeat_interleave(hq // k.shape[1], 1))
    sc = sc * (d ** -0.5 if scale is None else scale)
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                            float("-inf"))
    return sc


def _dense_grads(q, k, v, do, causal, scale):
    """Output and (dq, dk, dv) by autograd through a dense softmax
    attention in the inputs' dtype."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    p = torch.softmax(_scores(qs, ks, causal, scale), -1)
    out = torch.einsum("bhqk,bhkd->bhqd", p,
                       vs.repeat_interleave(q.shape[1] // k.shape[1], 1))
    out.backward(do)
    return (out.detach(), *(t.grad for t in (qs, ks, vs)))


CASES = [  # b, hq, hkv, s, d, causal, scale
    (2, 4, 2, 48, 16, True, None),       # GQA: 4 query heads over 2
    (1, 3, 3, 40, 56, True, None),       # MHA, head_dim 56
    (2, 4, 2, 48, 16, False, None),      # unmasked
    (1, 2, 2, 32, 56, True, 112 ** -0.5),  # zamba2's kind of scale
    (1, 4, 1, 33, 16, True, 0.3),        # MQA, a ragged length
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,scale", CASES)
def test_plain_forward_matches_chunked_in_float64(b, hq, hkv, s, d, causal,
                                                  scale):
    q, k, v, do = _inputs(b, hq, hkv, s, d, seed=s + d)
    out, lse, o32 = flash_attention_train_plain(q, k, v, causal=causal,
                                                scale=scale)
    torch.testing.assert_close(
        out, _dense_grads(q, k, v, do, causal, scale)[0], **F64_TOL)
    torch.testing.assert_close(
        out, _chunked_grads(q, k, v, do, causal, scale)[0], **F32_TOL)
    assert torch.equal(out, o32)                     # float64 throughout
    torch.testing.assert_close(
        lse, torch.logsumexp(_scores(q, k, causal, scale), -1), **F64_TOL)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,scale", CASES)
def test_plain_backward_matches_chunked_autograd_in_float64(
        b, hq, hkv, s, d, causal, scale):
    q, k, v, do = _inputs(b, hq, hkv, s, d, seed=10 * s + d)
    _, lse, o32 = flash_attention_train_plain(q, k, v, causal=causal,
                                              scale=scale)
    got = flash_attention_backward_plain(q, k, v, o32, lse, do,
                                         causal=causal, scale=scale)
    dense = _dense_grads(q, k, v, do, causal, scale)[1:]
    chunked = _chunked_grads(q, k, v, do, causal, scale)[1:]
    for g, w, c in zip(got, dense, chunked):
        assert g.dtype == torch.float64 and g.shape == w.shape
        torch.testing.assert_close(g, w, **F64_TOL)
        torch.testing.assert_close(g, c, **F32_TOL)


def test_backward_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v, do = _inputs(1, 4, 2, 24, 16, seed=3)
    _, lse, o32 = flash_attention_train_plain(q, k, v)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, o32, lse, do)
    assert flash_attention_backward.launches == before
    for g, w in zip(got, flash_attention_backward_plain(q, k, v, o32, lse,
                                                        do)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_passes_gradcheck(causal):
    q, k, v, _ = _inputs(1, 4, 2, 10, 8, seed=5)
    args = [t.requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionFn.apply(a, b, c, causal, 0.4),
        args, eps=1e-6, atol=1e-8)


def test_flash_attention_train_refuses_unequal_lengths():
    q, k, v, _ = _inputs(1, 2, 2, 8, 8, seed=1)
    with pytest.raises(ValueError, match="self-attention"):
        flash_attention_train(q, k[:, :, :4], v[:, :, :4], causal=False)


@pytest.mark.parametrize("leaves,grad_mode,graph", [
    (False, True, False),      # no input requires grad
    (True, False, False),      # under torch.no_grad()
    (True, True, True)])       # the training call
def test_flash_attention_train_keeps_a_graph_only_for_a_gradient(
        leaves, grad_mode, graph):
    """A call that needs no gradient is the prefill entry's (no graph, no
    log-sum-exp kept), with the same output as the training call's."""
    q, k, v, _ = _inputs(1, 4, 2, 24, 16, seed=9)
    args = [t.float().requires_grad_(leaves) for t in (q, k, v)]
    with torch.set_grad_enabled(grad_mode):
        out = flash_attention_train(*args, causal=True, scale=0.3)
    with torch.no_grad():
        want = flash_attention(*args, causal=True, scale=0.3)
    assert torch.equal(out, want)
    assert (type(out.grad_fn).__name__ == "FlashAttentionFnBackward") == graph
    assert (out.grad_fn is None) != graph


def _round_bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _split(x):
    """hi + lo bfloat16 halves of a float32 tensor, as the kernels split
    P and dS."""
    hi = _round_bf16(x)
    return hi, _round_bf16(x - hi)


def _emulated_dv(q, k, do, lse, scale, split: bool):
    """The kernels' dV = P^T dO with bfloat16 q, k, dO: exact products
    summed in float32, P (float32) entering as hi + lo (or rounded)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.exp(s * scale - lse[..., None])
    p = p.masked_fill(torch.ones(s.shape[-1], s.shape[-1],
                                 dtype=torch.bool).triu(1), 0.0)
    hi, lo = _split(p) if split else (_round_bf16(p), torch.zeros_like(p))
    return (torch.einsum("bhqk,bhqd->bhkd", hi, do.float())
            + torch.einsum("bhqk,bhqd->bhkd", lo, do.float()))


def test_the_hi_lo_split_keeps_float32_accuracy_where_rounding_does_not():
    """dV at bfloat16 inputs against float64: the kernels' split lands
    within 1e-5 of the largest element (float32 sums of 64 terms),
    rounding P to bfloat16 alone misses by over ten times more."""
    q, k, v, do = (t.to(torch.bfloat16) for t in
                   _inputs(1, 2, 2, 64, 32, seed=11))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    _, lse, _ = flash_attention_train_plain(q64, k64, v64)
    want = flash_attention_backward_plain(
        q64, k64, v64, flash_attention_train_plain(q64, k64, v64)[2], lse,
        do64)[2]
    scale = 32 ** -0.5
    err = {split: float((_emulated_dv(q, k, do, lse.float(), scale, split)
                         .double() - want).abs().max())
           for split in (True, False)}
    top = float(want.abs().max())
    assert err[True] < 1e-5 * top
    assert err[False] > 10 * err[True]


def _tiny_cfg(dtype: str):
    return dataclasses.replace(get_smoke_config("qwen3-1.7b"), attn_chunk=16,
                               compute_dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_apply_train_on_the_cpu_is_the_chunked_form_bit_for_bit(dtype):
    cfg = _tiny_cfg("float32")
    g = torch.Generator().manual_seed(7)
    p = {k: v.to(dtype) for k, v in A.attn_init(g, cfg).items()}
    x = torch.randn((2, 48, cfg.d_model), generator=g).to(dtype)
    pos = torch.arange(48).expand(2, 48)
    xa, xb = (x.clone().requires_grad_() for _ in range(2))
    before = dict(A.attn_apply.paths)
    got = A.attn_apply(p, cfg, xa, pos, train=True)
    assert A.attn_apply.paths == {"flash": before["flash"],
                                  "chunked": before["chunked"] + 1}
    q, k, v = A._project_qkv(p, cfg, xb, pos)
    want = contract_heads(A._chunked_attention(
        q, k, v, q_offset=0, window=0, causal=True, chunk=cfg.attn_chunk),
        p["wo"])
    assert torch.equal(got, want)
    got.square().sum().backward()
    want.square().sum().backward()
    assert torch.equal(xa.grad, xb.grad)


def test_attn_apply_counts_prefill_calls_as_flash():
    cfg = _tiny_cfg("float32")
    g = torch.Generator().manual_seed(8)
    p = A.attn_init(g, cfg)
    x = torch.randn((1, 16, cfg.d_model), generator=g)
    before = dict(A.attn_apply.paths)
    A.attn_apply(p, cfg, x, torch.arange(16).expand(1, 16))
    assert A.attn_apply.paths == {"flash": before["flash"] + 1,
                                  "chunked": before["chunked"]}
