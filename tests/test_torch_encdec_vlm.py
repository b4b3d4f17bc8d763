"""The port's encoder-decoder (whisper) and M-RoPE / vision-token
(qwen2-vl) families against the reference's, on the CPU.

The reference (``repro.models``) runs under JAX on the CPU; the port
(``repro_torch.models``) runs its plain versions on CPU tensors, the
flash-attention kernel's included.  Models carry the reference's smoke
params from ``lm_smoke_encdec_vlm.npz`` (``tools/make_torch_fixture.py
--only lm_encdec_vlm``; the last test regenerates it and compares), so no
test calls the reference's ``init_params`` at smoke size.  Tolerances:

* layers and attention, float32: atol 2e-5 / rtol 1e-4 (the reference
  tests' own; the same arithmetic in another summation order);
* logits at float32 compute: atol 1e-4 / rtol 1e-4; at bfloat16: atol
  0.05 / rtol 0.05, the reference's own decode-against-forward contract;
* the encoder memory: float32 at either compute dtype, within 1e-4 (float32
  compute) and 0.05 (bfloat16 compute: the encoder's weights are rounded
  to bfloat16 and its arithmetic is float32, as the reference's);
* decode: logits as above at every step; greedy tokens equal at float32,
  and at bfloat16 equal but where the reference's own top two logits lie
  within the 0.05 contract of each other (its bfloat16 logits hold an
  exact tie: qwen2-vl's row 0, step 7, tokens 117 and 241 both 0.443359),
  where the port's token must be one of those near-top ones
  (``chip_smoke.token_disagreements``, the rule phase 8 applies on the
  card).  The port writes the memory's K and V
  with ``write_cross_memory`` and the reference's fixture run with its own
  ``cross_memory``; both round them to the bfloat16 cache, where a value
  near a rounding point may land one step apart;
* the loss at float32 within rtol 1e-6 and its global gradient norm within
  rtol 1e-5; at bfloat16 within 0.05.

Prefill is compared only at lengths the config's ``attn_chunk`` divides
(or below it): where it does not, the reference's chunked attention
mislabels its ragged last chunk (ROADMAP §3.2), and the port's flash path
computes the true softmax; ``test_ragged_chunk_fault_is_the_references``
records that.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from torch_port_util import FIXTURE_DIR, ROOT, one_torch_thread  # noqa: F401

from repro import configs as RC
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro.optim import adamw as RADAM
from repro_torch import configs as PC
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.launch import serve_lm, steps, train
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import global_norm

ARCHS = ("whisper-medium", "qwen2-vl-2b")
DTYPES = ("float32", "bfloat16")
TIGHT = {"atol": 1e-4, "rtol": 1e-4}
BF16 = {"atol": 0.05, "rtol": 0.05}
ATTN = {"atol": 2e-5, "rtol": 1e-4}
TOL = {"float32": TIGHT, "bfloat16": BF16}


@pytest.fixture(scope="module")
def tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (importing it runs nothing)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rules", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx(tool):
    with np.load(os.path.join(FIXTURE_DIR, tool.LM_ENCDEC_VLM_NAME)) as z:
        return {k: z[k] for k in z.files}


def _arrays(fx, arch) -> dict:
    pre = f"{arch}.params."
    return {k[len(pre):]: v for k, v in fx.items() if k.startswith(pre)}


def _ref_params(fx, arch, tool):
    return jax.tree.map(jnp.asarray, tool.unflatten_params(_arrays(fx, arch)))


def _cfgs(arch, compute_dtype="float32", **kw):
    return (dataclasses.replace(RC.get_smoke_config(arch),
                                compute_dtype=compute_dtype, **kw),
            dataclasses.replace(PC.get_smoke_config(arch),
                                compute_dtype=compute_dtype, **kw))


def _model(fx, arch, compute_dtype):
    cfg = _cfgs(arch, compute_dtype)[1]
    return cfg, M.from_reference(cfg, _arrays(fx, arch), device="cpu")


def _batch(fx, arch, text_only=False) -> dict:
    """The fixture's tokens and frontend inputs (bfloat16, as the
    reference got them)."""
    out = {"tokens": torch.from_numpy(fx[f"{arch}.tokens"])}
    if not text_only:
        for key in ("frames", "vision_embeds"):
            if f"{arch}.{key}" in fx:
                out[key] = torch.from_numpy(fx[f"{arch}.{key}"]).bfloat16()
    return out


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rng_qkv(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# M-RoPE and positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,want", [(16, [2, 3, 3]),
                                           (128, [16, 24, 24]),
                                           (64, [8, 12, 12])])
def test_mrope_sections(head_dim, want):
    assert L.mrope_sections(head_dim) == want
    assert sum(want) == head_dim // 2


@pytest.mark.parametrize("theta", [1e6, 1e4])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_reference(head_dim, theta):
    """Three position streams of their own, up to 4096."""
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 24, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 24, 3)).astype(np.int32)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_apply_mrope_with_equal_streams_is_rope():
    x = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(8)[None].expand(1, 8)
    torch.testing.assert_close(
        L.apply_mrope(x, pos[..., None].expand(1, 8, 3), 1e6),
        L.apply_rope(x, pos, 1e6), atol=0, rtol=0)


@pytest.mark.parametrize("seq", [8, 64, 300])
@pytest.mark.parametrize("arch,full", [("qwen2-vl-2b", False),
                                       ("qwen2-vl-2b", True),
                                       ("whisper-medium", False)])
def test_positions_match_reference(arch, full, seq):
    """The M-RoPE stub (vision tokens on a grid at t = 0, text after it in
    all three streams) at the smoke config's 16 and the full config's 256
    vision tokens; plain positions for the others."""
    get = "get_config" if full else "get_smoke_config"
    rcfg, cfg = getattr(RC, get)(arch), getattr(PC, get)(arch)
    tokens = np.zeros((2, seq), np.int32)
    want = np.asarray(RM._positions(rcfg, jnp.asarray(tokens)))
    got = M._positions(cfg, torch.from_numpy(tokens))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# cross-attention and the flash kernel's plain version at Sq != Skv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,hq,hkv", [(1, 32, 4, 4), (7, 64, 4, 2),
                                           (48, 96, 4, 1), (64, 32, 2, 2)])
def test_flash_plain_cross_matches_chunked(sq, skv, hq, hkv):
    """``flash_attention`` (the plain version on the CPU) at Sq != Skv,
    non-causal, against the reference's ``_chunked_attention`` at chunk 32
    (which divides Skv)."""
    q, k, v = _rng_qkv(sq + skv, (2, sq, hq, 16), (2, skv, hkv, 16),
                       (2, skv, hkv, 16))
    want = RA._chunked_attention(q, k, v, q_offset=0, window=0,
                                 causal=False, chunk=32)
    got = flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                            for a in (q, k, v)), causal=False)
    assert tuple(got.shape) == (2, hq, sq, 16)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(want), **ATTN)


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False,
                                                   "window": 4},
                                {"causal": True, "window": 4}])
def test_flash_refuses_masked_cross_shapes(kw):
    """A causal or windowed call needs Sq == Skv (the reference's causal
    mask has no offset), on both devices' paths."""
    q, k = torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 9, 8)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention(q, k, k.clone(), **kw)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention_plain(q, k, k.clone(), **kw)


def _xattn_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, h, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    return {k: (rng.standard_normal(s) / np.sqrt(s[0] if k != "wo"
                                                   else h * hd)
                ).astype(np.float32)
            for k, s in (("wq", (d, h, hd)), ("wk", (d, hkv, hd)),
                         ("wv", (d, hkv, hd)), ("wo", (h, hd, d)))}


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_memory_matches_reference(dtype):
    """K and V of a float32 memory against weights in the compute dtype:
    float32 out, as the reference promotes."""
    rcfg, cfg = _cfgs("whisper-medium", dtype)
    p = _xattn_params(cfg)
    memory = np.random.default_rng(5).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    rp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    want = RA.cross_memory(rp, rcfg, jnp.asarray(memory))
    got = A.cross_memory(tp, cfg, torch.from_numpy(memory))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN)


@pytest.mark.parametrize("train_path", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_apply_matches_reference(dtype, train_path):
    """Queries in the compute dtype against float32 memory K and V (the
    reference's prefill) at 64 keys, a multiple of the chunk: the flash
    path (prefill) and the chunked one (``train``).  Output in the compute
    dtype."""
    rcfg, cfg = _cfgs("whisper-medium", dtype)
    p = _xattn_params(cfg, seed=1)
    x, mk, mv = _rng_qkv(7, (2, 12, cfg.d_model),
                         (2, 64, cfg.n_kv_heads, cfg.resolved_head_dim),
                         (2, 64, cfg.n_kv_heads, cfg.resolved_head_dim))
    rp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    want = RA.cross_attn_apply(rp, rcfg, jnp.asarray(x, dtype),
                               jnp.asarray(mk), jnp.asarray(mv))
    got = A.cross_attn_apply(tp, cfg, torch.from_numpy(x).to(
        getattr(torch, dtype)), torch.from_numpy(mk), torch.from_numpy(mv),
        train=train_path)
    assert got.dtype == getattr(torch, dtype)
    tol = ATTN if dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               **tol)


def test_ragged_chunk_fault_is_the_references():
    """Reference behaviour recorded: at Skv = 40 keys and chunk 32 the
    reference's cross-attention clamps its last chunk to keys 8-39 but
    labels them 32-63, and keeps the labels below 40: so it attends to
    keys 0-31, then to keys 8-15 a second time, and never to 32-39 (at
    whisper-medium's 1500 frames and chunk 1024: keys 0-1023, then
    476-951).  Off the dense softmax, on a softmax over keys 0:32 and
    8:16.
    The port's prefill (the flash path) is the dense softmax; its
    ``train`` path keeps the reference's clamp."""
    rcfg, cfg = _cfgs("whisper-medium", "float32")
    p = _xattn_params(cfg, seed=2)
    x, mk, mv = _rng_qkv(9, (2, 5, cfg.d_model),
                         (2, 40, cfg.n_kv_heads, cfg.resolved_head_dim),
                         (2, 40, cfg.n_kv_heads, cfg.resolved_head_dim))
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ref = np.asarray(RA.cross_attn_apply(rp, rcfg, jnp.asarray(x),
                                         jnp.asarray(mk), jnp.asarray(mv)))
    tx, tk, tv = (torch.from_numpy(a) for a in (x, mk, mv))
    dense = A.cross_attn_apply(tp, cfg, tx, tk, tv).numpy()
    # the dense softmax written out
    q = torch.einsum("bsd,dhe->bshe", tx, tp["wq"])
    att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, tk)
                        / cfg.resolved_head_dim ** 0.5, dim=-1)
    truth = torch.einsum("bhqe,hed->bqd",
                         torch.einsum("bhqk,bkhd->bhqd", att, tv),
                         tp["wo"]).numpy()
    np.testing.assert_allclose(dense, truth, **ATTN)
    assert np.abs(ref - truth).max() > 1e-2
    keys = np.r_[0:32, 8:16]
    mislabeled = A.cross_attn_apply(tp, cfg, tx, tk[:, keys],
                                    tv[:, keys]).numpy()
    np.testing.assert_allclose(ref, mislabeled, **ATTN)
    train_path = A.cross_attn_apply(tp, cfg, tx, tk, tv, train=True).numpy()
    np.testing.assert_allclose(train_path, ref, **ATTN)


# ---------------------------------------------------------------------------
# the smoke models against the fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_memory_is_float32_and_matches_reference(fx, dtype):
    cfg, model = _model(fx, "whisper-medium", dtype)
    w = model.compute_params()
    assert w["pos_emb_enc"].dtype == torch.float32
    assert w["enc_layers"][0]["attn"]["wq"].dtype == getattr(torch, dtype)
    memory = M._forward_encoder(
        cfg, w, _batch(fx, "whisper-medium")["frames"].to(
            getattr(torch, dtype)), M._serve_blocks(cfg)["enc"])
    assert memory.dtype == torch.float32
    np.testing.assert_allclose(memory.numpy(),
                               fx[f"whisper-medium.{dtype}.memory"],
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(fx, arch, dtype):
    """All 64 positions: whisper's decoder over its 16 frames, qwen2-vl's
    16 vision embeddings then text; every attention layer (encoder,
    decoder, cross) one flash launch on the card, the plain version
    here."""
    cfg, model = _model(fx, arch, dtype)
    got = M.forward(model, _batch(fx, arch))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), fx[f"{arch}.{dtype}.prefill"],
                               **TOL[dtype])
    last = steps.make_prefill_step(cfg)(model, _batch(fx, arch))
    np.testing.assert_allclose(_f32(last), _f32(got[:, -1]), atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_forward_without_vision_embeds_matches_reference(fx, dtype):
    """Tokens alone: the first 16 positions keep their token embeddings,
    with the grid positions all the same; the embeddings change the
    logits."""
    _, model = _model(fx, "qwen2-vl-2b", dtype)
    got = M.forward(model, _batch(fx, "qwen2-vl-2b", text_only=True))
    np.testing.assert_allclose(_f32(got),
                               fx[f"qwen2-vl-2b.{dtype}.prefill_text"],
                               **TOL[dtype])
    assert np.abs(fx[f"qwen2-vl-2b.{dtype}.prefill_text"]
                  - fx[f"qwen2-vl-2b.{dtype}.prefill"]).max() > 0.1


def _decode(fx, arch, dtype, cfg, model):
    """The fixture's teacher-forced decode: k / v in the compute dtype,
    whisper's memory written by ``write_cross_memory``."""
    want = fx[f"{arch}.{dtype}.decode"]
    b, n = want.shape[:2]
    cache = M.init_cache(cfg, b, n, device="cpu")
    cache = {k: v.to(getattr(torch, dtype)) if k in ("k", "v") else v
             for k, v in cache.items()}
    if cfg.enc_dec:
        assert cache["mem_k"].dtype == torch.bfloat16
        assert not bool(cache["mem_k"].any())
        M.write_cross_memory(model, cache, _batch(fx, arch)["frames"])
    tokens = torch.from_numpy(fx[f"{arch}.tokens"])
    out = []
    for t in range(n):
        lg, cache = steps.make_decode_step(cfg)(
            model, cache, tokens[:, t:t + 1],
            torch.full((b,), t, dtype=torch.int32))
        out.append(lg)
    return torch.stack(out, 1), cache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(cs, fx, arch, dtype):
    """8 steps, logits and greedy tokens; whisper's cross-attention reads
    the memory's K and V from the cache."""
    cfg, model = _model(fx, arch, dtype)
    got, _ = _decode(fx, arch, dtype, cfg, model)
    want = fx[f"{arch}.{dtype}.decode"]
    np.testing.assert_allclose(_f32(got), want, **TOL[dtype])
    differ, outside = cs.token_disagreements(
        got.float().argmax(-1).numpy(), want,
        fx[f"{arch}.{dtype}.decode_tokens"], **TOL[dtype])
    assert outside == 0
    assert differ == 0 or dtype == "bfloat16"


def test_token_rule_refuses_a_token_off_the_top(cs):
    """A greedy token may differ from the reference's only at a near-tie
    of the reference's logits."""
    want = np.array([[[0.0, 1.0, 0.99], [2.0, 0.0, 0.0]]], np.float32)
    tokens = want.argmax(-1)
    assert cs.token_disagreements(tokens, want, tokens) == (0, 0)
    assert cs.token_disagreements(np.array([[2, 0]]), want, tokens) == (1, 0)
    assert cs.token_disagreements(np.array([[1, 1]]), want, tokens) == (1, 1)
    assert cs.token_disagreements(np.array([[2, 0]]), want, tokens,
                                  atol=1e-4, rtol=1e-4) == (1, 1)


def test_whisper_decode_needs_the_memory(fx):
    """Without ``write_cross_memory`` the cache's memory is zero (as the
    reference's ``init_cache`` leaves it) and the logits differ."""
    cfg, model = _model(fx, "whisper-medium", "float32")
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    lg, _ = M.decode_step(model, cache,
                          torch.from_numpy(fx["whisper-medium.tokens"][:,
                                                                      :1]),
                          torch.zeros((2,), dtype=torch.int32))
    assert np.abs(_f32(lg[:, 0])
                  - fx["whisper-medium.float32.decode"][:, 0]).max() > 1e-2


def test_write_cross_memory_writes_the_slots_given(fx):
    """``rows`` writes those slots from one row of frames each, and only
    them: equal to the whole batch written at once."""
    cfg, model = _model(fx, "whisper-medium", "float32")
    frames = _batch(fx, "whisper-medium")["frames"]
    whole = M.write_cross_memory(model, M.init_cache(cfg, 2, 4, device="cpu"),
                                 frames)
    part = M.init_cache(cfg, 3, 4, device="cpu")
    M.write_cross_memory(model, part, frames[1:], rows=[2])
    M.write_cross_memory(model, part, frames[:1], rows=torch.tensor([0]))
    for key in ("mem_k", "mem_v"):
        torch.testing.assert_close(part[key][:, 0], whole[key][:, 0])
        torch.testing.assert_close(part[key][:, 2], whole[key][:, 1])
        assert not bool(part[key][:, 1].any())
    with pytest.raises(ValueError, match="no encoder"):
        M.write_cross_memory(
            _model(fx, "qwen2-vl-2b", "float32")[1],
            M.init_cache(PC.get_smoke_config("qwen2-vl-2b"), 1, 4,
                         device="cpu"), frames)


def test_mrope_decode_is_at_ppp(fx):
    """Reference behaviour recorded: decode gives position p as (p, p, p)
    in the three M-RoPE streams, prefill as the stub's grid (vision
    positions) or p - 256 + 16 (text), so decode equals prefill at
    position 0 only.  The port decodes as the reference does (the
    fixture's decode logits) and so differs from its own prefill after
    position 0."""
    cfg, model = _model(fx, "qwen2-vl-2b", "float32")
    got, _ = _decode(fx, "qwen2-vl-2b", "float32", cfg, model)
    pre = M.forward(model, _batch(fx, "qwen2-vl-2b", text_only=True))
    n = got.shape[1]
    np.testing.assert_allclose(_f32(got[:, 0]), _f32(pre[:, 0]), **TIGHT)
    assert all(np.abs(_f32(got[:, t]) - _f32(pre[:, t])).max() > 1e-3
               for t in range(1, n))
    tokens = torch.zeros((1, 40), dtype=torch.long)
    pos = M._positions(cfg, tokens)[0]
    assert pos[:16].tolist() == [[0, i // 4, i % 4] for i in range(16)]
    assert pos[16].tolist() == [4, 4, 4]


# ---------------------------------------------------------------------------
# training: the loss, its gradients, the CLI
# ---------------------------------------------------------------------------

def _train_batch(fx, arch) -> dict:
    """The fixture's tokens with next-token labels (the last -1) and its
    frontend inputs."""
    tokens = fx[f"{arch}.tokens"]
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    out = {"tokens": tokens, "labels": labels}
    for key in ("frames", "vision_embeds"):
        if f"{arch}.{key}" in fx:
            out[key] = fx[f"{arch}.{key}"]
    return out


def _flat(tree) -> dict:
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_norm_match_reference(fx, tool, arch, dtype):
    """``loss_fn`` through the differentiable path (chunked attention,
    cross-attention included) and the global gradient norm."""
    rcfg, cfg = _cfgs(arch, dtype)
    batch = _train_batch(fx, arch)
    rbatch = {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
              else jnp.asarray(v) for k, v in batch.items()}
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, rbatch)))(_ref_params(fx, arch, tool))
    model = M.from_reference(cfg, _arrays(fx, arch), device="cpu")
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    tbatch = {k: torch.from_numpy(v).bfloat16() if v.dtype == np.float32
              else torch.from_numpy(v) for k, v in batch.items()}
    loss = M.loss_fn(params, cfg, tbatch)
    grads = torch.autograd.grad(loss, list(params.values()))
    want = float(RADAM.global_norm(rgrads))
    got = float(global_norm(grads))
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(rloss),
                                   rtol=1e-6)
        assert abs(got - want) <= 1e-5 * want
    else:
        np.testing.assert_allclose(float(loss.detach()), float(rloss),
                                   **BF16)
        assert abs(got - want) <= 0.05 * want
    assert len(grads) == sum(
        M.stacked_layers(cfg, n.split(".")[0]) if n.split(".")[0] in
        M._STACKED else 1 for n in _flat(rgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_the_cpu(tmp_path, capsys, arch):
    """``launch.train --arch ... --device cpu``: batches carry zero
    ``frames`` / ``vision_embeds``, as the reference's do."""
    train.main(["--arch", arch, "--size", "smoke", "--device", "cpu",
                "--steps", "3", "--seq", "32", "--global-batch", "2",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"[train] {arch}-smoke: loss " in out and "(cpu)" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_still_refuses(arch):
    """The LM server runs decoder-only archs, as the reference's example
    does."""
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_lm.main(["--arch", arch, "--device", "cpu"])


# ---------------------------------------------------------------------------
# names, shapes, caches, weight carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_round_trips(fx, arch):
    """The port's parameters restacked give the reference's arrays back,
    ``enc_layers.*`` over ``n_enc_layers`` and ``dec_layers.*`` over
    ``n_layers``."""
    cfg, model = _model(fx, arch, "float32")
    arrays = _arrays(fx, arch)
    assert sorted(arrays) == sorted(M.reference_names(cfg))
    got = dict(model.named_parameters())
    for name, a in arrays.items():
        stack, _, rest = name.partition(".")
        if stack in M._STACKED:
            back = np.stack([got[f"{stack}.{i}.{rest}"].numpy()
                             for i in range(M.stacked_layers(cfg, stack))])
        else:
            back = got[name].numpy()
        np.testing.assert_array_equal(back, a, err_msg=name)
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        M.param_shapes(cfg)


def test_stacks_are_sized_by_their_own_counts(fx):
    """A whisper config with 3 encoder and 2 decoder layers:
    ``param_shapes``, ``param_tree`` and ``from_reference`` size
    ``enc_layers`` by ``n_enc_layers``, and the model runs."""
    cfg = dataclasses.replace(PC.get_smoke_config("whisper-medium"),
                              n_enc_layers=3, compute_dtype="float32")
    shapes = M.param_shapes(cfg)
    assert sum(n.startswith("enc_layers.") and n.endswith(".ln1")
               for n in shapes) == 3
    assert sum(n.startswith("dec_layers.") and n.endswith(".ln1")
               for n in shapes) == 2
    model = steps.init_params(cfg, seed=0, device="cpu")
    params = dict(model.named_parameters())
    tree = M.param_tree(cfg, params)
    assert len(tree["enc_layers"]) == 3 and len(tree["dec_layers"]) == 2
    assert tree["enc_layers"][2]["attn"]["wq"] is params[
        "enc_layers.2.attn.wq"]
    arrays = {}
    for name in M.reference_names(cfg):
        stack, _, rest = name.partition(".")
        if stack in M._STACKED:
            arrays[name] = np.stack([
                params[f"{stack}.{i}.{rest}"].detach().numpy()
                for i in range(M.stacked_layers(cfg, stack))])
        else:
            arrays[name] = params[name].detach().numpy()
    again = M.from_reference(cfg, arrays, device="cpu")
    assert all(torch.equal(p, params[n])
               for n, p in again.named_parameters())
    with pytest.raises(ValueError, match="stacks 3 layers"):
        M.from_reference(dataclasses.replace(cfg, n_enc_layers=2), arrays,
                         device="cpu")
    frames = torch.zeros((1, cfg.enc_frames, cfg.d_model))
    logits = M.forward(again, {"tokens": torch.zeros((1, 8), dtype=torch.long),
                               "frames": frames})
    assert bool(torch.isfinite(logits).all())
    loss = M.loss_fn(params, cfg, {
        "tokens": torch.zeros((1, 8), dtype=torch.long),
        "labels": torch.zeros((1, 8), dtype=torch.long), "frames": frames})
    assert bool(torch.isfinite(loss))


def _shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_the_reference_at_full_width(arch):
    """``param_shapes`` on ``meta`` against the reference's ``eval_shape``
    of ``init_params`` at the full published config (24 + 24 layers for
    whisper-medium: 0.96 G parameters; 1.54 G for qwen2-vl-2b)."""
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    want = _shapes(jax.eval_shape(lambda: RM.init_params(
        rcfg, jax.random.PRNGKey(0))))
    got = M.param_shapes(cfg)
    assert sorted(M.reference_names(cfg)) == sorted(want)
    flat: dict = {}
    for name, shape in got.items():
        parts = name.split(".")
        key = (f"{parts[0]}.{'.'.join(parts[2:])}" if parts[0] in M._STACKED
               else name)
        flat.setdefault(key, []).append(shape)
    for key, shapes in flat.items():
        stack = key.split(".")[0]
        if stack in M._STACKED:
            assert len(shapes) == M.stacked_layers(cfg, stack) == \
                want[key][0], key
            assert all(s == want[key][1:] for s in shapes), key
        else:
            assert shapes == [want[key]], key
    total = sum(int(np.prod(s)) for s in got.values())
    assert total == sum(int(np.prod(s)) for s in want.values())
    assert abs(total / 1e9 - {"whisper-medium": 0.96,
                              "qwen2-vl-2b": 1.54}[arch]) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_is_the_reference_tree(arch):
    cfg, rcfg = PC.get_smoke_config(arch), RC.get_smoke_config(arch)
    want = jax.eval_shape(lambda: RM.init_cache(rcfg, 3, 16))
    got = M.init_cache(cfg, 3, 16, device="cpu")
    assert {k: (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in want.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
         for k, v in got.items()}
    assert all(not bool(v.any()) for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_draws_the_new_families(arch):
    """A seeded init of the smoke config: the reference's names and
    shapes, ``pos_emb_enc`` normal x 0.01, and a second draw at the same
    seed equal."""
    cfg = PC.get_smoke_config(arch)
    model = steps.init_params(cfg, seed=0, device="cpu")
    got = dict(model.named_parameters())
    assert {n: tuple(t.shape) for n, t in got.items()} == M.param_shapes(cfg)
    if cfg.enc_dec:
        std = float(got["pos_emb_enc"].std())
        assert 0.008 < std < 0.012
        assert torch.equal(got["enc_final_norm"], torch.zeros(cfg.d_model))
    again = steps.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(p, dict(again.named_parameters())[n])
               for n, p in got.items())


def test_fixture_is_the_references(fx, tool):
    """``lm_smoke_encdec_vlm.npz`` equals a fresh run of the reference."""
    fresh = tool.build_lm_encdec_vlm()
    assert fresh.keys() == fx.keys()
    for k in fx:
        assert fresh[k].dtype == fx[k].dtype, k
        np.testing.assert_array_equal(fresh[k], fx[k], err_msg=k)
