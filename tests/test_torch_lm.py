"""The port's LM serving path against the reference's, on the CPU.

The reference (``repro.models``, ``repro.launch.steps``, the decode loop of
``examples/serve_lm.py``) runs under JAX on the CPU; the port
(``repro_torch.models``, ``repro_torch.launch``) runs its plain versions
on CPU tensors, the flash-attention kernel's included.  Both get the same
seeded numpy inputs, and the reference's ``init_params`` at PRNGKey(0)
carried in by ``from_reference``.  Tolerances:

* layers and chunked attention, float32: atol 1e-5 (norm, FFN) or
  atol 2e-5 / rtol 1e-4 (attention, the reference tests' own): the same
  arithmetic in another summation order; RoPE at positions up to 4096
  with theta 1e6: atol 1e-5 (one of the 64 frequencies differs by one
  float32 step between the two frameworks' ``pow``);
* smoke-config logits at float32 compute: atol 1e-4 / rtol 1e-4 (prefill
  attention is the dense softmax there, the chunked online softmax in the
  reference; 2-6 layers of float32 products), with the KV cache in float32
  too (see ``test_decode_matches_reference`` for the bfloat16 cache);
* at the default bfloat16 compute: atol 0.05 / rtol 0.05, the reference's
  own decode-against-forward contract (``tests/test_models.py``): both
  round to bfloat16 at the same points, and a value near a rounding point
  may land one step apart;
* served tokens at float32 compute: equal.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import FIXTURE_DIR, ROOT, one_torch_thread  # noqa: F401

from repro import configs as RC
from repro.launch import steps as RS
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import configs as PC
from repro_torch.launch import serve_lm, steps
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCHS = ("qwen3-1.7b", "gemma3-27b")
TIGHT = {"atol": 1e-4, "rtol": 1e-4}
BF16 = {"atol": 0.05, "rtol": 0.05}
ATTN = {"atol": 2e-5, "rtol": 1e-4}
DECODE_STEPS = 12
SEQ = 64          # a multiple of both smoke configs' attn_chunk


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_params(tool):
    """The reference's smoke params at PRNGKey(0), per arch, as the
    committed ``lm_smoke.npz`` holds them (``tests/test_torch_engine.py``
    asserts it equals a fresh ``init_params``)."""
    with np.load(os.path.join(FIXTURE_DIR, tool.LM_NAME)) as z:
        fx = {k: z[k] for k in z.files}
    out = {}
    for arch in ARCHS:
        pre = f"{arch}.params."
        out[arch] = jax.tree.map(jnp.asarray, tool.unflatten_params(
            {k[len(pre):]: v for k, v in fx.items() if k.startswith(pre)}))
    return out


def _cfgs(arch, compute_dtype, **kw):
    ref = dataclasses.replace(RC.get_smoke_config(arch),
                              compute_dtype=compute_dtype, **kw)
    port = dataclasses.replace(PC.get_smoke_config(arch),
                               compute_dtype=compute_dtype, **kw)
    return ref, port


def _port_model(tool, cfg, params):
    return M.from_reference(cfg, tool.flatten_params(params), device="cpu")


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = RL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), 1e-6)
    got = L.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                     1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 4, 128)).astype(np.float32)
    pos = np.stack([np.arange(0, 4096, 64),
                    np.arange(4032, 4096)]).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_apply_matches_reference(act):
    rng = np.random.default_rng(2)
    d, ff = 64, 128
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wi_gate", (d, ff)), ("wi_up", (d, ff)),
                      ("wo", (ff, d)))}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    want = RL.ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act)
    got = L.ffn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# chunked attention (the decode path's attention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,window", [(8, 0), (16, 0), (8, 12), (32, 0),
                                          (16, 12)])
def test_chunked_attention_prefill_form(chunk, window):
    """Chunks that divide S = 40 and chunks that do not: in the latter the
    reference clamps the last chunk's slice and not its key positions, and
    the port reproduces that exactly."""
    rng = np.random.default_rng(3)
    b, s, hq, hkv, d = 2, 40, 4, 2, 16
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = RA._chunked_attention(q, k, v, q_offset=0, window=window,
                                 causal=True, chunk=chunk)
    got = A._chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_offset=0, window=window, causal=True,
                               chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


@pytest.mark.parametrize("q_offset,kv_valid,window", [(7, 8, 0), (7, 8, 4),
                                                      (30, 31, 12),
                                                      (5, 20, 0)])
def test_chunked_attention_decode_form(q_offset, kv_valid, window):
    rng = np.random.default_rng(4)
    b, s, hq, hkv, d = 3, 32, 4, 2, 16
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    want = RA._chunked_attention(q, k, v, q_offset=jnp.int32(q_offset),
                                 window=window, causal=True, chunk=16,
                                 kv_len_valid=jnp.int32(kv_valid))
    got = A._chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_offset=torch.tensor(q_offset),
                               window=window, causal=True, chunk=16,
                               kv_len_valid=torch.tensor(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


# ---------------------------------------------------------------------------
# smoke models: forward, decode, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(tool, ref_params, arch, compute_dtype):
    """All 64 positions and the last only (the serving prefill); gemma3's
    local layers mask keys more than 32 back, through the kernel's
    window."""
    rcfg, cfg = _cfgs(arch, compute_dtype)
    model = _port_model(tool, cfg, ref_params[arch])
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (2, SEQ)).astype(np.int32)
    tol = TIGHT if compute_dtype == "float32" else BF16
    for last_only in (False, True):
        want = jax.jit(lambda p, t: RM.forward(
            p, rcfg, {"tokens": t}, last_only=last_only)[0])(
                ref_params[arch], tokens)
        got = M.forward(model, {"tokens": torch.from_numpy(tokens)},
                        last_only=last_only)
        assert got.dtype == getattr(torch, compute_dtype)
        assert got.shape == (2, 1 if last_only else SEQ, cfg.vocab)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    want = RS.make_prefill_step(rcfg)(ref_params[arch], {"tokens": tokens})
    got = steps.make_prefill_step(cfg)(model,
                                       {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("compute_dtype,cache_dtype,mode,offsets", [
    ("float32", "float32", "onehot", (0, 0)),
    ("float32", "float32", "onehot", (0, 3)),
    ("float32", "float32", "dus", (0, 0)),
    ("float32", "float32", "dus", (0, 3)),
    ("float32", "bfloat16", "onehot", (0, 3)),
    ("bfloat16", "bfloat16", "onehot", (0, 3)),
    ("bfloat16", "bfloat16", "dus", (0, 0))])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(tool, ref_params, arch, compute_dtype,
                                  cache_dtype, mode, offsets):
    """12 tokens fed one at a time; with offsets (0, 3) row 1 sits 3
    positions ahead of row 0 (RoPE and the one-hot write use its own
    position, the mask row 0's).

    ``init_cache`` holds k and v in bfloat16 whatever the compute dtype, so
    at float32 compute a value within one float32 rounding of a bfloat16
    half-way point lands one bfloat16 step apart in the two caches: the
    tight tolerance holds with a float32 cache, the bfloat16 contract with
    ``init_cache``'s own."""
    rcfg, cfg = _cfgs(arch, compute_dtype, cache_update=mode)
    model = _port_model(tool, cfg, ref_params[arch])
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, (2, DECODE_STEPS)).astype(np.int32)
    cache_len = DECODE_STEPS + max(offsets) + 1
    rcache = jax.tree.map(lambda a: a.astype(cache_dtype),
                          RM.init_cache(rcfg, 2, cache_len))
    cache = {k: v.to(getattr(torch, cache_dtype)) for k, v in
             M.init_cache(cfg, 2, cache_len, device="cpu").items()}
    rdecode = jax.jit(RS.make_decode_step(rcfg))
    decode = steps.make_decode_step(cfg)
    tol = TIGHT if cache_dtype == "float32" else BF16
    for t in range(DECODE_STEPS):
        pos = np.asarray(offsets, np.int32) + t
        want, rcache = rdecode(ref_params[arch], rcache, tokens[:, t:t + 1],
                               pos)
        got, cache = decode(model, cache, torch.from_numpy(tokens[:, t:t + 1]),
                            torch.from_numpy(pos))
        np.testing.assert_allclose(_f32(got), _f32(want), **tol,
                                   err_msg=f"step {t}")
    if cache_dtype == "float32":
        for name in ("k", "v"):
            np.testing.assert_allclose(_f32(cache[name]), _f32(rcache[name]),
                                       **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_reference_at_float32(tool, ref_params, arch):
    """The port's ``serve`` and the reference's decode loop, driven as
    ``--requests 5 --slots 2 --max-new 6 --cache-len 64`` (recycled slots
    sit at different positions), finish the same requests in the same
    order with the same tokens."""
    rcfg, cfg = _cfgs(arch, "float32")
    model = _port_model(tool, cfg, ref_params[arch])
    want = tool.reference_serve(rcfg, ref_params[arch], **tool.LM_SERVE)
    res = serve_lm.serve(cfg, model, **tool.LM_SERVE)
    assert [r["id"] for r in res.done] == [r["id"] for r in want]
    assert [r["out"] for r in res.done] == [r["out"] for r in want]
    assert [r["prompt"] for r in res.done] == [r["prompt"] for r in want]
    assert res.tokens == 5 * 6 and res.steps > 0


def test_reference_loop_is_the_examples_loop(tool, ref_params, monkeypatch):
    """The fixture tool's copy of the decode loop prints what
    ``examples/serve_lm.py`` prints for the same flags."""
    spec = importlib.util.spec_from_file_location(
        "serve_lm_example", os.path.join(ROOT, "examples", "serve_lm.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    flags = ["--requests", "5", "--slots", "2", "--max-new", "6",
             "--cache-len", "64"]
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", *flags])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        example.main()
    printed = [ln for ln in buf.getvalue().splitlines() if "req " in ln]
    done = tool.reference_serve(RC.get_smoke_config("qwen3-1.7b"),
                                ref_params["qwen3-1.7b"], **tool.LM_SERVE)
    assert printed == [f"  req {r['id']}: prompt {len(r['prompt'])} toks -> "
                       f"{r['out'][:8]}..." for r in done[:3]]


def test_serve_cli_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_lm", "--arch", "gemma3-27b", "--requests", "3", "--slots",
        "2", "--max-new", "4", "--cache-len", "32", "--device", "cpu"])
    serve_lm.main()
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out


# ---------------------------------------------------------------------------
# configs, init, weight carry, unported families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_equal_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        ref = getattr(RC, getter)(arch)
        port = getattr(PC, getter)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        for shape in RC.SHAPES:
            assert PC.cell_skip(port, shape) == RC.cell_skip(ref, shape)
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert ({k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()})


UNPORTED = {"qwen3-moe-235b-a22b": "9a", "olmoe-1b-7b": "9a",
            "zamba2-2.7b": "9b", "mamba2-370m": "9b",
            "whisper-medium": "9c", "qwen2-vl-2b": "9d"}


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_family_raises_naming_its_roadmap_item(arch):
    cfg = PC.get_smoke_config(arch)           # the registry never raises
    match = f"ROADMAP item {UNPORTED[arch]}"
    with pytest.raises(NotImplementedError, match=match):
        M.init_params(cfg, torch.Generator())
    with pytest.raises(NotImplementedError, match=match):
        M.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        M.from_reference(cfg, {}, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-27b",
                                  "starcoder2-15b", "phi3-mini-3.8b"])
def test_port_init_has_the_reference_names_shapes_and_scales(arch):
    cfg = PC.get_smoke_config(arch)
    shapes = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                shapes[f"{prefix}{k}"] = tuple(v.shape)

    walk(jax.eval_shape(lambda: RM.init_params(RC.get_smoke_config(arch),
                                               jax.random.PRNGKey(0))))
    assert sorted(M.reference_names(cfg)) == sorted(shapes)
    model = steps.init_params(cfg, seed=0, device="cpu")
    got = dict(model.named_parameters())
    for name, shape in shapes.items():
        if name.startswith("layers."):
            stacked = [got[name.replace("layers.", f"layers.{i}.", 1)].shape
                       for i in range(cfg.n_layers)]
            assert all(tuple(s) == shape[1:] for s in stacked), name
        else:
            assert tuple(got[name].shape) == shape, name
    assert torch.equal(got["final_norm"], torch.zeros(cfg.d_model))
    assert abs(float(got["embed.tok"].std()) - 0.02) < 0.002
    wq = got["layers.0.attn.wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.1
    again = steps.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again.embed["tok"], model.embed["tok"])
    carried = M.from_reference(cfg, {n: np.zeros(s, np.float32)
                                     for n, s in shapes.items()},
                               device="cpu")
    assert sorted(dict(carried.named_parameters())) == sorted(got)


def test_from_reference_refuses_other_names(tool, ref_params):
    arrays = tool.flatten_params(ref_params["qwen3-1.7b"])
    cfg = PC.get_smoke_config("qwen3-1.7b")
    arrays["layers.attn.extra"] = arrays["layers.attn.wq"]
    with pytest.raises(ValueError, match="do not match"):
        M.from_reference(cfg, arrays, device="cpu")


def test_compute_copy_follows_parameter_writes(tool, ref_params):
    cfg = PC.get_smoke_config("qwen3-1.7b")
    model = _port_model(tool, cfg, ref_params["qwen3-1.7b"])
    first = model.compute_params()
    assert model.compute_params() is first
    assert first["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert first["layers"][0]["ln1"].dtype == torch.float32
    with torch.no_grad():
        model.layers[0].attn["wq"].mul_(2)
    again = model.compute_params()
    assert again is not first
    torch.testing.assert_close(again["layers"][0]["attn"]["wq"],
                               (model.layers[0].attn["wq"]).bfloat16())
