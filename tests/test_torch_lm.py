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

The MoE and SSM families (olmoe-1b-7b, qwen3-moe-235b-a22b, mamba2-370m,
zamba2-2.7b) are held against ``lm_smoke_moe_ssm.npz`` with the same
tolerances.  The fixture also holds the reference's router choices.  A MoE
router's top-k choice is discrete: at bfloat16 one step of noise upstream
settles a near-tie of two logits either way, and the token and those that
attend to it then move past 0.05.  So at bfloat16 a MoE model's positions
past the contract must each follow, in their row, a position whose expert
set differs from the reference's in some layer
(``chip_smoke.lm_check_routes``, the rule phase 8 applies on the card); at
float32 the expert sets equal the reference's and every position is held
to 1e-4, capacity drops included.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import sys
from pathlib import Path

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
from repro_torch.models import moe as MOE

ARCHS = ("qwen3-1.7b", "gemma3-27b")
MOE_SSM_ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "mamba2-370m",
                 "zamba2-2.7b")
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
def cs():
    """``chip_smoke.py`` as a module (importing it runs nothing)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rules", Path(ROOT) / "chip_smoke.py")
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
# configs, init, weight carry
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


# ---------------------------------------------------------------------------
# the MoE and SSM families (lm_smoke_moe_ssm.npz)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_ssm(tool):
    with np.load(os.path.join(FIXTURE_DIR, tool.LM_MOE_SSM_NAME)) as z:
        return {k: z[k] for k in z.files}


def _fixture_model(fx, arch, compute_dtype):
    """The port's smoke model of ``arch`` with the reference's params, at
    the compute dtype and MoE capacity of the fixture's run."""
    cfg = dataclasses.replace(PC.get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    if cfg.moe is not None:
        cf = float(fx[f"{arch}.{compute_dtype}.capacity_factor"])
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    pre = f"{arch}.params."
    arrays = {k[len(pre):]: v for k, v in fx.items() if k.startswith(pre)}
    return cfg, M.from_reference(cfg, arrays, device="cpu")


def _route_check(cs, fx, arch, compute_dtype, which, got, routes, shape):
    """``got`` against the fixture's ``which`` logits: float32 at every
    position, with the reference's expert sets; bfloat16 by
    ``chip_smoke.lm_check_routes``."""
    cfg = PC.get_smoke_config(arch)
    want = fx[f"{arch}.{compute_dtype}.{which}"]
    differ = np.zeros(shape, bool)
    if cfg.moe is not None:
        mine = (cs.route_sets(routes, shape) if which == "prefill" else
                cs.decode_routes(routes, cfg.n_layers, *shape))
        differ = cs.routes_differ(mine, cs.fixture_route_sets(
            fx[f"{arch}.{compute_dtype}.{which}_topi"]))
    if compute_dtype == "float32":
        assert not differ.any()
        np.testing.assert_allclose(_f32(got), want, **TIGHT)
    else:
        cs.lm_check_routes(arch, got, want, compute_dtype, differ)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_moe_ssm_forward_matches_reference(cs, moe_ssm, arch, compute_dtype):
    """All 64 positions, and the serving prefill's last one; the summed
    aux loss is positive exactly for the MoE archs."""
    cfg, model = _fixture_model(moe_ssm, arch, compute_dtype)
    tokens = torch.from_numpy(moe_ssm[f"{arch}.tokens"])
    with cs.record_routing() as routes:
        got, aux = M.forward(model, {"tokens": tokens}, with_aux=True)
    assert got.dtype == getattr(torch, compute_dtype)
    assert (float(aux) > 0) == (cfg.moe is not None)
    assert len(routes) == (cfg.n_layers if cfg.moe is not None else 0)
    _route_check(cs, moe_ssm, arch, compute_dtype, "prefill", got, routes,
                 tuple(tokens.shape))
    last = steps.make_prefill_step(cfg)(model, {"tokens": tokens})
    np.testing.assert_allclose(_f32(last), _f32(got[:, -1]), atol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_moe_ssm_decode_matches_reference(cs, moe_ssm, arch, compute_dtype):
    """12 tokens fed one at a time into a 12-slot cache (KV leaves in the
    compute dtype, SSM state float32): each step's logits.  At float32 the
    MoE archs decode at their own capacity, 1 place an expert for the 2
    rows, so pairs drop, as they do in the reference."""
    cfg, model = _fixture_model(moe_ssm, arch, compute_dtype)
    tokens = torch.from_numpy(moe_ssm[f"{arch}.tokens"])
    n = moe_ssm[f"{arch}.{compute_dtype}.decode"].shape[1]
    cache = M.init_cache(cfg, 2, n, device="cpu")
    cache = {k: v.to(getattr(torch, compute_dtype))
             if k in ("k", "v", "shared_k", "shared_v") else v
             for k, v in cache.items()}
    got = []
    with cs.record_routing() as routes:
        for t in range(n):
            lg, cache = M.decode_step(model, cache, tokens[:, t:t + 1],
                                      torch.full((2,), t, dtype=torch.int32))
            got.append(lg[:, 0])
    if cfg.moe is not None:
        drops = sum(MOE.dropped_pairs(r["topi"].reshape(1, 2, -1),
                                      cfg.moe.n_experts,
                                      MOE.capacity(cfg, 2)) for r in routes)
        assert (drops > 0) == (compute_dtype == "float32")
    _route_check(cs, moe_ssm, arch, compute_dtype, "decode",
                 torch.stack(got, 1), routes, (2, n))


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_moe_ssm_serve_tokens_equal_reference(cs, tool, moe_ssm, arch):
    """``serve`` at ``--requests 5 --slots 2 --max-new 6 --cache-len 64``
    and float32 compute: the reference's requests, order and tokens.  Slots
    are recycled, so an SSM slot's next request starts from the state the
    previous one left (as in the reference); the MoE archs drop pairs in
    decode at their own capacity (1 place an expert for 2 slots)."""
    cfg, model = _fixture_model(moe_ssm, arch, "float32")
    with cs.record_routing() as routes:
        res = serve_lm.serve(cfg, model, **tool.LM_SERVE)
    assert [r["id"] for r in res.done] == \
        moe_ssm[f"{arch}.float32.serve_ids"].tolist()
    assert [r["out"] for r in res.done] == \
        moe_ssm[f"{arch}.float32.serve_out"].tolist()
    if cfg.moe is not None:
        assert sum(MOE.dropped_pairs(r["topi"].reshape(1, 2, -1),
                                     cfg.moe.n_experts, MOE.capacity(cfg, 2))
                   for r in routes) > 0


def test_recycled_ssm_slot_carries_the_previous_state(moe_ssm):
    """A recycled slot restarts at pos 0 with the SSM state the previous
    request left (the reference's loop resets only the position and the
    token): its first logits differ from a fresh slot's, where a KV cache
    hides stale entries by position.  The state decays within a few tokens
    in the smoke models, so the served tokens above agree either way."""
    for arch, differs in (("mamba2-370m", True), ("zamba2-2.7b", True),
                          ("qwen3-1.7b", False)):
        cfg = dataclasses.replace(PC.get_smoke_config(arch),
                                  compute_dtype="float32")
        model = steps.init_params(cfg, seed=0, device="cpu")
        used = M.init_cache(cfg, 1, 16, device="cpu")
        for t, tok in enumerate((5, 17, 99)):
            M.decode_step(model, used, torch.tensor([[tok]]),
                          torch.tensor([t], dtype=torch.int32))
        first = torch.tensor([[42]])
        zero = torch.zeros((1,), dtype=torch.int32)
        recycled, _ = M.decode_step(model, used, first, zero)
        fresh, _ = M.decode_step(model, M.init_cache(cfg, 1, 16,
                                                     device="cpu"),
                                 first, zero)
        assert (not torch.equal(recycled, fresh)) == differs, arch


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_from_reference_round_trips(moe_ssm, arch):
    """The port's parameters restacked give the reference's arrays back:
    ``layers.*`` / ``ssm_layers.*`` stacked over layers, ``shared_attn.*``
    one layer's."""
    cfg, model = _fixture_model(moe_ssm, arch, "float32")
    pre = f"{arch}.params."
    arrays = {k[len(pre):]: v for k, v in moe_ssm.items()
              if k.startswith(pre)}
    assert sorted(arrays) == sorted(M.reference_names(cfg))
    got = dict(model.named_parameters())
    for name, a in arrays.items():
        stack, _, rest = name.partition(".")
        if stack in ("layers", "ssm_layers"):
            back = np.stack([got[f"{stack}.{i}.{rest}"].numpy()
                             for i in range(cfg.n_layers)])
        else:
            back = got[name].numpy()
        np.testing.assert_array_equal(back, a)
    assert len(got) == sum(cfg.n_layers if n.split(".")[0] in
                           ("layers", "ssm_layers") else 1 for n in arrays)
    if cfg.is_hybrid:
        assert "shared_attn.attn.wq" in got
        assert not any(n.startswith("layers.") for n in got)


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_param_shapes_match_the_reference_at_full_width(arch):
    """``param_shapes`` on ``meta`` against the reference's ``eval_shape``
    of ``init_params``, for the full published configs (qwen3-moe-235b-a22b
    included: nothing is allocated)."""
    cfg, rcfg = PC.get_config(arch), RC.get_config(arch)
    want = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                want[f"{prefix}{k}"] = tuple(v.shape)

    walk(jax.eval_shape(lambda: RM.init_params(rcfg, jax.random.PRNGKey(0))))
    got = M.param_shapes(cfg)
    assert sorted(M.reference_names(cfg)) == sorted(want)
    flat = {}
    for name, shape in got.items():
        stack, idx, rest = name.split(".", 2) if name.split(".")[0] in (
            "layers", "ssm_layers") else (None, None, name)
        key = f"{stack}.{rest}" if stack else name
        flat.setdefault(key, []).append(shape)
    for key, shapes in flat.items():
        if key.split(".")[0] in ("layers", "ssm_layers"):
            assert len(shapes) == cfg.n_layers
            assert all(s == want[key][1:] for s in shapes), key
        else:
            assert shapes == [want[key]], key
    assert sorted(flat) == sorted(want)
    assert sum(int(np.prod(s)) for s in got.values()) == \
        sum(int(np.prod(s)) for s in want.values())


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_init_cache_is_the_reference_tree(arch):
    cfg, rcfg = PC.get_smoke_config(arch), RC.get_smoke_config(arch)
    want = jax.eval_shape(lambda: RM.init_cache(rcfg, 3, 16))
    got = M.init_cache(cfg, 3, 16, device="cpu")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    assert {n: (tuple(v.shape), str(np.dtype(v.dtype))) for n, v in
            leaves(want)} == \
        {n: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
         for n, v in leaves(got)}
    assert all(not bool(v.any()) for _, v in leaves(got))


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_port_init_draws_the_new_families(arch):
    """A seeded init of the smoke config: the reference's names, a float32
    router, the SSM leaves as ``ssm_init`` sets them, and a second draw at
    the same seed equal."""
    cfg = PC.get_smoke_config(arch)
    model = steps.init_params(cfg, seed=0, device="cpu")
    got = dict(model.named_parameters())
    assert {n: tuple(t.shape) for n, t in got.items()} == M.param_shapes(cfg)
    if cfg.moe is not None:
        r = got["layers.0.moe.router"]
        assert r.dtype == torch.float32
        assert abs(float(r.std()) * cfg.d_model ** 0.5 - 1) < 0.2
    if cfg.is_ssm:
        assert torch.equal(got["ssm_layers.1.ssm.d_skip"],
                           torch.ones_like(got["ssm_layers.1.ssm.d_skip"]))
    again = steps.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(p, dict(again.named_parameters())[n])
               for n, p in got.items())
    w = model.compute_params()
    key = "layers" if not cfg.is_ssm else "ssm_layers"
    leaf = w[key][0]["moe"]["router"] if cfg.moe is not None else \
        w[key][0]["ssm"]["conv_w"] if cfg.is_ssm else None
    assert leaf is None or leaf.dtype == torch.bfloat16
    if cfg.is_ssm:
        assert w[key][0]["ssm"]["a_log"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-2.7b"])
def test_serve_cli_runs_the_new_families_on_the_cpu(arch, capsys):
    serve_lm.main(["--arch", arch, "--requests", "3", "--slots", "2",
                   "--max-new", "4", "--cache-len", "32", "--device", "cpu"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_serve_cli_refuses_qwen3_moe_at_full_width():
    with pytest.raises(SystemExit, match="do not fit one card"):
        serve_lm.main(["--arch", "qwen3-moe-235b-a22b", "--width", "full",
                       "--device", "cpu"])
