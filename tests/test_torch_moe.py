"""The port's mixture-of-experts FFN against the reference's, on the CPU.

The reference (``repro.models.moe``) runs under JAX on the CPU; the port
(``repro_torch.models.moe``) runs on CPU tensors.  Both get the same
seeded numpy inputs and weights.  Tolerances:

* float32: atol 1e-5 / rtol 1e-5 (the same products in another summation
  order; every dispatch keeps the same (token, k) pairs, which the drop
  counts pin);
* bfloat16 (weights and activations, the router's weights rounded as the
  model's cast rounds them): the reference's 0.05 contract (the same
  experts chosen; the outputs one or two bfloat16 steps apart, as
  ``jax.nn.silu`` rounds four times where ``F.silu`` rounds once).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro import configs as RC
from repro.models import moe as RMOE
from repro_torch import configs as PC
from repro_torch.models import moe as MOE

F32 = {"atol": 1e-5, "rtol": 1e-5}
BF16 = {"atol": 0.05, "rtol": 0.05}
APPLY = {"dense": (RMOE.moe_apply_dense, MOE.moe_apply_dense),
         "sorted": (RMOE.moe_apply_sorted, MOE.moe_apply_sorted),
         "sorted_local": (RMOE.moe_apply_sorted_local,
                          MOE.moe_apply_sorted_local)}


def _cfgs(arch="olmoe-1b-7b", capacity=None, **kw):
    ref, port = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
    moe = {} if capacity is None else {"capacity_factor": capacity}
    ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe),
                              **kw)
    port = dataclasses.replace(port, moe=dataclasses.replace(port.moe, **moe),
                               **kw)
    return ref, port


def _weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {k: (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
        np.float32) for k, shape, fan_in in (("router", (d, e), d),
                                             ("wi_gate", (e, d, f), d),
                                             ("wi_up", (e, d, f), d),
                                             ("wo", (e, f, d), f))}


def _inputs(cfg, b, s, seed=1):
    """Seeded activations sharing one direction (as a model's hidden states
    do), so that routing is skewed and the default capacity drops pairs."""
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal(cfg.d_model) * 1.5
    return (rng.standard_normal((b, s, cfg.d_model)) + shared).astype(
        np.float32)


def _run(fns, rcfg, cfg, w, x, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    # every matrix leaf in the compute dtype, the router included, as the
    # models' casts make them
    rp = {k: jnp.asarray(v, jdt) for k, v in w.items()}
    pp = {k: torch.from_numpy(v).to(tdt) for k, v in w.items()}
    want, waux = fns[0](rp, rcfg, jnp.asarray(x, jdt))
    got, aux = fns[1](pp, cfg, torch.from_numpy(x).to(tdt))
    return (np.asarray(want.astype(jnp.float32)), float(waux),
            got.float().numpy(), float(aux))


def _drops(cfg, x_shape, w, x, group):
    """(token, k) pairs the grouped dispatches drop at ``group`` tokens a
    group."""
    topi, _, _ = MOE._router({"router": torch.from_numpy(w["router"])},
                             torch.from_numpy(x), cfg)
    return MOE.dropped_pairs(topi.reshape(-1, group, cfg.moe.top_k),
                             cfg.moe.n_experts, MOE.capacity(cfg, group))


@pytest.mark.parametrize("mode", sorted(APPLY))
@pytest.mark.parametrize("arch,b,s,capacity", [
    ("olmoe-1b-7b", 2, 64, None),          # the config's 1.25: drops
    ("olmoe-1b-7b", 4, 1, None),           # decode-shaped: gs = B = 4
    ("olmoe-1b-7b", 2, 64, 0.5),           # tight: many drops
    ("qwen3-moe-235b-a22b", 2, 64, None),
    ("qwen3-moe-235b-a22b", 4, 1, None),
    ("olmoe-1b-7b", 2, 1024, 4.0),         # two groups of 1024, none drop
])
def test_moe_apply_matches_reference_at_float32(mode, arch, b, s, capacity):
    rcfg, cfg = _cfgs(arch, capacity)
    w, x = _weights(cfg), _inputs(cfg, b, s)
    want, waux, got, aux = _run(APPLY[mode], rcfg, cfg, w, x, "float32")
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(aux, waux, rtol=1e-6)


@pytest.mark.parametrize("mode", sorted(APPLY))
@pytest.mark.parametrize("b,s,capacity", [(2, 64, None), (4, 1, None),
                                          (2, 64, 0.5)])
def test_moe_apply_matches_reference_at_bfloat16(mode, b, s, capacity):
    rcfg, cfg = _cfgs(capacity=capacity)
    w, x = _weights(cfg), _inputs(cfg, b, s)
    want, waux, got, aux = _run(APPLY[mode], rcfg, cfg, w, x, "bfloat16")
    np.testing.assert_allclose(got, want, **BF16)
    np.testing.assert_allclose(aux, waux, rtol=1e-6)


def test_the_cases_drop_pairs_as_intended():
    """The default capacity drops pairs in both shapes (decode's 4 slots
    share cap = max(1, int(1.25 * 4 * 2 / 4)) = 2 places an expert), the
    tight one more, and 4.0 none."""
    _, cfg = _cfgs()
    w = _weights(cfg)
    assert MOE.capacity(cfg, 4) == 2 and MOE.capacity(cfg, 128) == 80
    assert _drops(cfg, None, w, _inputs(cfg, 4, 1), 4) > 0
    default = _drops(cfg, None, w, _inputs(cfg, 2, 64), 128)
    _, tight = _cfgs(capacity=0.5)
    assert 0 < default < _drops(tight, None, w, _inputs(cfg, 2, 64), 128)
    _, loose = _cfgs(capacity=4.0)
    assert _drops(loose, None, w, _inputs(cfg, 2, 1024), 1024) == 0


def test_dispatches_agree_where_nothing_drops():
    """dense and sorted_local keep the same pairs at any capacity; sorted
    (one group over all tokens, where the others take groups of 1024)
    agrees with them only where nothing is dropped (the reference's own
    ``test_models`` uses 4.0)."""
    _, cfg = _cfgs(capacity=4.0)
    w = {k: torch.from_numpy(v) for k, v in _weights(cfg).items()}
    x = torch.from_numpy(_inputs(cfg, 2, 64))
    outs = {m: fns[1](w, cfg, x)[0] for m, fns in APPLY.items()}
    for m in ("sorted", "sorted_local"):
        torch.testing.assert_close(outs[m], outs["dense"], **F32)
    _, tight = _cfgs(capacity=0.5)
    x = torch.from_numpy(_inputs(cfg, 2, 1024))
    dense = MOE.moe_apply_dense(w, tight, x)[0]
    torch.testing.assert_close(MOE.moe_apply_sorted_local(w, tight, x)[0],
                               dense, **F32)
    assert not torch.allclose(MOE.moe_apply_sorted(w, tight, x)[0], dense,
                              **F32)


def test_router_reads_a_bfloat16_router_as_the_reference():
    """In bfloat16 compute the model holds a bfloat16 router and the
    float32 product promotes it back; a router kept in float32 picks other
    experts for some of these tokens (the case fails if it stays
    float32)."""
    rcfg, cfg = _cfgs()
    w = _weights(cfg, seed=5)
    x = _inputs(cfg, 4, 256, seed=6)
    xb = torch.from_numpy(x).bfloat16()
    want, _, waux = RMOE._router({"router": jnp.asarray(w["router"],
                                                        jnp.bfloat16)},
                                 jnp.asarray(x, jnp.bfloat16), rcfg)
    router = torch.from_numpy(w["router"])
    got, _, aux = MOE._router({"router": router.bfloat16()}, xb, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    kept_f32, _, _ = MOE._router({"router": router}, xb, cfg)
    assert (kept_f32.numpy() != np.asarray(want)).any()


def test_router_breaks_ties_towards_the_lower_expert():
    """Equal logits: ``jax.lax.top_k`` takes the lower index first."""
    rcfg, cfg = _cfgs()
    d, e = cfg.d_model, cfg.moe.n_experts
    router = np.zeros((d, e), np.float32)
    router[0] = [1.0, 2.0, 2.0, 1.0]
    x = np.zeros((1, 3, d), np.float32)
    x[0, :, 0] = [1.0, 0.0, -1.0]
    want, ww, _ = RMOE._router({"router": jnp.asarray(router)},
                               jnp.asarray(x), rcfg)
    got, gw, _ = MOE._router({"router": torch.from_numpy(router)},
                             torch.from_numpy(x), cfg)
    assert got.tolist() == np.asarray(want).tolist() == [[[1, 2], [0, 1],
                                                          [0, 3]]]
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-6)


def test_expert_ffn_matches_reference():
    rcfg, cfg = _cfgs()
    w = _weights(cfg)
    xs = np.random.default_rng(2).standard_normal(
        (cfg.moe.n_experts, 24, cfg.d_model)).astype(np.float32)
    want = RMOE._expert_ffn({k: jnp.asarray(v) for k, v in w.items()},
                            jnp.asarray(xs), jax.nn.silu)
    got = MOE._expert_ffn({k: torch.from_numpy(v) for k, v in w.items()},
                          torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_moe_init_distributions():
    _, cfg = _cfgs()
    full = PC.get_config("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(0)
    p = MOE.moe_init(gen, dataclasses.replace(full, moe=cfg.moe, d_ff=512,
                                              d_model=512), torch.float32)
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (512, cfg.moe.n_experts)
    assert p["wi_gate"].shape == p["wi_up"].shape == (cfg.moe.n_experts, 512,
                                                      512)
    assert abs(float(p["router"].std()) * 512 ** 0.5 - 1) < 0.05
    assert abs(float(p["wo"].std()) * 512 ** 0.5 - 1) < 0.05
    bf = MOE.moe_init(gen, cfg, torch.bfloat16)
    assert bf["router"].dtype == torch.float32
    assert bf["wi_gate"].dtype == torch.bfloat16
