"""The port's int8 gradient compression and LogicNet mask rule against the
reference's (``repro.optim.compress``, ``repro.optim.adamw``), on the CPU.

Codes and scales must equal the reference's bit for bit (both round half
to even, both divide truly); so must the error-feedback round trip, step
after step.  ``logicnet_mask_fn`` must give every leaf the mask the
reference gives the same leaf (resolved by dotted name in the port's flat
dict, by pytree path in the reference), and an AdamW step with it must
match the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from torch_port_util import one_torch_thread  # noqa: F401

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as RM
from repro.models.config import LogicNetFFNCfg as RefLogicNetFFNCfg
from repro.optim import adamw as RA
from repro.optim import compress as RCMP
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models.config import LogicNetFFNCfg
from repro_torch.optim import (AdamWCfg, adamw_update,
                               compress_grads_with_feedback, compress_int8,
                               decompress_int8, init_error_state,
                               init_opt_state, logicnet_mask_fn)


def _grad(case: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "normal":
        return rng.standard_normal((64, 48)).astype(np.float32)
    if case == "tiny":
        return (rng.standard_normal((33, 7)) * 1e-9).astype(np.float32)
    if case == "large":
        return (rng.standard_normal((5, 5, 6)) * 3e4).astype(np.float32)
    if case == "zeros":
        return np.zeros((4, 4), np.float32)
    if case == "scalar":
        return np.asarray([-2.5], np.float32)
    # "ties": every value a multiple of half a step, so round() decides
    # each code at a half-way point (half to even in both packages)
    peak = np.float32(1.7)
    step = peak / np.float32(127.0)
    g = rng.integers(-254, 255, (40, 40)).astype(np.float32) * (
        step / np.float32(2))
    g[0, 0] = peak
    return g


CASES = ("normal", "tiny", "large", "zeros", "scalar", "ties")


@pytest.mark.parametrize("case", CASES)
def test_compress_int8_equals_reference_bit_for_bit(case):
    g = _grad(case)
    rq, rs = RCMP.compress_int8(jnp.asarray(g))
    q, s = compress_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    deq = decompress_int8(q, s)
    assert deq.numpy().tobytes() == np.asarray(
        RCMP.decompress_int8(rq, rs)).tobytes()
    if case == "ties":
        assert (np.abs(np.asarray(rq)) % 2 == 0).any()


def test_error_feedback_equals_reference_over_steps():
    """Five steps of ``compress_grads_with_feedback`` over a dict of
    gradients: decompressed gradients and residuals bit for bit."""
    names = ("embed", "wq", "norm")
    shapes = {"embed": (32, 16), "wq": (16, 4, 8), "norm": (16,)}
    err = init_error_state({k: torch.zeros(shapes[k]) for k in names})
    rerr = RCMP.init_error_state({k: jnp.zeros(shapes[k]) for k in names})
    rng = np.random.default_rng(7)
    for _ in range(5):
        g = {k: (rng.standard_normal(shapes[k])
                 * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
             for k in names}
        deq, err = compress_grads_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, err)
        rdeq, rerr = RCMP.compress_grads_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, rerr)
        for k in names:
            assert deq[k].numpy().tobytes() == np.asarray(rdeq[k]).tobytes()
            assert err[k].numpy().tobytes() == np.asarray(rerr[k]).tobytes()


def test_error_feedback_carries_what_the_round_trip_lost():
    """Summed over steps, the delivered gradients equal the true ones less
    the last residual, and a residual is at most half a step."""
    rng = np.random.default_rng(1)
    err = init_error_state({"w": torch.zeros(50)})
    total_g, total_deq = torch.zeros(50), torch.zeros(50)
    for _ in range(20):
        g = torch.from_numpy(rng.standard_normal(50).astype(np.float32))
        deq, new = compress_grads_with_feedback({"w": g}, err)
        _, scale = compress_int8(g + err["w"])
        assert bool((new["w"].abs() <= scale / 2 * (1 + 1e-6)).all())
        total_g += g
        total_deq += deq["w"]
        err = new
    torch.testing.assert_close(total_deq + err["w"], total_g, atol=1e-5,
                               rtol=0)


def test_init_error_state_is_float32_zeros():
    err = init_error_state({"a": torch.ones(2, 3, dtype=torch.int32),
                            "b": torch.ones(4)})
    assert all(e.dtype == torch.float32 and not e.any()
               for e in err.values())
    assert err["a"].shape == (2, 3)


@pytest.fixture(scope="module")
def smoke_logicnet():
    """The reference's smoke qwen3 with the LogicNet-FFN at PRNGKey(0) and
    the port's model carrying its weights."""
    rcfg = dataclasses.replace(ref_smoke("qwen3-1.7b"),
                               logicnet_ffn=RefLogicNetFFNCfg(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              logicnet_ffn=LogicNetFFNCfg(),
                              compute_dtype="float32")
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, params


def _port_params(cfg, ref_params):
    from repro_torch.models import model as M

    flat = {}
    for path, leaf in tree_flatten_with_path(ref_params)[0]:
        flat[".".join(k.key for k in path)] = np.asarray(leaf)
    model = M.from_reference(cfg, flat, device="cpu")
    return {n: p.detach().clone() for n, p in model.params.items()}


def test_logicnet_mask_fn_resolves_the_reference_leaves(smoke_logicnet):
    rcfg, cfg, rparams = smoke_logicnet
    params = _port_params(cfg, rparams)
    resolved = {}
    for path, _ in tree_flatten_with_path(rparams)[0]:
        mask = RA.logicnet_mask_fn(keystr(path), rparams)
        # the reference's mask, named as a stacked leaf
        for mpath, leaf in tree_flatten_with_path(rparams)[0]:
            if mask is leaf:
                resolved[".".join(k.key for k in path)] = ".".join(
                    k.key for k in mpath)
    assert sorted(resolved) == ["layers.ffn.wi_gate", "layers.ffn.wi_up",
                                "layers.ffn.wo"]
    for name in params:
        got = logicnet_mask_fn(name, params)
        parts = name.split(".")
        stacked = ".".join([parts[0]] + parts[2:]) if parts[0] == "layers" \
            else name
        if stacked not in resolved:
            assert got is None, name
            continue
        want = resolved[stacked].replace("layers.",
                                          f"layers.{parts[1]}.", 1)
        assert got is params[want], name
    assert logicnet_mask_fn("wo", {"mask_out": params["final_norm"]}) \
        is params["final_norm"]
    assert logicnet_mask_fn("layers.0.attn.wo", params) is None


def test_adamw_step_with_logicnet_masks_matches_reference(smoke_logicnet):
    """One AdamW update with the mask rule on the same parameters and
    gradients: pruned weights become exactly zero, masks stay as they
    were (frozen), every leaf within float32 rounding of the
    reference's."""
    rcfg, cfg, rparams = smoke_logicnet
    params = _port_params(cfg, rparams)
    rng = np.random.default_rng(2)
    rgrads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), rparams)
    grads = _port_params(cfg, rgrads)
    ropt = RA.AdamWCfg(lr=1e-2, weight_decay=0.01)
    want, _ = jax.jit(lambda p, g, s: RA.adamw_update(
        ropt, p, g, s, mask_fn=RA.logicnet_mask_fn))(
            rparams, rgrads, RA.init_opt_state(rparams))
    masks = {n: p.clone() for n, p in params.items() if "mask" in n}
    adamw_update(AdamWCfg(lr=1e-2, weight_decay=0.01), params, grads,
                 init_opt_state(params), mask_fn=logicnet_mask_fn)
    got = _port_params(cfg, want)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), got[n].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=n)
    for n, m in masks.items():
        assert torch.equal(params[n], m)
    for i in range(cfg.n_layers):
        for w, m in (("wi_gate", "mask_in"), ("wi_up", "mask_in"),
                     ("wo", "mask_out")):
            p = params[f"layers.{i}.ffn.{w}"]
            assert bool((p[params[f"layers.{i}.ffn.{m}"] == 0] == 0).all())


def test_train_state_masks_require_grad_but_stay_frozen():
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              logicnet_ffn=LogicNetFFNCfg())
    state = steps.make_train_state(cfg, seed=0, device="cpu")
    masks = [n for n in state["params"] if "mask" in n]
    assert len(masks) == 2 * cfg.n_layers
    assert all(state["params"][n].requires_grad for n in masks)
    assert state["opt"]["step"].dtype == torch.int32
