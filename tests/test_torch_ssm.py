"""The port's Mamba2 / SSD block against the reference's, on the CPU.

The reference (``repro.models.ssm``) runs under JAX on the CPU; the port
(``repro_torch.models.ssm``) runs on CPU tensors, on the same seeded numpy
inputs and weights.  Tolerances:

* float32: atol 1e-5 / rtol 1e-5 for the scan and the decode step (the
  same products in another summation order; the port's loop over chunks
  is the reference's ``lax.scan``), atol 1e-4 / rtol 1e-4 for the whole
  block (its in- and out-projections add their own orders);
* bfloat16 (the block's matrices and activations in bfloat16, the 1-D
  leaves in float32, as the models cast them): the reference's 0.05.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro import configs as RC
from repro.models import ssm as RSSM
from repro_torch import configs as PC
from repro_torch.models import ssm as SSM

F32 = {"atol": 1e-5, "rtol": 1e-5}
BLOCK = {"atol": 1e-4, "rtol": 1e-4}
BF16 = {"atol": 0.05, "rtol": 0.05}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch="mamba2-370m", **ssm):
    ref, port = RC.get_smoke_config(arch), PC.get_smoke_config(arch)
    return (dataclasses.replace(ref, ssm=dataclasses.replace(ref.ssm, **ssm)),
            dataclasses.replace(port, ssm=dataclasses.replace(port.ssm,
                                                              **ssm)))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


def _weights(cfg, seed=0):
    """The block's weights: the reference's init shapes, with the 1-D leaves
    drawn too so that none is trivial."""
    shapes = jax.eval_shape(lambda: RSSM.ssm_init(jax.random.PRNGKey(0), cfg,
                                                  jnp.float32))
    rng = np.random.default_rng(seed)
    w = {}
    for k, v in shapes.items():
        a = rng.standard_normal(v.shape)
        if k == "a_log":
            a = np.log(np.linspace(1.0, 16.0, v.shape[0])) + 0.1 * a
        elif k in ("conv_w",):
            a = a * 0.2
        elif v.ndim == 2:
            a = a / np.sqrt(v.shape[0])
        else:
            a = a * 0.1
        w[k] = a.astype(np.float32)
    return w


def _params(w, dtype):
    """(reference, port) params: matrices in ``dtype``, 1-D leaves float32."""
    jdt, tdt = DTYPES[dtype]
    ref = {k: jnp.asarray(v, jdt if v.ndim >= 2 else jnp.float32)
           for k, v in w.items()}
    port = {k: torch.from_numpy(v).to(tdt if v.ndim >= 2 else torch.float32)
            for k, v in w.items()}
    return ref, port


@pytest.mark.parametrize("groups,chunk,s,init", [(1, 16, 64, False),
                                                 (2, 16, 64, True),
                                                 (1, 32, 32, False),
                                                 (4, 8, 48, True)])
def test_ssd_chunked_matches_reference(groups, chunk, s, init):
    rng = np.random.default_rng(1)
    b, h, p, n = 2, 8, 16, 12
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.5
    bb = rng.standard_normal((b, s, groups, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, groups, n)).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)).astype(np.float32) if init
          else None)
    want, wfinal = RSSM.ssd_chunked(
        *(jnp.asarray(t) for t in (x, a, bb, cc)), chunk,
        None if st is None else jnp.asarray(st))
    got, final = SSM.ssd_chunked(
        *(torch.from_numpy(t) for t in (x, a, bb, cc)), chunk,
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(final.numpy(), np.asarray(wfinal), **F32)


def test_segsum_and_softplus_match_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 16)).astype(np.float32)
    want = np.asarray(RSSM._segsum(jnp.asarray(a)))
    got = SSM._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)],
                               **F32)
    # softplus as jax.nn.softplus: logaddexp(x, 0), never the identity
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_array_equal(SSM.softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_causal_conv_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(24) * 0.1).astype(np.float32)
    want = RSSM._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(bias))
    got = SSM._causal_conv(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(w).to(tdt), torch.from_numpy(bias))
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch,groups", [("mamba2-370m", 1),
                                         ("mamba2-370m", 2),
                                         ("zamba2-2.7b", 1)])
def test_ssm_apply_matches_reference(arch, groups, dtype):
    rcfg, cfg = _cfgs(arch, n_groups=groups)
    w = _weights(rcfg)
    rp, pp = _params(w, dtype)
    jdt, tdt = DTYPES[dtype]
    u = np.random.default_rng(4).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    want = RSSM.ssm_apply(rp, rcfg, jnp.asarray(u, jdt))
    got = SSM.ssm_apply(pp, cfg, torch.from_numpy(u).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **(BLOCK if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_decode_matches_reference(groups, dtype):
    """Eight steps from a non-zero state, each step's output and state."""
    rcfg, cfg = _cfgs(n_groups=groups)
    w = _weights(rcfg)
    rp, pp = _params(w, dtype)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    shapes = SSM.decode_state_shapes(cfg, 3)
    state = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
             for k, s in shapes.items()}
    want_st = {k: jnp.asarray(v) for k, v in state.items()}
    got_st = {k: torch.from_numpy(v) for k, v in state.items()}
    assert {k: v.shape for k, v in RSSM.ssm_decode_state(rcfg, 3).items()} \
        == {k: tuple(v.shape) for k, v in
            SSM.ssm_decode_state(cfg, 3).items()}
    for t in range(8):
        u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        want, want_st = RSSM.ssm_decode(rp, rcfg, jnp.asarray(u, jdt),
                                        want_st)
        got, got_st = SSM.ssm_decode(pp, cfg, torch.from_numpy(u).to(tdt),
                                     got_st)
        assert got.dtype == tdt
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(_f32(got), _f32(want), **tol,
                                   err_msg=f"step {t}")
        for k in state:
            assert got_st[k].dtype == torch.float32
            np.testing.assert_allclose(got_st[k].numpy(),
                                       np.asarray(want_st[k]), **tol)


def test_decode_steps_equal_the_scan():
    """The recurrence and the chunked scan are one function (float32, the
    port alone): 32 steps of ``ssm_decode`` give ``ssm_apply``'s
    outputs."""
    _, cfg = _cfgs()
    _, pp = _params(_weights(cfg), "float32")
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    want = SSM.ssm_apply(pp, cfg, u)
    state = SSM.ssm_decode_state(cfg, 2)
    outs = []
    for t in range(32):
        y, state = SSM.ssm_decode(pp, cfg, u[:, t:t + 1], state)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), want, atol=2e-4,
                               rtol=1e-3)


def test_ssm_init_shapes_and_leaves():
    rcfg, cfg = _cfgs("zamba2-2.7b")
    want = jax.eval_shape(lambda: RSSM.ssm_init(jax.random.PRNGKey(0), rcfg,
                                                jnp.float32))
    p = SSM.ssm_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in want.items()}
    ref = RSSM.ssm_init(jax.random.PRNGKey(0), rcfg, jnp.float32)
    for k in ("conv_b", "a_log", "d_skip", "dt_bias", "norm"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6)
    assert abs(float(p["conv_w"].std()) - 0.2) < 0.02


def test_moe_ssm_fixture_matches_fresh_reference_generation():
    """Regenerate the MoE / SSM smoke fixture with the reference: the
    committed ``lm_smoke_moe_ssm.npz`` equals it array for array (the card
    has no JAX: ``chip_smoke.py``'s phase 8 reads the reference only from
    this file)."""
    import importlib.util
    import os

    from torch_port_util import FIXTURE_DIR, ROOT
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    fresh = tool.build_lm_moe_ssm()
    with np.load(os.path.join(FIXTURE_DIR, tool.LM_MOE_SSM_NAME)) as z:
        committed = {k: z[k] for k in z.files}
    assert fresh.keys() == committed.keys()
    for k in committed:
        assert fresh[k].dtype == committed[k].dtype, k
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
