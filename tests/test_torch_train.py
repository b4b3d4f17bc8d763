"""The port's optimizer, training loop and training entry point against the
reference.

Inputs are made with numpy from a seed (or read from the reference-made
fixture) and handed to both packages.  Tolerances: AdamW atol 1e-6 per
step (the same float32 operations, sums in another order); training losses
over 10 steps rtol 1e-4 (float summation order only: no quantized
activation crosses a code boundary on this data), final masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_train, one_torch_thread  # noqa: F401

from repro.configs import fpga4hep as J_cfgs
from repro.core.train import auc_roc_ovr as j_auc
from repro.core.train import train_logicnet as j_train
from repro.data import jet_substructure_data
from repro.optim import adamw as JA
from repro_torch import engine
from repro_torch.configs import fpga4hep as P_cfgs
from repro_torch.core import logicnet as PLN
from repro_torch.core.train import auc_roc_ovr as p_auc
from repro_torch.core.train import train_logicnet as p_train
from repro_torch.launch import train_jsc_logicnet
from repro_torch.optim import adamw as PA


@pytest.fixture(scope="module")
def data():
    x, y = jet_substructure_data(8000, seed=0)
    return x[:7000], y[:7000], x[7000:], y[7000:]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"a": {"w": rng.standard_normal((6, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "c": rng.standard_normal((3, 5)).astype(np.float32)}


def _flat(tree):
    return {"a.w": tree["a"]["w"], "a.b": tree["a"]["b"], "c": tree["c"]}


@pytest.mark.parametrize("cfg_kw", [
    dict(lr=1e-2),
    dict(lr=3e-3, weight_decay=0.1, clip_norm=0.5),
    dict(lr=1e-2, clip_norm=0.0),
])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_matches_step_for_step(cfg_kw, scheduled):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    mask = (rng.random((6, 4)) < 0.5).astype(np.float32)
    params["a"]["w"] *= mask
    jcfg = JA.AdamWCfg(**cfg_kw, schedule=(JA.cosine_schedule(2, 5)
                                           if scheduled else None))
    pcfg = PA.AdamWCfg(**cfg_kw, schedule=(PA.cosine_schedule(2, 5)
                                           if scheduled else None))
    jp = jax.tree.map(jnp.asarray, params)
    js = JA.init_opt_state(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    ps = PA.init_opt_state(pp)
    jmask = jnp.asarray(mask)

    def j_mask_fn(path, _):
        return jmask if path == "['a']['w']" else None

    def p_mask_fn(name, _):
        return torch.from_numpy(mask) if name == "a.w" else None

    for step in range(6):
        grads = _tree(np.random.default_rng(10 + step))
        grads["c"] *= 3.0
        jp, js = JA.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, grads),
                                 js, mask_fn=j_mask_fn)
        PA.adamw_update(pcfg, pp, {k: torch.from_numpy(v) for k, v in
                                   _flat(grads).items()}, ps,
                        mask_fn=p_mask_fn)
        for k, v in _flat(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(pp[k].numpy(), v, atol=1e-6,
                                       rtol=1e-6)
        for k, v in _flat(jax.tree.map(np.asarray, js["m"])).items():
            np.testing.assert_allclose(ps["m"][k].numpy(), v, atol=1e-6)
        assert int(ps["step"]) == int(js["step"])
    # pruned weights stay exactly zero
    assert (pp["a.w"].numpy()[mask == 0] == 0).all()


def test_adamw_freezes_masks_and_global_norm():
    p = {"w": torch.ones(3), "mask": torch.ones(3)}
    g = {"w": torch.full((3,), 2.0), "mask": torch.full((3,), 5.0)}
    state = PA.init_opt_state(p)
    PA.adamw_update(PA.AdamWCfg(lr=0.1), p, g, state)
    assert torch.equal(p["mask"], torch.ones(3))
    assert not torch.equal(p["w"], torch.ones(3))
    tensors = [np.arange(4, dtype=np.float32), np.ones((2, 2), np.float32)]
    assert float(PA.global_norm([torch.from_numpy(t) for t in tensors])) \
        == pytest.approx(float(JA.global_norm([jnp.asarray(t)
                                               for t in tensors])))


def test_cosine_schedule_matches():
    steps = np.arange(0, 12, dtype=np.float32)
    j = JA.cosine_schedule(3, 10, 0.2)(jnp.asarray(steps))
    p = PA.cosine_schedule(3, 10, 0.2)(torch.from_numpy(steps))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-7)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["apriori", "iterative", "momentum"])
def test_train_logicnet_matches_reference(data, method):
    """10 steps of model A from the reference's init: the same losses
    (rtol 1e-4) and, after the step-5 prune, the same masks."""
    xt, yt, xv, yv = data
    cfg = J_cfgs.model_a()
    ref = j_train(cfg, xt, yt, xv, yv, method=method, steps=10, seed=0)
    init = PLN.reference_from_arrays(load_train(), "init")
    net = PLN.from_reference(P_cfgs.model_a(), init, device="cpu")
    res = p_train(P_cfgs.model_a(), xt, yt, xv, yv, method=method,
                  steps=10, seed=0, device="cpu", net=net)
    assert res.model is net and len(res.losses) == 10
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)
    back = PLN.to_reference(res.model)
    for i in range(3):
        np.testing.assert_array_equal(back[i]["mask"],
                                      np.asarray(ref.model[i]["mask"]))
        assert (back[i]["mask"].sum(0) == 3).all()
        assert (back[i]["params"]["w"][back[i]["mask"] == 0] == 0).all()
    assert 0.0 <= res.accuracy <= 1.0


def test_twenty_step_losses_match_fixture(data):
    """The fixture's 20-step apriori run, from its carried init."""
    xt, yt, xv, yv = data
    fx = load_train()
    net = PLN.from_reference(P_cfgs.model_a(),
                             PLN.reference_from_arrays(fx, "init"),
                             device="cpu")
    res = p_train(P_cfgs.model_a(), xt, yt, xv, yv, steps=20, seed=0,
                  device="cpu", net=net)
    np.testing.assert_allclose(res.losses, fx["losses"], rtol=1e-4)


def test_train_from_own_init_is_seeded(data):
    xt, yt, xv, yv = data
    runs = [p_train(P_cfgs.model_a(), xt, yt, xv, yv, steps=3, seed=1,
                    device="cpu") for _ in range(2)]
    assert runs[0].losses == runs[1].losses
    with pytest.raises(ValueError, match="method"):
        p_train(P_cfgs.model_a(), xt, yt, xv, yv, steps=1, method="magic",
                device="cpu")


def test_auc_matches_reference(data):
    _, _, xv, yv = data
    model = PLN.reference_from_arrays(load_train(), "trained")
    want = j_auc(J_cfgs.model_a(), model, xv, yv)
    got = p_auc(PLN.from_reference(P_cfgs.model_a(), model, device="cpu"),
                xv, yv)
    assert got.keys() == want.keys()
    for c in want:
        assert got[c] == pytest.approx(want[c], abs=1e-6)


def test_entry_point_on_cpu(tmp_path, capsys):
    train_jsc_logicnet.main(["--model", "A", "--steps", "4", "--device",
                             "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "truth-table functional verification: EXACT" in out
    assert "serving artifact verification: EXACT" in out
    assert "AUC-ROC[t]" in out and "minimization proxy" in out
    # the default --optimize-level 2 compiles once: its summary, the
    # optimized tables verified, and a mixed artifact built from them
    assert "truth-table compiler: level=2 " in out
    assert "optimized-table functional verification: EXACT" in out
    net = engine.load(str(tmp_path / "logicnet_A.npz"), device="cpu")
    assert net.layout == "mixed" and (net.n_in, net.n_out) == (16, 64)
    assert net.stats is not None and net.stats.level == 2
    # the reference reads the artifact the port wrote
    from repro import engine as jengine
    ref_net = jengine.load(str(tmp_path / "logicnet_A.npz"))
    codes = np.random.default_rng(0).integers(0, 8, (20, 16), np.int32)
    np.testing.assert_array_equal(net(torch.from_numpy(codes)).numpy(),
                                  np.asarray(ref_net(codes)))
