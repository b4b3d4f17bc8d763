"""Table 7.4's training loop in the port (``paper_tables.train_conv_head``:
SparseConv plus a LogicNet head, stepped together by the port's AdamW)
against the reference's loop in ``benchmarks/paper_tables.py::table_7_4``,
from the same weights on the same index stream.

The reference's loop lives inside its table function, so its step and
predict are restated here as they stand there.  The reference's
``sparse_conv_init`` / ``LN.init`` weights are carried into the port;
both loops take ``STEPS`` steps on the table's own data.  Held: every
step's loss rtol 1e-3 (float32 in another summation order, as
``tests/test_torch_mnist.py`` holds the MLP's losses); every parameter
moved and every batch norm's running statistics updated; the running
variances rtol 1e-3; and the eval pass (``conv_head_logits``) on the
reference's trained state, logits atol 1e-5 / rtol 1e-5.

Not held: the logits after each package's own training, nor the biases
and running means.  Every bias here feeds a train-mode batch norm, so its
gradient is 0 in exact arithmetic and only rounding residue in either
package; AdamW scales that residue to steps of about +-lr whose signs
follow the summation order.  The biases, and the running means that
absorb them, drift apart by about lr a step, and the eval logits by
tenths after 4 steps.  The same drift through Adam's normalisation of
other near-zero gradients bounds ``STEPS``: at 8 steps FP_X_DW's losses
are 4e-3 apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import one_torch_thread  # noqa: F401

from repro.core import layers as JL
from repro.core import logicnet as JLN
from repro.optim.adamw import AdamWCfg, adamw_update, init_opt_state
from repro_torch.core import logicnet as PLN
from repro_torch.core.layers import (sparse_conv_from_reference,
                                     sparse_conv_to_reference)
from repro_torch.data import mnist_like_data
from repro_torch.launch import paper_tables as PPT

STEPS = 4


def _reference_cfgs(variant):
    """The configurations of ``benchmarks/paper_tables.py::table_7_4``."""
    cc = JL.SparseConvCfg(in_channels=1, out_channels=16, kernel_size=3,
                          stride=2,
                          x_k=9 if variant in ("FP", "FP_DW") else 5,
                          x_s=16 if variant in ("FP", "FP_DW") else 5,
                          bw_in=8 if variant != "QUANT_X_DW" else 2,
                          bw_mid=8 if variant != "QUANT_X_DW" else 2,
                          first_layer=True)
    head_cfg = JLN.LogicNetCfg(16 * 13 * 13, 10, hidden=(128,), fan_in=6,
                               bw=2, final_dense=True, bw_fc=2)
    return cc, head_cfg


def _reference_loop(cc, conv, head_cfg, head, data, budget):
    """The reference table's loop: each step's loss, the held-out logits,
    and the final parameters and batch-norm state."""
    xt, yt, xv, _ = data
    params = {"conv": conv["params"], "head": [l["params"] for l in head]}
    opt = init_opt_state(params)
    ocfg = AdamWCfg(lr=5e-3, clip_norm=1.0)
    conv_masks = {"dw": conv["mask_dw"], "pw": conv["mask_pw"]}
    head_masks = [l.get("mask") for l in head]
    state = {"conv_bn": conv["bn_state"],
             "head_bn": [l.get("bn_state") for l in head]}

    def model(params, state):
        cl = {"params": params["conv"], "mask_dw": conv_masks["dw"],
              "mask_pw": conv_masks["pw"], "bn_state": state["conv_bn"]}
        mdl = [{"params": p, **({"mask": m} if m is not None else {}),
                "bn_state": s}
               for p, m, s in zip(params["head"], head_masks,
                                  state["head_bn"])]
        return cl, mdl

    @jax.jit
    def step(params, opt, state, xb, yb):
        def loss(params):
            cl, mdl = model(params, state)
            h, cl2 = JL.sparse_conv_apply(cc, cl, xb, train=True)
            h = h.reshape(h.shape[0], -1)
            nll, mdl2 = JLN.loss_fn(head_cfg, mdl, h, yb, train=True)
            return nll, (cl2["bn_state"], [l["bn_state"] for l in mdl2])

        (nll, (cbn, hbn)), g = jax.value_and_grad(loss, has_aux=True)(
            params)
        new_p, new_o = adamw_update(ocfg, params, g, opt)
        return new_p, new_o, {"conv_bn": cbn, "head_bn": hbn}, nll

    rng = np.random.default_rng(0)
    losses = []
    for _ in range(budget):
        idx = rng.integers(0, len(xt), 128)
        params, opt, state, nll = step(params, opt, state,
                                       jnp.asarray(xt[idx]),
                                       jnp.asarray(yt[idx]))
        losses.append(float(nll))

    cl, mdl = model(params, state)
    h, _ = JL.sparse_conv_apply(cc, cl, jnp.asarray(xv), train=False)
    logits, _ = JLN.forward(head_cfg, mdl, h.reshape(h.shape[0], -1),
                            train=False)
    return (np.array(losses), np.asarray(logits),
            jax.tree.map(np.asarray, cl), jax.tree.map(np.asarray, mdl))


@pytest.fixture(scope="module")
def data():
    """The table's own data (``mnist_like_data(2400, seed=1)``)."""
    x, y = mnist_like_data(2400, seed=1)
    return x[:2000], y[:2000], x[2000:], y[2000:]


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("variant", ["FP_DW", "FP_X_DW", "QUANT_X_DW"])
def test_train_conv_head_matches_reference(variant, data):
    cc, head_cfg = _reference_cfgs(variant)
    assert dataclasses.astuple(PPT.conv_cfg(variant)) == (
        dataclasses.astuple(cc))
    assert dataclasses.astuple(PPT.conv_head_cfg()) == (
        dataclasses.astuple(head_cfg))
    # the optimiser as a value: under AdamW a clip scales every step's
    # gradient alike, which the moments' ratio all but cancels
    assert dataclasses.astuple(PPT.CONV_HEAD_OPT) == dataclasses.astuple(
        AdamWCfg(lr=5e-3, clip_norm=1.0))
    conv = jax.tree.map(np.asarray,
                        JL.sparse_conv_init(cc, jax.random.PRNGKey(11)))
    head = jax.tree.map(np.asarray,
                        JLN.init(head_cfg, jax.random.PRNGKey(12)))
    want_losses, want_logits, want_conv, want_head = _reference_loop(
        cc, conv, head_cfg, head, data, STEPS)

    pconv = sparse_conv_from_reference(PPT.conv_cfg(variant), conv,
                                       device="cpu")
    phead = PLN.from_reference(PPT.conv_head_cfg(), head, device="cpu")
    losses, logits = PPT.train_conv_head(pconv, phead, data, STEPS)

    assert losses.shape == (STEPS,) and logits.shape == (400, 10)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    got = {"conv": sparse_conv_to_reference(pconv),
           "head": PLN.to_reference(phead)}
    init = {"conv": conv, "head": head}
    want = {"conv": want_conv, "head": want_head}
    # every parameter was stepped and every running statistic updated
    for key, now in _leaves(got).items():
        if "mask" not in key:
            assert not np.array_equal(now, _leaves(init)[key]), key
    # running variances (a bias before the norm does not enter them)
    for key, now in _leaves(got).items():
        if key.endswith("['var']"):
            np.testing.assert_allclose(now, _leaves(want)[key], rtol=1e-3,
                                       err_msg=key)
    # the eval pass on the reference's trained state
    pconv = sparse_conv_from_reference(PPT.conv_cfg(variant), want_conv,
                                       device="cpu")
    phead = PLN.from_reference(PPT.conv_head_cfg(), want_head, device="cpu")
    np.testing.assert_allclose(
        PPT.conv_head_logits(pconv, phead, data[2]).numpy(), want_logits,
        atol=1e-5, rtol=1e-5)
