"""SparseConv (paper §4.4) in the port against the reference.

The six contracts of ``tests/test_sparse_conv.py`` run on the port; then
weights carried from ``repro.core.layers.sparse_conv_init``: masks equal
(and equal to the port's own draw of the same ``mask_seed``), outputs and
batch-norm state in train and eval mode within atol 1e-5 of
``sparse_conv_apply`` (the same float32 arithmetic, summed in another
order), weight and input gradients within atol 1e-4 / rtol 1e-4 (sums
over the batch and the image in another order; a bias feeding a
train-mode batch norm has gradient 0, and both packages' are held under
1e-3), at ``in_channels`` 1 (first layer) and 4, stride 1 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread, t  # noqa: F401

from repro.core import layers as JL
from repro_torch.core import (SparseConv, SparseConvCfg,
                              sparse_conv_from_reference,
                              sparse_conv_to_reference)
from repro_torch.core import layers as PL
from repro_torch.core.lut_cost import (sparse_conv_dw_cost,
                                       sparse_conv_pw_cost)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uniform(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).uniform(0, 1, shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_sparse_conv.py's contracts
# ---------------------------------------------------------------------------

def test_forward_shapes_first_layer():
    cfg = SparseConvCfg(in_channels=1, out_channels=8, kernel_size=3,
                        stride=2, x_k=5, x_s=4, bw_in=2, bw_mid=2,
                        first_layer=True)
    mod = SparseConv(cfg, _gen(0)).train()
    y = mod(t(_uniform((4, 28, 28, 1), 1)))
    assert y.shape == (4, 13, 13, 8)
    assert bool(torch.isfinite(y).all())
    # first-layer rule: depthwise kernel count == out_channels (§4.4)
    assert mod.w_dw.shape[-1] == 8


def test_forward_shapes_mid_layer():
    cfg = SparseConvCfg(in_channels=6, out_channels=12, kernel_size=3,
                        stride=1, x_k=4, x_s=3)
    y = SparseConv(cfg, _gen(2)).train()(t(_uniform((2, 10, 10, 6), 3)))
    assert y.shape == (2, 8, 8, 12)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_matches_manual(stride):
    """The grouped conv equals an explicit per-channel correlation."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 7, 7, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3)).astype(np.float32)
    y = PL.depthwise(t(x), t(w), stride=stride, replicate=False).numpy()
    for c in range(3):
        for i in range(y.shape[1]):
            for j in range(y.shape[2]):
                patch = x[0, i * stride:i * stride + 3,
                          j * stride:j * stride + 3, c]
                assert y[0, i, j, c] == pytest.approx(
                    float((patch * w[:, :, c]).sum()), abs=1e-4)


def test_mask_sparsity_counts():
    cfg = SparseConvCfg(in_channels=6, out_channels=12, x_k=4, x_s=3)
    mod = SparseConv(cfg, _gen(6))
    dw = mod.mask_dw.numpy().reshape(9, 6)
    np.testing.assert_array_equal(dw.sum(axis=0), 4)    # x_k taps/kernel
    np.testing.assert_array_equal(mod.mask_pw.numpy().sum(axis=0), 3)


def test_conv_lut_costs_eq_4_3_4_4():
    assert sparse_conv_dw_cost(out_pix=169, o_bits=2, n_ofm=16, x_k=5,
                               i_bits=2) == 169 * 2 * 16 * 21
    assert sparse_conv_pw_cost(out_pix=169, o_bits=2, n_ofm=16, x_s=5,
                               i_bits=2) == 169 * 2 * 16 * 21
    kw = dict(in_channels=1, out_channels=16, first_layer=True)
    assert SparseConvCfg(**kw).luts(169, 2) == JL.SparseConvCfg(**kw).luts(
        169, 2)


def test_quantization_bounds_activations():
    cfg = SparseConvCfg(in_channels=1, out_channels=4, bw_in=2,
                        bw_mid=2, max_val_in=1.0, first_layer=True)
    x = np.random.default_rng(8).standard_normal((2, 8, 8, 1)) * 10
    y = SparseConv(cfg, _gen(7)).eval()(t(x.astype(np.float32)))
    assert bool(torch.isfinite(y).all())


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

CASES = [dict(in_channels=1, out_channels=16, stride=1, first_layer=True),
         dict(in_channels=1, out_channels=8, stride=2, x_k=4, x_s=3,
              first_layer=True),
         dict(in_channels=4, out_channels=8, stride=1),
         dict(in_channels=4, out_channels=6, stride=2, x_k=3, x_s=2)]


def _reference(kw, seed):
    cfg = JL.SparseConvCfg(**kw)
    layer = JL.sparse_conv_init(cfg, jax.random.PRNGKey(seed),
                                mask_seed=seed)
    return cfg, jax.tree.map(np.asarray, layer)


def _input(kw, seed):
    return _uniform((6, 12, 12, kw["in_channels"]), seed, scale=2.0)


@pytest.mark.parametrize("kw", CASES)
def test_masks_equal_reference(kw):
    _, layer = _reference(kw, seed=3)
    own = SparseConv(SparseConvCfg(**kw), _gen(0), mask_seed=3)
    np.testing.assert_array_equal(own.mask_dw.numpy(), layer["mask_dw"])
    np.testing.assert_array_equal(own.mask_pw.numpy(), layer["mask_pw"])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", CASES)
def test_carried_weights_match_reference(kw, train):
    jcfg, layer = _reference(kw, seed=1)
    x = _input(kw, seed=2)
    # eval mode with non-trivial running statistics: one train step first
    if not train:
        _, layer = JL.sparse_conv_apply(jcfg, layer, jnp.asarray(x),
                                        train=True)
        layer = jax.tree.map(np.asarray, layer)
    want, after = JL.sparse_conv_apply(jcfg, layer, jnp.asarray(x),
                                       train=train)
    mod = sparse_conv_from_reference(SparseConvCfg(**kw), layer,
                                     device="cpu").train(train)
    got = mod(t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    back = sparse_conv_to_reference(mod)
    for bn in ("bn1", "bn2"):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(back["bn_state"][bn][stat],
                                       np.asarray(after["bn_state"][bn][stat]),
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", CASES[::2])
def test_gradients_match_reference(kw):
    jcfg, layer = _reference(kw, seed=4)
    x = _input(kw, seed=5)
    r = np.random.default_rng(6).standard_normal(
        JL.sparse_conv_apply(jcfg, layer, jnp.asarray(x), train=True)[0]
        .shape).astype(np.float32)

    def loss(params, xx):
        y, _ = JL.sparse_conv_apply(jcfg, dict(layer, params=params), xx,
                                    train=True)
        return jnp.sum(y * r)

    gp, gx = jax.grad(loss, argnums=(0, 1))(layer["params"], jnp.asarray(x))
    mod = sparse_conv_from_reference(SparseConvCfg(**kw), layer,
                                     device="cpu").train()
    xt = t(x).requires_grad_()
    (mod(xt) * t(r)).sum().backward()
    for name in ("w_dw", "w_pw"):
        np.testing.assert_allclose(getattr(mod, name).grad.numpy(),
                                   np.asarray(gp[name]), atol=1e-4,
                                   rtol=1e-4)
    # each bias feeds a train-mode BN, which subtracts it again: its
    # gradient is 0 in exact arithmetic, and both packages' are rounding
    # residue of the batch sums
    for name in ("b_dw", "b_pw"):
        for g in (getattr(mod, name).grad.numpy(), np.asarray(gp[name])):
            assert np.abs(g).max() < 1e-3
    np.testing.assert_allclose(mod.bn2.scale.grad.numpy(),
                               np.asarray(gp["bn2"]["scale"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)


def test_round_trip_and_layouts():
    kw = CASES[2]
    _, layer = _reference(kw, seed=9)
    back = sparse_conv_to_reference(sparse_conv_from_reference(
        SparseConvCfg(**kw), layer, device="cpu"))
    flat = jax.tree_util.tree_leaves_with_path(layer)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


def test_float32_convs_restore_the_callers_setting(monkeypatch):
    """The TF32 switch is off inside the depthwise conv only, forward and
    both gradients, and the caller's setting comes back either way."""
    seen = []

    def spy(fn):
        def call(*a, **k):
            seen.append((fn.__name__, torch.backends.cudnn.allow_tf32))
            return fn(*a, **k)
        return call

    for mod, name in ((torch.nn.functional, "conv2d"),
                      (torch.nn.grad, "conv2d_input"),
                      (torch.nn.grad, "conv2d_weight")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    was = torch.backends.cudnn.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            x = t(_uniform((1, 6, 6, 2), 0)).requires_grad_()
            w = t(_uniform((3, 3, 2), 1)).requires_grad_()
            PL.depthwise(x, w, 1, False).sum().backward()
            assert torch.backends.cudnn.allow_tf32 == setting
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert sorted(seen) == sorted(
        [("conv2d", False), ("conv2d_input", False),
         ("conv2d_weight", False)] * 2)
