"""The MNIST family in the port against the reference: procedural digits,
the Table 7.1 configurations, the whole LUT-cost model, and a narrow
Table 7.1-style MLP (``mlp((64, 64), 2, 5)`` on the 784 pixel inputs)
through tables and training.

Tolerances: data, configurations, costs, truth tables and table-path
codes exact; the dense head's logits atol 1e-5 / rtol 1e-5 (float32 in
another summation order); 20 training steps from the reference's init
rtol 1e-3 on every loss, as ``tests/test_torch_train.py`` holds for
model A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401

from repro.configs import mnist as JM
from repro.core import logicnet as JLN
from repro.core import lut_cost as JC
from repro.core.train import train_logicnet as j_train
from repro.data.pipeline import mnist_like_data as j_mnist
from repro_torch.configs import mnist as PM
from repro_torch.core import logicnet as PLN
from repro_torch.core import lut_cost as PC
from repro_torch.core.train import train_logicnet as p_train
from repro_torch.data import mnist_like_data

NARROW = ((64, 64), 2, 5)


@pytest.mark.parametrize("seed", [0, 7])
def test_mnist_like_data_is_identical(seed):
    x, y = mnist_like_data(64, seed)
    jx, jy = j_mnist(64, seed)
    assert x.shape == (64, 28, 28, 1) and x.dtype == np.float32
    assert y.dtype == np.int32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_table_7_1_and_luts_equal_reference():
    assert PM.TABLE_7_1 == JM.TABLE_7_1
    assert (PM.IN_FEATURES, PM.N_CLASSES) == (JM.IN_FEATURES, JM.N_CLASSES)
    for hidden, bw, fan_in in PM.TABLE_7_1 + [NARROW]:
        p, j = PM.mlp(hidden, bw, fan_in), JM.mlp(hidden, bw, fan_in)
        assert p.luts() == j.luts() and p.total_luts() == j.total_luts()
        assert [dataclass_fields(c) for c in p.layer_cfgs()] == [
            dataclass_fields(c) for c in j.layer_cfgs()]
    skips = ((0, 1),)
    assert (PM.mlp((64, 64), 2, 5, skips).luts()
            == JM.mlp((64, 64), 2, 5, skips).luts())
    # the widest row: 86 016 LUTs a sparse layer, 175 400 for the head
    widest = PM.mlp((2048, 2048, 2048), 2, 5)
    assert widest.luts() == [86016, 86016, 86016, 175400]


def dataclass_fields(cfg):
    import dataclasses
    return (type(cfg).__name__, dataclasses.astuple(cfg))


# Table 2.1's fan-in bits (1-12) and the widths the models use
BITS = list(range(1, 25))
OUT_BITS = [1, 2, 3, 4, 8, 16]


def test_lut_cost_functions_equal_reference():
    for n in BITS:
        assert PC.lut_cost_per_bit(n) == JC.lut_cost_per_bit(n)
        assert PC.static_mapping_row(n) == PC.StaticMappingRow(
            *JC.static_mapping_row(n).__dict__.values())
        for m in OUT_BITS:
            assert PC.lut_cost(n, m) == JC.lut_cost(n, m)
            assert PC.lut_cost_recursive(n, m) == JC.lut_cost_recursive(n, m)
            assert PC.lut_cost_recursive(n, m) == PC.lut_cost(n, m)
            assert PC.truth_table_bits(n, m) == JC.truth_table_bits(n, m)
            assert (PC.truth_table_output_bits(n, m)
                    == JC.truth_table_output_bits(n, m))
            assert PC.code_width(n) == JC.code_width(n)
    for args in [(64, 3, 3, 3), (2048, 5, 2, 2), (5, 6, 2, 4), (10, 1, 1, 1)]:
        assert PC.sparse_linear_cost(*args) == JC.sparse_linear_cost(*args)
    for args in [(10, 2048, 2, 4), (5, 64, 3, 4), (1, 1, 1, 1)]:
        assert (PC.dense_quant_linear_cost(*args)
                == JC.dense_quant_linear_cost(*args))
    for out_pix, o_bits, n_ofm, x, i_bits in [(169, 2, 16, 5, 2),
                                              (676, 2, 16, 4, 2),
                                              (36, 3, 32, 3, 3)]:
        assert (PC.sparse_conv_dw_cost(out_pix, o_bits, n_ofm, x, i_bits)
                == JC.sparse_conv_dw_cost(out_pix, o_bits, n_ofm, x, i_bits))
        assert (PC.sparse_conv_pw_cost(out_pix, o_bits, n_ofm, x, i_bits)
                == JC.sparse_conv_pw_cost(out_pix, o_bits, n_ofm, x, i_bits))
        for k in (1, 3):
            assert (PC.dense_conv_cost(out_pix, o_bits, n_ofm, 2, k, i_bits)
                    == JC.dense_conv_cost(out_pix, o_bits, n_ofm, 2, k,
                                          i_bits))
    # Table 2.1 itself (fan-in 6-12)
    rows = [PC.static_mapping_row(n) for n in range(6, 13)]
    assert [r.n_6luts for r in rows] == [1, 3, 5, 11, 21, 43, 85]


def _data(n_train=1200, n_test=300):
    """``benchmarks/paper_tables.py``'s MNIST data: flattened, centred."""
    x, y = mnist_like_data(n_train + n_test, seed=0)
    x = x.reshape(len(x), -1)
    x = (x - x.mean()) / (x.std() + 1e-6)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


@pytest.fixture(scope="module")
def trained():
    """The reference's 20-step run of the narrow MLP, its init, and the
    data."""
    xt, yt, xv, yv = _data()
    cfg = JM.mlp(*NARROW)
    init = jax.tree.map(np.asarray, JLN.init(cfg, jax.random.PRNGKey(0),
                                             mask_seed=0))
    ref = j_train(cfg, xt, yt, xv, yv, steps=20, lr=5e-3, seed=0)
    return dict(init=init, ref=ref, model=jax.tree.map(np.asarray,
                                                       ref.model),
                data=(xt, yt, xv, yv))


def test_training_matches_reference(trained):
    xt, yt, xv, yv = trained["data"]
    net = PLN.from_reference(PM.mlp(*NARROW), trained["init"], device="cpu")
    res = p_train(PM.mlp(*NARROW), xt, yt, xv, yv, steps=20, lr=5e-3,
                  seed=0, device="cpu", net=net)
    assert len(res.losses) == 20
    np.testing.assert_allclose(res.losses, trained["ref"].losses, rtol=1e-3)


def test_tables_and_head_from_carried_weights(trained):
    cfg, pcfg = JM.mlp(*NARROW), PM.mlp(*NARROW)
    model = trained["model"]
    want = JLN.generate_tables(cfg, model)
    net = PLN.from_reference(pcfg, model, device="cpu")
    got = PLN.generate_tables(net)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.table.shape == (64, 1024)
        np.testing.assert_array_equal(g.table, w.table)
        np.testing.assert_array_equal(g.indices, w.indices)
        assert (g.bw_in, g.bw_out) == (w.bw_in, w.bw_out)
    xv = trained["data"][2][:200]
    head = JLN.sparse_head_forward(cfg, model, want, jnp.asarray(xv))
    for fused in (False, True):
        np.testing.assert_allclose(
            PLN.sparse_head_forward(net, got, xv, fused=fused).numpy(),
            np.asarray(head), atol=1e-5, rtol=1e-5)
    f_codes, t_codes = PLN.verify_tables(net, got, xv)
    assert torch.equal(f_codes, t_codes)


def test_train_mnist_cli_on_cpu(tmp_path, capsys):
    """The MNIST CLI's flow on Table 7.1's narrowest row, a few steps: the
    tables verified exactly, and a per-layer artifact (its slabs pass the
    fused budget) written and loaded back; the CLI's data are the test's
    recipe at the reference table's sizes."""
    from repro_torch import engine
    from repro_torch.launch import train_mnist_logicnet as cli

    cli.main(["--row", "0", "--steps", "3", "--device", "cpu", "--out",
              str(tmp_path)])
    out = capsys.readouterr().out
    assert "model mnist: HL=(512,) BW=2 X=6" in out
    assert "truth-table functional verification: EXACT" in out
    assert "serving artifact: layout=per_layer" in out
    assert "serving artifact verification: EXACT" in out
    assert "AUC-ROC[9]" in out
    net = engine.load(str(tmp_path / "logicnet_mnist.npz"), device="cpu")
    assert (net.layout, net.n_in, net.n_out) == ("per_layer", 784, 512)
    xt, _, xv, _ = cli.mnist_data()
    assert xt.shape == (4000, 784) and xv.shape == (800, 784)
    np.testing.assert_array_equal(xt, _data(4000, 800)[0])
