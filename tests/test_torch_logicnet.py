"""The port's LogicNet core (quantize, sparsity, layers, truth tables,
table inference, network assembly) against the reference.

Every input is made with numpy from a seed, or read from the committed
fixture ``tests/fixtures/torch_port/model_a_train.npz`` (made by the
reference), and handed to both packages.  Tolerances: integer results
(codes, masks, indices, truth tables, LUT counts) are exact; quantized
values and STE gradients are exact (the same float32 operations); batch
norm atol 1e-6 and logits atol 1e-5 (sums taken in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_train, one_torch_thread  # noqa: F401

from repro.configs import fpga4hep as J_cfgs
from repro.core import layers as JL
from repro.core import logicnet as JLN
from repro.core import lut_cost as JC
from repro.core import sparsity as JS
from repro.core import table_infer as JTI
from repro.core import truth_table as JTT
from repro.data import jet_substructure_data as j_jet
from repro_torch.configs import fpga4hep as P_cfgs
from repro_torch.core import layers as PL
from repro_torch.core import logicnet as PLN
from repro_torch.core import lut_cost as PC
from repro_torch.core import quantize as PQ
from repro_torch.core import sparsity as PS
from repro_torch.core import table_infer as PTI
from repro_torch.core import truth_table as PTT
from repro_torch.data import jet_substructure_data as p_jet

# ``repro.core`` re-exports a function named ``quantize``: take the module
JQ = importlib.import_module("repro.core.quantize")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def fixture():
    return load_train()


@pytest.fixture(scope="module")
def held_out():
    x, y = j_jet(8000, 0)
    return x[7000:], y[7000:]


# ---------------------------------------------------------------------------
# data, costs, configs
# ---------------------------------------------------------------------------

def test_jet_data_is_identical():
    for n, seed in ((100, 0), (257, 3)):
        for a, b in zip(j_jet(n, seed), p_jet(n, seed)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_lut_costs_match():
    for n in range(1, 20):
        assert PC.lut_cost_per_bit(n) == JC.lut_cost_per_bit(n)
        assert PC.lut_cost(n, 3) == JC.lut_cost(n, 3)
    for bits in (1, 8, 9, 16, 17):
        assert PC.code_width(bits) == JC.code_width(bits)
    assert (PC.dense_quant_linear_cost(5, 64, 3, 4)
            == JC.dense_quant_linear_cost(5, 64, 3, 4))
    with pytest.raises(ValueError):
        PC.lut_cost_per_bit(0)


@pytest.mark.parametrize("name", list("ABCDE"))
def test_configs_match(name):
    j, p = J_cfgs.MODELS[name](), P_cfgs.MODELS[name]()
    assert p.luts() == j.luts() and p.total_luts() == j.total_luts()
    assert ([type(c).__name__ for c in p.layer_cfgs()]
            == [type(c).__name__ for c in j.layer_cfgs()])
    for pc, jc in zip(p.layer_cfgs(), j.layer_cfgs()):
        assert vars(pc) == vars(jc)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def _quant_inputs(max_val):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1.5 * max_val, 1.5 * max_val, 2000),
        np.linspace(-1.2 * max_val, 1.2 * max_val, 1201),
        [0.0, -0.0, max_val, -max_val]]).astype(np.float32)
    return x


@pytest.mark.parametrize("bw,max_val", [(1, 1.0), (2, 2.0), (3, 2.0),
                                        (4, 1.5)])
def test_quantize_codes_and_ste_match(bw, max_val):
    jcfg, pcfg = JQ.QuantizerCfg(bw, max_val), PQ.QuantizerCfg(bw, max_val)
    x = _quant_inputs(max_val)
    # exact half-steps of the grid too
    x = np.concatenate([x, ((np.arange(2 ** bw) + 0.5)
                            * np.float32(jcfg.step)).astype(np.float32)])
    cot = np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    jq = JQ.quantize(jcfg, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    pq = PQ.quantize(pcfg, tx)
    np.testing.assert_array_equal(pq.value.detach().numpy(),
                                  np.asarray(jq.value))
    assert float(pq.scale) == float(jq.scale) and pq.bit_width == bw
    np.testing.assert_array_equal(PQ.codes(pcfg, _t(x)).numpy(),
                                  np.asarray(JQ.codes(jcfg, jnp.asarray(x))))
    c = np.array(JQ.all_codes(jcfg))
    np.testing.assert_array_equal(PQ.all_codes(pcfg).numpy(), c)
    np.testing.assert_array_equal(
        PQ.dequantize_code(pcfg, torch.from_numpy(c)).numpy(),
        np.asarray(JQ.dequantize_code(jcfg, jnp.asarray(c))))
    # code -> value -> code round-trips exactly
    np.testing.assert_array_equal(
        PQ.codes(pcfg, PQ.dequantize_code(pcfg, torch.from_numpy(c))).numpy(),
        c)
    # the STE gradient, including 0.5 at exact ties with a clip bound
    want = jax.grad(lambda v: jnp.sum(JQ.quantize(jcfg, v).value * cot))(
        jnp.asarray(x))
    (pq.value * _t(cot)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))


def test_clip_gradient_is_half_at_bound_ties():
    x = torch.tensor([0.0, 1.0, 2.0], requires_grad=True)
    PQ.quantize(PQ.QuantizerCfg(3, 2.0), x).value.sum().backward()
    assert x.grad.tolist() == [0.5, 1.0, 0.5]


# ---------------------------------------------------------------------------
# sparsity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_in,n_out,fan_in", [
    (0, 16, 64, 3), (1, 64, 64, 3), (5, 10, 7, 10)])
def test_apriori_mask_and_indices_match(seed, n_in, n_out, fan_in):
    jm = np.asarray(JS.apriori_mask(seed, n_in, n_out, fan_in))
    pm = PS.apriori_mask(seed, n_in, n_out, fan_in)
    np.testing.assert_array_equal(pm.numpy(), jm)
    np.testing.assert_array_equal(PS.mask_to_indices(pm),
                                  JS.mask_to_indices(jm))
    with pytest.raises(ValueError):
        PS.apriori_mask(seed, n_in, n_out, n_in + 1)


def test_mask_to_indices_refuses_ragged_fan_in():
    m = np.zeros((4, 2), np.float32)
    m[0, 0] = m[1, 1] = m[2, 1] = 1
    with pytest.raises(ValueError, match="non-uniform"):
        PS.mask_to_indices(torch.from_numpy(m))


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.7, 1.0])
def test_iterative_prune_matches(frac):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((20, 9)).astype(np.float32)
    w[:4] = 0.5                              # ties within every column
    mask = (rng.random((20, 9)) < 0.8).astype(np.float32)
    want = JS.iterative_prune_mask(jnp.asarray(w), jnp.asarray(mask), 3,
                                   frac)
    got = PS.iterative_prune_mask(_t(w), _t(mask), 3, frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prune_rate", [0.3, 0.5, 1.0])
def test_sparse_momentum_step_matches(prune_rate):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    mom = rng.standard_normal((16, 12)).astype(np.float32)
    mom[::3] = 0.25                          # ties among regrow candidates
    mask = np.asarray(JS.apriori_mask(2, 16, 12, 4))
    want = JS.sparse_momentum_step(jnp.asarray(w * mask), jnp.asarray(mom),
                                   jnp.asarray(mask), 4, prune_rate)
    got = PS.sparse_momentum_step(_t(w * mask), _t(mom), _t(mask), 4,
                                  prune_rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(0) == 4).all()


def test_momentum_helpers_match():
    rng = np.random.default_rng(5)
    ms = [rng.standard_normal((6, 4)).astype(np.float32) for _ in range(3)]
    ks = [(rng.random((6, 4)) < 0.5).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(
        PS.mean_momentum_contributions([_t(m) for m in ms],
                                       [_t(k) for k in ks]).numpy(),
        np.asarray(JS.mean_momentum_contributions(
            [jnp.asarray(m) for m in ms], [jnp.asarray(k) for k in ks])),
        rtol=1e-6)
    np.testing.assert_allclose(
        PS.momentum_ema(_t(ms[0]), _t(ms[1]), 0.8).numpy(),
        np.asarray(JS.momentum_ema(jnp.asarray(ms[0]), jnp.asarray(ms[1]),
                                   0.8)), rtol=1e-6)
    dims = [(16, 64), (64, 64), (64, 5)]
    assert (PS.erdos_renyi_sparsity(dims, 2.0)
            == JS.erdos_renyi_sparsity(dims, 2.0))
    for s in (0.0, 0.5, 0.95, 1.0):
        assert (PS.fan_in_from_sparsity(64, s)
                == JS.fan_in_from_sparsity(64, s))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_batch_norm_matches_train_and_eval():
    rng = np.random.default_rng(6)
    x = (3 * rng.standard_normal((256, 64)) + 1).astype(np.float32)
    jp, js = JL.bn_init(64)
    jp = {"scale": jnp.asarray(rng.uniform(0.5, 2, 64).astype(np.float32)),
          "bias": jnp.asarray(rng.standard_normal(64).astype(np.float32))}
    bn = PL.BatchNorm(64)
    with torch.no_grad():
        bn.scale.copy_(_t(jp["scale"]))
        bn.bias.copy_(_t(jp["bias"]))
    for _ in range(3):                       # running stats accumulate
        jy, js = JL.bn_apply(jp, js, jnp.asarray(x), train=True)
        py = bn.train()(_t(x))
        np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(js["mean"]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(js["var"]),
                                   atol=1e-6, rtol=1e-6)
        x = x * 0.5 + 0.25
    jy, _ = JL.bn_apply(jp, js, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn.eval()(_t(x)).detach().numpy(),
                               np.asarray(jy), atol=1e-6, rtol=1e-6)
    scale, bias = JL.bn_eval_fn(jp, js)
    ps, pb = bn.eval_affine()
    np.testing.assert_allclose(ps.numpy(), np.asarray(scale), atol=1e-6)
    np.testing.assert_allclose(pb.numpy(), np.asarray(bias), atol=1e-6)


def test_batch_norm_is_not_torch_batchnorm1d():
    """The running variance is the biased one (``jnp.var``)."""
    x = torch.tensor([[0.0], [2.0]])
    bn = PL.BatchNorm(1).train()
    bn(x)
    assert bn.var.item() == pytest.approx(0.9 * 1 + 0.1 * 1.0)


# ---------------------------------------------------------------------------
# the network: carried weights, forward, tables, verification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["init", "trained"])
def test_forward_logits_and_codes_match(fixture, held_out, prefix):
    cfg, pcfg = J_cfgs.model_a(), P_cfgs.model_a()
    model = PLN.reference_from_arrays(fixture, prefix)
    net = PLN.from_reference(pcfg, model, device="cpu")
    xv, yv = held_out
    want, _ = JLN.forward(cfg, model, jnp.asarray(xv))
    got = PLN.forward(net, xv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    assert PLN.accuracy(net, xv, yv) == pytest.approx(
        float(JLN.accuracy(cfg, model, jnp.asarray(xv), jnp.asarray(yv))),
        abs=1e-3)
    # every sparse layer's output codes, exact
    h_j, h_p = jnp.asarray(xv), torch.from_numpy(xv)
    cfgs = cfg.layer_cfgs()
    for i in range(3):
        h_j, _ = JL.sparse_linear_apply(cfgs[i], model[i], h_j)
        with torch.no_grad():
            h_p = net.eval().layers[i](h_p)
        q = cfgs[i + 1].in_quant
        np.testing.assert_array_equal(
            PQ.codes(PQ.QuantizerCfg(q.bit_width, q.max_val), h_p).numpy(),
            np.asarray(JQ.codes(q, h_j)))
    # a train-mode forward updates BN state as the reference does
    _, new_model = JLN.forward(cfg, model, jnp.asarray(xv[:256]), train=True)
    PLN.forward(net, xv[:256], train=True)
    assert not net.training
    for layer, d in zip(PLN.to_reference(net), new_model):
        for k in ("mean", "var"):
            np.testing.assert_allclose(layer["bn_state"][k],
                                       np.asarray(d["bn_state"][k]),
                                       atol=1e-6, rtol=1e-6)


def test_weight_carry_round_trips(fixture):
    model = PLN.reference_from_arrays(fixture, "trained")
    back = PLN.to_reference(PLN.from_reference(P_cfgs.model_a(), model,
                                               device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(model)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_init_is_seeded_and_device_independent():
    cfg = P_cfgs.model_a()
    a = PLN.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = PLN.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # the masks are the reference's a-priori masks of mask_seed + i
    for i, layer in enumerate(a.layers[:3]):
        np.testing.assert_array_equal(
            layer.mask.numpy(),
            np.asarray(JS.apriori_mask(i, layer.cfg.in_features,
                                       layer.cfg.out_features, 3)))
    assert [n for n, _ in a.named_parameters()][:4] == [
        "layers.0.w", "layers.0.b", "layers.0.bn.scale", "layers.0.bn.bias"]


def test_generate_tables_bit_exact_at_model_a_width(fixture):
    cfg, pcfg = J_cfgs.model_a(), P_cfgs.model_a()
    model = PLN.reference_from_arrays(fixture, "trained")
    want = JLN.generate_tables(cfg, model)
    got = PLN.generate_tables(PLN.from_reference(pcfg, model, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.table.shape == (64, 512) and g.table.dtype == np.int32
        np.testing.assert_array_equal(g.table, w.table)
        np.testing.assert_array_equal(g.indices, w.indices)
        assert (g.bw_in, g.bw_out) == (w.bw_in, w.bw_out)
        assert PTT.table_as_listing(g, 5) == JTT.table_as_listing(w, 5)
        assert (PTT.minimized_lut_estimate(g)
                == JTT.minimized_lut_estimate(w))
    assert PTI.table_memory_bytes(got) == JTI.table_memory_bytes(want)


def test_generate_tables_small_chunks_and_gate():
    cfg = PL.SparseLinearCfg(12, 5, 4, 2)
    layer = PL.SparseLinear(cfg, torch.Generator().manual_seed(1))
    out_q = PQ.QuantizerCfg(2, 2.0)
    a = PTT.generate_sparse_linear_table(cfg, layer, out_q)
    b = PTT.generate_sparse_linear_table(cfg, layer, out_q, chunk=7)
    np.testing.assert_array_equal(a.table, b.table)
    with pytest.raises(ValueError, match="enumeration gate"):
        PTT.generate_sparse_linear_table(PL.SparseLinearCfg(64, 2, 9, 3),
                                         PL.SparseLinear(
                                             PL.SparseLinearCfg(64, 2, 9, 3)),
                                         out_q)


@pytest.mark.parametrize("fused", [False, True])
def test_verify_tables_exact(fixture, held_out, fused):
    pcfg = P_cfgs.model_a()
    model = PLN.reference_from_arrays(fixture, "trained")
    net = PLN.from_reference(pcfg, model, device="cpu")
    tables = PLN.generate_tables(net)
    f_codes, t_codes = PLN.verify_tables(net, tables, held_out[0][:200],
                                         fused=fused)
    assert f_codes.dtype == t_codes.dtype == torch.int32
    assert torch.equal(f_codes, t_codes)
    np.testing.assert_array_equal(f_codes.numpy(), fixture["verify_codes"])


def test_table_forward_matches_reference(fixture, held_out):
    cfg, pcfg = J_cfgs.model_a(), P_cfgs.model_a()
    model = PLN.reference_from_arrays(fixture, "trained")
    net = PLN.from_reference(pcfg, model, device="cpu")
    tables = PLN.generate_tables(net)
    jt = JLN.generate_tables(cfg, model)
    xv = held_out[0][:300]
    in_codes = JQ.codes(cfg.layer_cfgs()[0].in_quant, jnp.asarray(xv))
    pc = torch.from_numpy(np.asarray(in_codes))
    np.testing.assert_array_equal(
        PTI.pack_codes(pc, tables[0].indices, tables[0].bw_in).numpy(),
        np.asarray(JTI.pack_codes(in_codes, jnp.asarray(jt[0].indices),
                                  jt[0].bw_in)))
    want = JTI.network_table_forward(jt, in_codes)
    for fused in (False, True):
        np.testing.assert_array_equal(
            PTI.network_table_forward(tables, pc, fused=fused).numpy(),
            np.asarray(want))
    np.testing.assert_allclose(
        PLN.sparse_head_forward(net, tables, xv).numpy(),
        np.asarray(JLN.sparse_head_forward(cfg, model, jt, jnp.asarray(xv))),
        atol=1e-5, rtol=1e-5)
    # the compiler first (level 1), through both table paths, against the
    # reference's compiled per-layer chain
    want1 = np.asarray(JTI.network_table_forward(jt, in_codes,
                                                 optimize_level=1))
    np.testing.assert_array_equal(want1, np.asarray(want))
    for fused in (False, True):
        np.testing.assert_array_equal(
            PTI.network_table_forward(tables, pc, fused=fused,
                                      optimize_level=1).numpy(), want1)


def test_skip_topology_forwards_but_has_no_tables():
    cfg = PLN.LogicNetCfg(8, 3, hidden=(6, 5), fan_in=2, bw=2,
                          skips=((0, 1),))
    jcfg = JLN.LogicNetCfg(8, 3, hidden=(6, 5), fan_in=2, bw=2,
                           skips=((0, 1),))
    model = JLN.init(jcfg, jax.random.PRNGKey(3))
    net = PLN.from_reference(cfg, jax.tree.map(np.asarray, model),
                             device="cpu")
    x = np.random.default_rng(0).standard_normal((10, 8)).astype(np.float32)
    np.testing.assert_allclose(
        PLN.forward(net, x).detach().numpy(),
        np.asarray(JLN.forward(jcfg, model, jnp.asarray(x))[0]), atol=1e-5)
    with pytest.raises(NotImplementedError, match="skip"):
        PLN.generate_tables(net)
