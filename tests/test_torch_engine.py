"""The port's serving artifact (``repro_torch.engine``) against ``repro.engine``.

Contracts, all integer and so bit-exact (tolerance 0):

* **artifacts both ways** — an artifact saved by the reference (mixed,
  uniform, per-layer, format 1) loads in the port with the reference's
  outputs; an artifact saved by the port loads in the reference with the
  same outputs and the same table-slab bytes;
* **the ladder** — the port's ``compile_network`` picks the reference's
  layout for model A's raw tables;
* **model A end to end** — the committed fixture equals a fresh
  regeneration by the reference, and the port serves the fresh artifact
  and raw tables with the reference's outputs;
* **the LM fixture** — ``lm_smoke.npz`` (the reference's smoke-config
  params and outputs that the card's check compares with) equals a fresh
  regeneration, array for array.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_port_util import (ARTIFACT, ROOT, codes, load_ref,  # noqa: F401
                             load_train, one_torch_thread, random_stack,
                             ref_triples)

from repro import compile as C
from repro import engine as jengine
from repro.checkpoint.ckpt import load_arrays, save_arrays
from repro_torch import engine


def _jax_out(net, x):
    return np.asarray(net(x))


def _port_out(net, x):
    out = net(x)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


def _reference_nets(tmp_path):
    """Reference artifacts of every layout over small stacks, saved."""
    layers = random_stack((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), seed=13)
    dup = [(i, np.where(np.arange(len(tb))[:, None] % 2, tb[0], tb), b)
           for i, tb, b in random_stack((8, 12, 6), (2, 2), (2, 2), seed=6)]
    nets = {
        "mixed": jengine.compile_network(layers, optimize_level=3,
                                         in_features=12, block_b=8),
        "mixed_dedup": jengine.compile_network(
            C.optimize(C.tables_from_triples(dup), 3, in_features=8),
            in_features=8, block_b=8),
        "uniform": jengine.compile_network(layers, in_features=12,
                                           block_b=8),
        "per_layer": jengine.compile_network(layers, in_features=12,
                                             fused=False, block_b=8),
        "reference": jengine.compile_network(layers, in_features=12,
                                             use_pallas=False),
    }
    paths = {k: n.save(os.path.join(tmp_path, f"{k}.npz"))
             for k, n in nets.items()}
    return nets, paths


@pytest.fixture(scope="module")
def reference_nets(tmp_path_factory):
    return _reference_nets(tmp_path_factory.mktemp("ref_artifacts"))


@pytest.mark.parametrize("kind", ["mixed", "mixed_dedup", "uniform",
                                  "per_layer", "reference"])
def test_reference_artifacts_load_in_port(reference_nets, kind):
    nets, paths = reference_nets
    jnet = nets[kind]
    net = engine.load(paths[kind], device="cpu")
    assert net.layout == jnet.layout and net.block_b == jnet.block_b
    assert net.plan.as_dict() == jnet.plan.as_dict()
    if kind == "mixed_dedup":
        assert all(g.offs is not None for m in net.slabs.meta
                   for g in m.groups)
    x = codes(net.n_in, 21, seed=3)
    np.testing.assert_array_equal(_port_out(net, x), _jax_out(jnet, x))


@pytest.mark.parametrize("kind", ["mixed", "mixed_dedup", "uniform",
                                  "per_layer", "reference"])
def test_port_saved_artifacts_load_in_reference(reference_nets, tmp_path,
                                                kind):
    """load -> save in the port -> repro.engine.load: same record, same
    outputs, same table-slab bytes; group records keep their 2- or
    3-element form."""
    _, paths = reference_nets
    net = engine.load(paths[kind], device="cpu")
    out = net.save(os.path.join(tmp_path, "port.npz"))
    jnet = jengine.load(out)
    a0, m0 = load_arrays(paths[kind])
    a1, m1 = load_arrays(out)
    assert m1 == m0
    assert a1.keys() == a0.keys()
    for k in a0:
        np.testing.assert_array_equal(a1[k], a0[k])
        assert a1[k].dtype == a0[k].dtype
    assert (net.slab_breakdown()["table_slab_bytes"]
            == jnet.vmem_breakdown()["table_slab_bytes"])
    x = codes(net.n_in, 13, seed=4)
    np.testing.assert_array_equal(_jax_out(jnet, x), _port_out(net, x))


def test_port_compiled_artifacts_load_in_reference(tmp_path):
    layers = random_stack((10, 12, 9, 7), (2, 3, 1), (2, 2, 3), seed=5)
    x = codes(10, 19, seed=2)
    for kw, layout in (({}, "uniform"), ({"fused": False}, "per_layer"),
                       ({"use_pallas": False}, "reference")):
        net = engine.compile_network(layers, in_features=10, block_b=8,
                                     device="cpu", **kw)
        jlive = jengine.compile_network(layers, in_features=10, block_b=8,
                                        **kw)
        assert net.layout == jlive.layout == layout
        assert net.plan.layout == layout and net.plan.block_b == 8
        jnet = jengine.load(net.save(os.path.join(tmp_path, f"{layout}.npz")))
        assert jnet.layout == layout
        assert (net.slab_breakdown()["table_slab_bytes"]
                == jnet.vmem_breakdown()["table_slab_bytes"]
                == jlive.vmem_breakdown()["table_slab_bytes"])
        want = _jax_out(jlive, x)
        np.testing.assert_array_equal(_port_out(net, x), want)
        np.testing.assert_array_equal(_jax_out(jnet, x), want)


def test_format1_artifact_loads_with_synthesized_plan(reference_nets,
                                                      tmp_path):
    nets, paths = reference_nets
    arrays, meta = load_arrays(paths["uniform"])
    meta["format"] = 1
    meta["plan"] = nets["uniform"].plan.variant.cost.as_dict()
    path = save_arrays(os.path.join(tmp_path, "v1.npz"), arrays, meta)
    net = engine.load(path, device="cpu")
    assert net.plan.source == "synthesized" and net.plan.timings_us == {}
    assert net.plan.variant.cost.as_dict() == meta["plan"]
    x = codes(net.n_in, 15, seed=3)
    np.testing.assert_array_equal(_port_out(net, x),
                                  _jax_out(jengine.load(path), x))


def test_load_rejects_foreign_kind_and_newer_format(reference_nets,
                                                    tmp_path):
    _, paths = reference_nets
    arrays, meta = load_arrays(paths["uniform"])
    future = save_arrays(os.path.join(tmp_path, "f.npz"), arrays,
                         {**meta, "format": engine.FORMAT_VERSION + 1})
    with pytest.raises(ValueError, match="format"):
        engine.load(future, device="cpu")
    foreign = save_arrays(os.path.join(tmp_path, "k.npz"), arrays,
                          {**meta, "kind": "something.else"})
    with pytest.raises(ValueError, match="not a"):
        engine.load(foreign, device="cpu")
    plain = os.path.join(tmp_path, "plain.npz")
    np.savez(plain, x=np.zeros(3))
    with pytest.raises(ValueError, match="manifest"):
        engine.load(plain, device="cpu")


def test_batch_edges_and_input_validation():
    layers = random_stack((8, 10, 6), (2, 2), (2, 2), seed=2)
    for kw in ({}, {"fused": False}):
        net = engine.compile_network(layers, in_features=8, block_b=8,
                                     device="cpu", **kw)
        empty = net(np.zeros((0, 8), np.int32))
        assert empty.shape == (0, 6) and empty.dtype == torch.int32
        x = codes(8, 13, seed=1)                  # ragged: pads to 16
        full = net(np.concatenate([x, np.zeros((3, 8), np.int32)]))
        np.testing.assert_array_equal(net(x).numpy(), full[:13].numpy())
        with pytest.raises(ValueError, match="expected"):
            net(np.zeros((2, 9), np.int32))
    # the compiler rung: one run, the reference's layout and outputs,
    # ragged batches padded the same way
    runs = engine.compile_runs()
    net = engine.compile_network(layers, optimize_level=3, in_features=8,
                                 block_b=8, device="cpu")
    jnet = jengine.compile_network(layers, optimize_level=3, in_features=8,
                                   block_b=8)
    assert engine.compile_runs() == runs + 1
    assert net.layout == jnet.layout
    x = codes(8, 13, seed=1)
    np.testing.assert_array_equal(_port_out(net, x), _jax_out(jnet, x))


def test_ladder_matches_reference_on_model_a():
    """Model A's raw tables take the uniform rung in both packages (the
    98 304 B int8 table slab fits both budgets); a budget below the slabs
    sends both to the per-layer rung."""
    triples = ref_triples(load_ref())
    net = engine.compile_network(triples, device="cpu")
    jnet = jengine.compile_network(triples)
    assert net.layout == jnet.layout == "uniform"
    assert net.plan.slab_bytes == jnet.plan.slab_bytes
    assert net.plan.pack == jnet.plan.pack
    assert (net.slab_breakdown()["table_slab_bytes"]
            == jnet.vmem_breakdown()["table_slab_bytes"])
    small = engine.compile_network(triples, budget_bytes=1024,
                                   device="cpu")
    jsmall = jengine.compile_network(triples, vmem_budget_bytes=1024)
    assert small.layout == jsmall.layout == "per_layer"
    assert small.plan.reason == "slab_exceeds_smem_budget"


def test_plan_costing_matches_reference():
    """fused_plan / default_variant cost and choose as the reference does
    (only the budget differs: shared memory instead of VMEM)."""
    from repro.kernels import plan as jplan
    from repro_torch.kernels import plan as pplan

    assert pplan.FUSED_SMEM_BUDGET_BYTES == 232_448 - 48 * 1024
    layers = random_stack((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), seed=13)
    mixed = C.optimize(C.tables_from_triples(layers), 3,
                       in_features=12).mixed_tables
    for costed in (ref_triples(load_ref()), layers, mixed):
        p, j = pplan.fused_plan(costed), jplan.fused_plan(costed)
        assert (p.fused, p.reason, p.slab_bytes, p.pack, p.f32_exact,
                p.layout) == (j.fused, j.reason, j.slab_bytes, j.pack,
                              j.f32_exact, j.layout)
        assert p.vmem_budget_bytes == pplan.FUSED_SMEM_BUDGET_BYTES
    for kw in ({}, {"mixed_tables": mixed}):
        pv = pplan.default_variant(layers, block_b=16, **kw)
        jv = jplan.default_variant(layers, block_b=16, **kw)
        assert pv.key == jv.key
        assert pv.cost.slab_bytes == jv.cost.slab_bytes
    over = pplan.default_variant(layers, mixed, budget_bytes=64)
    assert over.key == "per_layer/b128/unpacked" and not over.cost.fused


def test_model_a_fixture_served_by_port():
    """The committed level-3 artifact and raw tables, served on the CPU,
    give the reference's committed outputs on all 4096 rows."""
    ref = load_ref()
    x = ref["codes"]
    net = engine.load(ARTIFACT, device="cpu")
    assert net.layout == "mixed" and net.slabs.packed
    assert net.slabs.out_perm is not None
    assert all(g.offs is not None for m in net.slabs.meta for g in m.groups)
    np.testing.assert_array_equal(_port_out(net, x), ref["out_mixed"])
    triples = ref_triples(ref)
    for kw, name in (({}, "uniform"), ({"fused": False}, "per_layer")):
        net = engine.compile_network(triples, block_b=16, device="cpu", **kw)
        assert net.layout == name
        np.testing.assert_array_equal(_port_out(net, x), ref[f"out_{name}"])


def _fixture_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats_without_timings(stats):
    return {**stats, "passes": [{k: v for k, v in p.items()
                                 if k != "seconds"}
                                for p in stats["passes"]]}


def test_fixture_matches_fresh_reference_generation(tmp_path):
    """Regenerate generated model A with the reference: the committed
    fixture equals it (pass timings aside), and the port serves the fresh
    artifact and tables with the fresh reference outputs."""
    tool = _fixture_tool()
    mixed, fresh = tool.build()
    committed = load_ref()
    assert fresh.keys() == committed.keys()
    for k in committed:
        np.testing.assert_array_equal(fresh[k], committed[k])
    path = mixed.save(os.path.join(tmp_path, "fresh.npz"))
    a0, m0 = load_arrays(ARTIFACT)
    a1, m1 = load_arrays(path)
    for k in a0:
        np.testing.assert_array_equal(a1[k], a0[k])
    assert ({k: v for k, v in m1.items() if k != "stats"}
            == {k: v for k, v in m0.items() if k != "stats"})
    assert (_stats_without_timings(m1["stats"])
            == _stats_without_timings(m0["stats"]))

    x = fresh["codes"]
    net = engine.load(path, device="cpu")
    assert (net.slab_breakdown()["table_slab_bytes"]
            == mixed.vmem_breakdown()["table_slab_bytes"])
    np.testing.assert_array_equal(_port_out(net, x), fresh["out_mixed"])
    uni = engine.compile_network(ref_triples(fresh), block_b=16,
                                 device="cpu")
    np.testing.assert_array_equal(_port_out(uni, x), fresh["out_uniform"])


def test_train_fixture_matches_fresh_reference_generation():
    """Regenerate the training fixture with the reference: the committed
    ``model_a_train.npz`` equals it array for array."""
    fresh = _fixture_tool().build_train()
    committed = load_train()
    assert fresh.keys() == committed.keys()
    for k in committed:
        assert fresh[k].dtype == committed[k].dtype, k
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)


def test_lm_fixture_matches_fresh_reference_generation():
    """Regenerate the LM fixture with the reference: the committed
    ``lm_smoke.npz`` equals it array for array."""
    tool = _fixture_tool()
    fresh = tool.build_lm()
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port",
                              tool.LM_NAME)) as z:
        committed = {k: z[k] for k in z.files}
    assert fresh.keys() == committed.keys()
    for k in committed:
        assert fresh[k].dtype == committed[k].dtype, k
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
