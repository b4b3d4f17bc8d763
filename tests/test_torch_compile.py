"""The port's truth-table compiler (``repro_torch.compile``) against
``repro.compile``, and the entry points it is wired into.

Both packages get the same inputs, made with numpy from seeds or read
from the fixtures; the compiler is integer code, so the tolerance is 0:

* **compiler equality** — fpga4hep models A and D (the fixtures' raw
  tables) at levels 0-3, model A at level 4 (once, shared: about 4 s a
  package), and seeded random sparse stacks (small code pools so the
  re-encoding pass fires, a mixed-width bus after re-encoding, a
  constant-folding cascade) give equal uniform and mixed lowerings,
  netlists (level 4: SOP covers too), stats with timings dropped, and
  passes (names, rounds, details);
* **artifact equality** — the port's ``compile_network(optimize_level=)``
  saves what the reference saves, array for array, and each package
  loads the other's file; ``compile_runs()`` counts one run a build;
* **verification** — ``verify_tables(..., optimize_level=3)`` on model
  A's trained weights is exact through both table paths;
* **entry points** — ``serve --lut`` without ``--artifact`` compiles
  model A to layout ``mixed``; ``train_jsc_logicnet --optimize-level 3``
  prints the compiler summary and verifies twice.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import (FIXTURE_DIR, REF, SRC,  # noqa: F401
                             assert_same_cover, codes, load_train,
                             one_torch_thread, random_stack, ref_triples,
                             untimed)

from repro import compile as JC
from repro import engine as jengine
from repro.checkpoint.ckpt import load_arrays
from repro.core import netlist as JN
from repro_torch import compile as PC
from repro_torch import engine, obs
from repro_torch.compile import pipeline as PP
from repro_torch.configs import fpga4hep as P_cfgs
from repro_torch.core import logicnet as PLN
from repro_torch.core import netlist as PN
from repro_torch.core import table_infer as PTI
from repro_torch.core import truth_table as PT
from repro_torch.data import jet_substructure_data
from repro_torch.kernels.plan import FUSED_SMEM_BUDGET_BYTES

MODEL_D = os.path.join(FIXTURE_DIR, "model_d_ref.npz")
MODELS = {"A": REF, "D": MODEL_D}


def _load(model):
    with np.load(MODELS[model]) as z:
        return {k: z[k] for k in z.files}


def _triples(model):
    return ref_triples(_load(model))


def _tt(tables, indices, bw_in, bw_out):
    """The same truth-table layer in both packages."""
    t = np.asarray(tables, np.int32)
    i = np.asarray(indices, np.int32)
    return (JC.pipeline.LayerTruthTable(t, i, bw_in, bw_out),
            PT.LayerTruthTable(t.copy(), i.copy(), bw_in, bw_out))


def _pair(layers):
    """A list of ``_tt`` pairs -> (reference tables, port tables)."""
    return [a for a, _ in layers], [b for _, b in layers]


def assert_same_netlist(j, p, covers=False):
    assert (j.in_bits, j.out_bits) == (p.in_bits, p.out_bits)
    assert j.layer_bw_in == p.layer_bw_in
    assert j.layer_in_widths == p.layer_in_widths
    assert [len(lay) for lay in j.layers] == [len(lay) for lay in p.layers]
    assert j.n_hbbs == p.n_hbbs and j.table_bytes() == p.table_bytes()
    for jl, pl in zip(j.layers, p.layers):
        for a, b in zip(jl, pl):
            assert (a.layer, a.neuron, a.out_bits) == (b.layer, b.neuron,
                                                       b.out_bits)
            assert list(a.input_bits) == list(b.input_bits)
            np.testing.assert_array_equal(a.table, b.table)
            if a.reachable is None:
                assert b.reachable is None
            else:
                np.testing.assert_array_equal(a.reachable, b.reachable)
            if covers:
                assert_same_cover(a.sop, b.sop)


def assert_same_result(j, p, covers=False):
    """Every view of two ``OptimizeResult``s equal, timings aside."""
    assert j.cnet.in_features == p.cnet.in_features
    assert len(j.tables) == len(p.tables)
    for a, b in zip(j.tables, p.tables):
        assert (a.bw_in, a.bw_out) == (b.bw_in, b.bw_out)
        for f in ("indices", "table"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert len(j.mixed_tables) == len(p.mixed_tables)
    for a, b in zip(j.mixed_tables, p.mixed_tables):
        for f in ("indices", "shifts", "elem_widths", "entry_bits"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert len(a.tables) == len(b.tables)
        for x, y in zip(a.tables, b.tables):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert_same_netlist(j.netlist, p.netlist, covers=covers)
    assert untimed(j.stats.as_dict()) == untimed(p.stats.as_dict())
    assert ([(q.name, q.round, untimed(q.detail)) for q in j.stats.passes]
            == [(q.name, q.round, untimed(q.detail))
                for q in p.stats.passes])
    assert PC.summarize(p.stats) == JC.summarize(j.stats)


# ---------------------------------------------------------------------------
# compiler equality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("model", ["A", "D"])
def test_fixture_models_compile_equal(model, level):
    tr = _triples(model)
    j = JC.optimize(JC.tables_from_triples(tr), level, in_features=16)
    p = PC.optimize(PC.tables_from_triples(tr), level, in_features=16)
    assert_same_result(j, p)
    x = codes(16, 64, hi=1 << int(tr[0][2]), seed=level)
    np.testing.assert_array_equal(PC.forward_codes(p.cnet, x),
                                  JC.forward_codes(j.cnet, x))


@pytest.fixture(scope="module")
def level4_model_a():
    tr = _triples("A")
    j = JC.optimize(JC.tables_from_triples(tr), 4, in_features=16)
    p = PC.optimize(PC.tables_from_triples(tr), 4, in_features=16)
    return j, p


def test_model_a_level4_covers_equal(level4_model_a):
    j, p = level4_model_a
    assert p.stats.level == 3 and p.stats.synth is not None
    assert_same_result(j, p, covers=True)
    neurons = [n for lay in p.netlist.layers for n in lay]
    assert sum(n.sop is not None for n in neurons) == (
        p.stats.synth["covered_neurons"])


def test_model_a_level4_is_level3_plus_synth(level4_model_a):
    j4, p4 = level4_model_a
    tr = _triples("A")
    p3 = PC.optimize(PC.tables_from_triples(tr), 3, in_features=16)
    assert p4.stats.passes[-1].name == "synth"
    assert ([q.name for q in p4.stats.passes[:-1]]
            == [q.name for q in p3.stats.passes])
    assert p4.cnet.table_bytes() == p3.cnet.table_bytes()
    assert (untimed(p4.stats.synth)
            == untimed(j4.stats.synth))


def _pool_stack(seed, n_layers=3, bw=2, in_features=4):
    """A random sparse stack whose intermediate layers emit codes from a
    small pool (as ``tests/test_compile.py``'s re-encoding sweep), so the
    re-encoding pass narrows features (a pool of one collapses one)."""
    rng = np.random.default_rng(seed)
    width, layers = in_features, []
    for li in range(n_layers):
        n_out = int(rng.integers(2, 7))
        fi = min(int(rng.integers(1, 4)), width)
        idx = np.stack([np.sort(rng.choice(width, fi, replace=False))
                        for _ in range(n_out)])
        if li + 1 < n_layers:
            pool = rng.choice(2 ** bw, size=int(rng.integers(1, 2 ** bw + 1)),
                              replace=False)
        else:
            pool = np.arange(2 ** bw)
        tab = rng.choice(pool, size=(n_out, 2 ** (fi * bw)))
        layers.append(_tt(tab, idx, bw, bw))
        width = n_out
    return in_features, layers


def _mixed_bus_stack():
    """One feature narrows to 1 bit and its sibling keeps 3 (the mixed-width
    bus of ``test_reencode_mixed_width_bus_lowers_to_uniform_tables``)."""
    rng = np.random.default_rng(7)
    narrow = rng.choice([2, 5], size=16)
    wide = np.concatenate([np.arange(8), rng.integers(0, 8, 8)])
    return 2, [_tt([narrow, wide], [[0, 1], [0, 1]], 2, 3),
               _tt([rng.integers(0, 4, 64)], [[0, 1]], 3, 2)]


def _cascade_stack():
    """A constant at layer 0 collapses its consumers over two rounds."""
    return 2, [_tt([[1, 1], [0, 1]], [[0], [1]], 1, 1),
               _tt([[0, 0, 0, 1], [0, 1, 1, 1]], [[0, 1], [0, 1]], 1, 1),
               _tt([[0, 1, 1, 0]], [[0, 1]], 1, 1)]


def _wide_stack():
    """A 12 -> 20 -> 16 -> 8 stack at fan-in 3 with 2-bit codes."""
    layers = random_stack((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), seed=13)
    return 12, [_tt(t, i, b, b) for i, t, b in layers]


STACKS = {**{f"pool{s}": (lambda s=s: _pool_stack(s)) for s in range(6)},
          "pool_bw3": lambda: _pool_stack(11, bw=3, in_features=3),
          "mixed_bus": _mixed_bus_stack, "cascade": _cascade_stack,
          "wide": _wide_stack}


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_random_stacks_compile_equal(name, level):
    n_in, layers = STACKS[name]()
    jt, pt = _pair(layers)
    j = JC.optimize(jt, level, in_features=n_in)
    p = PC.optimize(pt, level, in_features=n_in)
    assert_same_result(j, p, covers=level == 4)
    x = codes(n_in, 32, hi=1 << layers[0][0].bw_in, seed=1)
    want = JC.forward_codes(JC.CNet.from_tables(jt, n_in), x)
    np.testing.assert_array_equal(PC.forward_codes(p.cnet, x), want)


def test_special_results_equal():
    """The constant-folding cascade takes two rounds, and the mixed bus
    keeps a 1-bit and a 3-bit feature, in both packages."""
    n_in, layers = _cascade_stack()
    p = PC.optimize(_pair(layers)[1], 3, in_features=n_in)
    assert p.stats.rounds >= 2
    n_in, layers = _mixed_bus_stack()
    p = PC.optimize(_pair(layers)[1], 3, in_features=n_in)
    assert sorted(p.cnet.layers[0].out_width_of(j) for j in range(2)) == [
        1, 3]
    assert p.stats.features_recoded and p.stats.bits_saved


def test_netlist_and_cnet_inputs_and_helpers_equal():
    """``optimize`` over a ``build_netlist`` netlist and over a ``CNet``,
    and the helpers (triples, mixed tables, raw stats), as the reference."""
    n_in, layers = _wide_stack()
    jt, pt = _pair(layers)
    jn, pn = JN.build_netlist(jt, n_in), PN.build_netlist(pt, n_in)
    assert_same_netlist(jn, pn)
    assert_same_result(JC.optimize(jn, 3), PC.optimize(pn, 3))
    jc, pc = JC.CNet.from_tables(jt, n_in), PC.CNet.from_tables(pt, n_in)
    assert_same_result(JC.optimize(jc, 2), PC.optimize(pc, 2))
    tr = [(t.indices, t.table, t.bw_in) for t in jt]
    for a, b in zip(JC.optimize_triples(tr, 3, in_features=n_in),
                    PC.optimize_triples(tr, 3, in_features=n_in)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    for a, b in zip(JC.optimize_mixed_tables(jt, 3, in_features=n_in),
                    PC.optimize_mixed_tables(pt, 3, in_features=n_in)):
        np.testing.assert_array_equal(a.shifts, b.shifts)
        assert all(np.array_equal(x, y) for x, y in zip(a.tables, b.tables))
    for a, b in zip(JC.optimize_tables(jt, 2, in_features=n_in),
                    PC.optimize_tables(pt, 2, in_features=n_in)):
        np.testing.assert_array_equal(a.table, b.table)
    assert PC.raw_stats(pt, n_in) == JC.raw_stats(jt, n_in)
    assert PP.MAX_ROUNDS == JC.pipeline.MAX_ROUNDS
    assert set(PC.__all__) == set(JC.__all__)
    with pytest.raises(ValueError, match="level"):
        PC.optimize(pt, 5, in_features=n_in)


def test_stats_round_trip_through_dicts():
    tr = _triples("A")
    p = PC.optimize(PC.tables_from_triples(tr), 3, in_features=16)
    d = p.stats.as_dict()
    assert PC.CompileStats.from_dict(d).as_dict() == d
    j = JC.CompileStats.from_dict(d)
    assert j.as_dict() == d


def test_compiler_metrics_in_port_registry():
    """The reference's four compiler metrics, under its names, in the
    port's registry; one optimize run adds one run at its level and one
    run of each pass it ran."""
    reg = obs.registry()
    runs = reg.counter("compile_optimize_runs_total", labels=("level",))
    passes = reg.counter("compile_pass_runs_total", labels=("pass",))
    secs = reg.counter("compile_pass_seconds_total", labels=("pass",))
    hist = reg.histogram("compile_optimize_seconds")
    n_in, layers = _wide_stack()
    before = (runs.labels(level="2").value,
              passes.labels(**{"pass": "cse"}).value, hist.count)
    PC.optimize(_pair(layers)[1], 2, in_features=n_in)
    assert runs.labels(level="2").value == before[0] + 1
    assert passes.labels(**{"pass": "cse"}).value == before[1] + 1
    assert secs.labels(**{"pass": "cse"}).value > 0
    assert hist.count == before[2] + 1


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def _plan_without_budget(plan):
    """A plan record with its budget-dependent fields dropped: the port's
    budget is Hopper's shared memory, the reference's a TPU's VMEM, so
    ``vmem_budget_bytes`` and ``headroom_bytes`` differ by design."""
    cost = {k: v for k, v in plan["variant"]["cost"].items()
            if k not in ("vmem_budget_bytes", "headroom_bytes")}
    return {**plan, "variant": {**plan["variant"], "cost": cost}}


def _meta_without_budget(meta):
    """An artifact record with timings and the plan's budget dropped."""
    meta = untimed(meta)
    return {**meta, "plan": _plan_without_budget(meta["plan"])}


@pytest.mark.parametrize("model,level", [("A", 0), ("A", 1), ("A", 2),
                                         ("A", 3), ("D", 3)])
def test_compiled_artifacts_equal_reference(model, level, tmp_path):
    tr = _triples(model)
    runs = engine.compile_runs()
    net = engine.compile_network(tr, optimize_level=level, in_features=16,
                                 block_b=16, device="cpu")
    assert engine.compile_runs() == runs + 1
    jnet = jengine.compile_network(tr, optimize_level=level,
                                   in_features=16, block_b=16)
    assert net.layout == jnet.layout == "mixed"
    assert net.plan.variant.cost.vmem_budget_bytes == FUSED_SMEM_BUDGET_BYTES
    ppath = net.save(os.path.join(tmp_path, "port.npz"))
    jpath = jnet.save(os.path.join(tmp_path, "ref.npz"))
    pa, pm = load_arrays(ppath)
    ja, jm = load_arrays(jpath)
    assert pa.keys() == ja.keys()
    for k in ja:
        assert pa[k].dtype == ja[k].dtype
        np.testing.assert_array_equal(pa[k], ja[k])
    assert _meta_without_budget(pm) == _meta_without_budget(jm)
    assert isinstance(net.stats, PC.CompileStats)
    # each package loads the other's file, with the build's stats
    from_ref = engine.load(jpath, device="cpu")
    from_port = jengine.load(ppath)
    assert untimed(from_ref.stats.as_dict()) == untimed(
        net.stats.as_dict())
    assert untimed(from_port.stats.as_dict()) == untimed(
        jnet.stats.as_dict())
    assert engine.compile_runs() == runs + 1
    x = _load(model)["codes"][:16]
    want = np.asarray(jnet(x))
    for got in (net(x), from_ref(x)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(from_port(x)), want)


def test_compiled_model_a_equals_committed_artifact():
    """The port's level-3 compile of model A's raw tables is the reference's
    committed artifact, slab for slab, with the reference's outputs."""
    ref = _load("A")
    net = engine.compile_network(ref_triples(ref), optimize_level=3,
                                 in_features=16, block_b=16, device="cpu")
    stored = engine.load(os.path.join(FIXTURE_DIR, "model_a_l3.npz"),
                         device="cpu")
    for f in ("idx_slab", "shift_slab", "width_slab", "table_slab"):
        assert torch.equal(getattr(net.slabs, f), getattr(stored.slabs, f))
    assert net.slabs.meta == stored.slabs.meta
    assert net.slabs.out_perm == stored.slabs.out_perm
    assert (_plan_without_budget(net.plan.as_dict())
            == _plan_without_budget(stored.plan.as_dict()))
    assert untimed(net.stats.as_dict()) == untimed(stored.stats.as_dict())
    np.testing.assert_array_equal(net(ref["codes"]).numpy(),
                                  ref["out_mixed"])


def test_model_d_level3_goes_mixed_and_keeps_function():
    """Model D's raw uniform slabs pass the budget (per-layer); at level 3
    the compiler's mixed lowering fits it, and the outputs stay the raw
    tables' on every input row."""
    ref = _load("D")
    raw = engine.compile_network(ref_triples(ref), block_b=16, device="cpu")
    assert raw.layout == "per_layer"
    net = engine.compile_network(ref_triples(ref), optimize_level=3,
                                 block_b=16, device="cpu")
    assert net.layout == "mixed" and net.plan.variant.cost.reason == "fused"
    assert net.n_in == 16
    assert net.slab_breakdown()["total_bytes"] == 77492
    np.testing.assert_array_equal(net(ref["codes"]).numpy(),
                                  ref["out_uniform"])


def test_optimize_result_as_layers():
    tr = _triples("A")
    opt = PC.optimize(PC.tables_from_triples(tr), 3, in_features=16)
    runs = engine.compile_runs()
    net = engine.compile_network(opt, block_b=16, device="cpu")
    assert engine.compile_runs() == runs
    assert net.layout == "mixed" and net.n_in == 16
    assert net.stats is opt.stats
    again = engine.compile_network(tr, optimize_level=3, in_features=16,
                                   block_b=16, device="cpu")
    assert torch.equal(net.slabs.table_slab, again.slabs.table_slab)
    with pytest.raises(ValueError, match="OptimizeResult"):
        engine.compile_network(opt, optimize_level=3, device="cpu")


@pytest.mark.parametrize("level,budget,layout", [(1, 98_000, "uniform"),
                                                 (2, 1024, "per_layer")])
def test_ladder_below_mixed_matches_reference(level, budget, layout):
    """A budget the mixed slabs pass sends both packages down the uniform
    lowering: at level 1 model A's mixed slabs (100 832 B: three int32
    metadata slabs) pass 98 000 B and its uniform ones (96 416 B) fit;
    1 024 B leaves the per-layer chain.  The bus width comes from the
    compiler's record."""
    tr = _triples("A")
    net = engine.compile_network(tr, optimize_level=level, block_b=16,
                                 budget_bytes=budget, device="cpu")
    jnet = jengine.compile_network(tr, optimize_level=level, block_b=16,
                                   vmem_budget_bytes=budget)
    assert net.layout == jnet.layout == layout
    assert net.n_in == jnet.n_in == 16
    assert untimed(net.stats.as_dict()) == untimed(jnet.stats.as_dict())
    x = _load("A")["codes"][:16]
    np.testing.assert_array_equal(net(x).numpy(), np.asarray(jnet(x)))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("level", [1, 3])
def test_network_table_forward_with_compiler(level, fused):
    ref = _load("A")
    tables = PC.tables_from_triples(ref_triples(ref))
    x = torch.from_numpy(ref["codes"][:300])
    runs = engine.compile_runs()
    got = PTI.network_table_forward(tables, x, fused=fused,
                                    optimize_level=level)
    assert engine.compile_runs() == runs + (1 if fused else 0)
    np.testing.assert_array_equal(got.numpy(), ref["out_uniform"][:300])


# ---------------------------------------------------------------------------
# verification on trained weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_verify_tables_with_optimize_level(fused):
    """Exact on 200 held-out rows after level 3 (fused: the mixed layout;
    else the per-layer chain over the uniform lowering), with the codes
    the reference's ``verify_tables`` gave on the raw tables."""
    fx = load_train()
    net = PLN.from_reference(P_cfgs.model_a(),
                             PLN.reference_from_arrays(fx, "trained"),
                             device="cpu")
    tables = PLN.generate_tables(net)
    xv = jet_substructure_data(8000, seed=0)[0][7000:7200]
    runs = engine.compile_runs()
    f_codes, t_codes = PLN.verify_tables(net, tables, xv, fused=fused,
                                         optimize_level=3)
    assert engine.compile_runs() == runs + (1 if fused else 0)
    assert torch.equal(f_codes, t_codes)
    np.testing.assert_array_equal(t_codes.numpy(), fx["verify_codes"])


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _run(args):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_serve_compiles_model_a_without_artifact():
    out = _run(["repro_torch.launch.serve", "--lut", "--smoke", "--device",
                "cpu", "--report-every-s", "0"])
    assert ("compiled generated fpga4hep model A at level 3: layout=mixed"
            in out)
    assert "retraces=0 compiler_runs=0 after warmup" in out


def test_train_cli_runs_the_compiler():
    out = _run(["repro_torch.launch.train_jsc_logicnet", "--steps", "5",
                "--optimize-level", "3", "--device", "cpu"])
    assert "truth-table compiler: level=3 " in out
    assert "truth-table functional verification: EXACT" in out
    assert "optimized-table functional verification: EXACT" in out
    assert "serving artifact: layout=mixed" in out
    assert "serving artifact verification: EXACT" in out
