"""The port's variant autotuner (``repro_torch.engine.autotune``), on the CPU.

The contracts of ``tests/test_autotune.py``, held by the port with the
kernels' plain versions:

* **enumeration** — ``enumerate_variants`` gives the layout x block_b x
  pack space (fused-ineligible layouts skipped, the per-layer kernel
  always present), with the reference's keys in the reference's order for
  the same stack at the same budget; ``default_variant`` is the heuristic
  ladder ``compile_network`` runs;
* **selection** — ``compile_network(autotune=True)`` is bit-exact
  (tolerance 0: integer codes) with the reference, runs the compiler once,
  times every variant and picks the argmin of its timing table, and
  records where it timed (``backend``) and the route of each variant;
* **persistence** — the plan round-trips through ``save`` / ``load`` with
  zero search and zero compiler runs; the reference reads the port's
  autotuned artifact, and the port replays the reference's as saved but
  never reports it as measured here (``measured_here``);
* **compat** — a format-1 artifact loads with a synthesized plan, a newer
  format is refused.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_port_util import (ARTIFACT, REF, SRC, codes,  # noqa: F401
                             load_ref, one_torch_thread, random_stack,
                             ref_triples)

from repro import engine as jengine
from repro.core.table_infer import network_table_forward
from repro.core.truth_table import LayerTruthTable
from repro.engine import autotune as jautotune
from repro.kernels import plan as jplan
from repro_torch import engine, obs
from repro_torch.checkpoint.ckpt import load_arrays, save_arrays
from repro_torch.compile import optimize, tables_from_triples
from repro_torch.engine import autotune as A
from repro_torch.engine.autotune import ExecutionPlan, autotune_network
from repro_torch.kernels import (DEFAULT_BLOCK_B, DEFAULT_BLOCK_BS,
                                 FUSED_SMEM_BUDGET_BYTES, FusedPlan,
                                 default_variant, enumerate_variants,
                                 fused_plan)

STACK = ((12, 20, 16, 8), (3, 3, 3), (2, 2, 2))
# the search's counts on the CPU, as the reference's tests run it
FAST = dict(warmup=1, iters=1, reps=1)


def _tables(layers):
    return [LayerTruthTable(tab, idx, bw, bw) for idx, tab, bw in layers]


def _variants_total(snap):
    return sum(s["value"] for s in snap.get(
        "engine_autotune_variants_total", {}).get("series", []))


# ---------------------------------------------------------------------------
# enumeration
# ---------------------------------------------------------------------------


def test_enumerate_variants_space_and_keys():
    layers = random_stack(*STACK, seed=13)
    variants = enumerate_variants(uniform_triples=layers,
                                  block_bs=(16, 32))
    keys = [v.key for v in variants]
    assert len(keys) == len(set(keys)), "variant keys must be unique"
    # no mixed tables: no mixed variants; the per-layer kernel always
    assert {v.layout for v in variants} == {"uniform", "per_layer"}
    assert {v.block_b for v in variants} == {16, 32}
    for v in variants:
        assert v.cost.fused == (v.layout != "per_layer")
        if v.layout == "per_layer" and fused_plan(layers).fused:
            assert v.cost.reason == "per_layer_variant"
    assert fused_plan(layers).pack
    assert {v.pack for v in variants if v.layout == "uniform"} == {True,
                                                                   False}
    assert DEFAULT_BLOCK_BS == jplan.DEFAULT_BLOCK_BS


def test_enumerate_variants_skips_over_budget_layouts():
    layers = random_stack(*STACK, seed=13)
    variants = enumerate_variants(uniform_triples=layers, block_bs=(16,),
                                  budget_bytes=64)
    assert {v.layout for v in variants} == {"per_layer"}
    assert variants[0].cost.reason == "slab_exceeds_smem_budget"


def _model(name):
    ref = load_ref() if name == "A" else dict(np.load(
        os.path.join(os.path.dirname(REF), "model_d_ref.npz")))
    return ref_triples(ref)


@pytest.mark.parametrize("budget", [FUSED_SMEM_BUDGET_BYTES,
                                    jplan.FUSED_VMEM_BUDGET_BYTES, 64,
                                    50_000, 120_000])
@pytest.mark.parametrize("case", ["stack", "A", "D", "A_l3", "D_l3"])
def test_enumerate_variants_equal_reference(case, budget):
    """The same keys in the same order as the reference's, on the same
    stack at the same budget (mixed tables: each package's own compiler
    output of the same tables)."""
    from repro import compile as jcompile

    if case == "stack":
        triples = random_stack(*STACK, seed=13)
    else:
        triples = _model(case[0])
    mixed = jmixed = None
    if case.endswith("_l3"):
        n_in = int(np.max(triples[0][0])) + 1
        res = optimize(tables_from_triples(triples), 3, in_features=n_in)
        jres = jcompile.optimize(jcompile.tables_from_triples(triples), 3,
                                 in_features=n_in)
        triples = [(t.indices, t.table, t.bw_in) for t in res.tables]
        mixed, jmixed = res.mixed_tables, jres.mixed_tables
    sweep = (16, 64, 128, 256)
    ours = enumerate_variants(triples, mixed, block_bs=sweep,
                              budget_bytes=budget)
    theirs = jplan.enumerate_variants(triples, jmixed, block_bs=sweep,
                                      vmem_budget_bytes=budget)
    assert [v.key for v in ours] == [v.key for v in theirs]
    for a, b in zip(ours, theirs):
        assert (a.cost.slab_bytes, a.cost.pack, a.cost.fused) == (
            b.cost.slab_bytes, b.cost.pack, b.cost.fused)


def test_default_variant_matches_heuristic_ladder():
    layers = random_stack(*STACK, seed=13)
    v = default_variant(uniform_triples=layers, block_b=32)
    assert v.layout == "uniform" and v.block_b == 32
    assert v.cost == fused_plan(layers)
    v64 = default_variant(uniform_triples=layers, budget_bytes=64)
    assert v64.layout == "per_layer" and v64.pack is False
    assert v64.block_b == DEFAULT_BLOCK_B
    net = engine.compile_network(layers, in_features=STACK[0][0],
                                 block_b=32, device="cpu")
    assert net.plan.source == "heuristic"
    assert net.plan.variant == v
    assert net.plan.backend is None and not net.measured_here


@pytest.mark.parametrize("in_features,bw,batch,seed", [
    (16, 3, 256, 0), (12, 2, 17, 4), (16, 2, 64, 9)])
def test_synthetic_codes_equal_reference(in_features, bw, batch, seed):
    ours = A._synthetic_codes(in_features, bw, batch, seed)
    theirs = jautotune._synthetic_codes(in_features, bw, batch, seed)
    assert ours.dtype == theirs.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def test_autotune_bit_exact_and_picks_measured_minimum():
    widths, fan_ins, bws = STACK
    layers = random_stack(widths, fan_ins, bws, seed=21)
    x = codes(widths[0], 17, hi=2 ** bws[0], seed=1)
    want = np.asarray(network_table_forward(_tables(layers), x))

    runs0 = engine.compile_runs()
    net = engine.compile_network(layers, optimize_level=3,
                                 in_features=widths[0], autotune=True,
                                 block_b=16, autotune_block_bs=(8, 16),
                                 device="cpu")
    # the compiler ran once, for optimize_level; the sweep ran none
    assert engine.compile_runs() == runs0 + 1
    np.testing.assert_array_equal(net(x).numpy(), want)
    plan = net.plan
    assert plan.source == "autotune" and plan.backend == "cpu"
    assert plan.variant.key in plan.timings_us
    assert plan.default_key in plan.timings_us
    best = min(plan.timings_us, key=plan.timings_us.get)
    assert plan.variant.key == best
    assert (plan.timings_us[plan.default_key]
            >= plan.timings_us[plan.variant.key])
    assert net.block_b == plan.block_b and net.layout == plan.layout
    assert set(plan.routes) == set(plan.timings_us)
    assert set(plan.routes.values()) == {"plain"}
    assert net.measured_here


def test_autotune_network_times_every_variant():
    layers = random_stack(*STACK, seed=17)
    snap0 = obs.registry().snapshot()
    plan, built = autotune_network(layers, in_features=STACK[0][0],
                                   block_b=16, block_bs=(8, 16),
                                   device="cpu", **FAST)
    want_keys = [v.key for v in enumerate_variants(
        uniform_triples=layers, block_bs=(8, 16))]
    assert list(plan.timings_us) == want_keys
    assert all(t > 0 for t in plan.timings_us.values())
    assert plan.batch == 16                 # max of the sweep
    assert built is not None
    assert (_variants_total(obs.registry().snapshot())
            - _variants_total(snap0)) == len(want_keys)


def test_autotune_winner_is_first_minimum_in_order(monkeypatch):
    """The reference's rule: argmin of the table, ties to the first key in
    enumeration order (block_b-only variants can tie on the card)."""
    layers = random_stack(*STACK, seed=17)
    monkeypatch.setattr(A, "_time_forward", lambda fn, **kw: (fn(), 5.0)[1])
    plan, built = autotune_network(layers, in_features=STACK[0][0],
                                   block_b=16, block_bs=(8, 16),
                                   device="cpu")
    assert plan.variant.key == next(iter(plan.timings_us))
    assert plan.variant.key == "uniform/b8/packed"
    assert built.packed


def test_autotune_default_counts_by_device():
    assert (A.AUTOTUNE_WARMUP, A.AUTOTUNE_ITERS, A.AUTOTUNE_REPS) == (
        3, 50, 7)
    assert A.AUTOTUNE_WARMUP >= 1 and A.AUTOTUNE_ITERS > \
        jautotune.AUTOTUNE_ITERS
    assert A.CPU_AUTOTUNE_COUNTS == (jautotune.AUTOTUNE_WARMUP,
                                     jautotune.AUTOTUNE_ITERS,
                                     jautotune.AUTOTUNE_REPS)


def test_time_forward_median_and_warmup():
    calls = []
    us = A._time_forward(lambda: calls.append(1), warmup=2, iters=3,
                         reps=5, device="cpu")
    assert len(calls) == 2 + 3 * 5
    assert us >= 0.0


def test_autotune_ignored_off_the_fused_path():
    layers = random_stack(*STACK, seed=17)
    net = engine.compile_network(layers, in_features=STACK[0][0],
                                 fused=False, autotune=True, device="cpu")
    assert net.plan.source == "heuristic" and net.layout == "per_layer"
    net = engine.compile_network(layers, in_features=STACK[0][0],
                                 use_pallas=False, autotune=True,
                                 device="cpu")
    assert net.plan.source == "heuristic" and net.layout == "reference"


def test_autotune_model_a_level3_against_reference():
    """Model A's raw tables at level 3: every layout the search can pick
    gives the reference's outputs on the fixture's codes."""
    ref = load_ref()
    runs0 = engine.compile_runs()
    net = engine.compile_network(ref_triples(ref), optimize_level=3,
                                 in_features=16, autotune=True,
                                 block_b=16, device="cpu")
    assert engine.compile_runs() == runs0 + 1
    res = optimize(tables_from_triples(ref_triples(ref)), 3,
                   in_features=16)
    want = [v.key for v in enumerate_variants(
        [(t.indices, t.table, t.bw_in) for t in res.tables],
        res.mixed_tables, block_bs=(16, 64, 128, 256))]
    assert list(net.plan.timings_us) == want
    assert {k.split("/")[0] for k in want} == {"mixed", "uniform",
                                               "per_layer"}
    np.testing.assert_array_equal(net(ref["codes"][:300]).numpy(),
                                  ref["out_mixed"][:300])


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def test_autotuned_plan_round_trips_with_zero_search(tmp_path):
    widths, fan_ins, bws = STACK
    layers = random_stack(widths, fan_ins, bws, seed=23)
    x = codes(widths[0], 19, hi=4, seed=2)
    net = engine.compile_network(layers, in_features=widths[0],
                                 autotune=True, block_b=16,
                                 autotune_block_bs=(8, 16), device="cpu")
    live = net(x).numpy()
    path = os.path.join(tmp_path, "tuned.npz")
    net.save(path)
    runs0 = engine.compile_runs()
    snap0 = obs.registry().snapshot()
    net2 = engine.load(path, device="cpu")
    assert engine.compile_runs() == runs0
    assert _variants_total(obs.registry().snapshot()) == \
        _variants_total(snap0)
    assert net2.plan == net.plan
    assert net2.plan.source == "autotune" and net2.plan.backend == "cpu"
    assert net2.block_b == net.plan.block_b
    assert net2.measured_here
    np.testing.assert_array_equal(net2(x).numpy(), live)


def test_reference_reads_port_autotuned_artifact(tmp_path):
    widths, fan_ins, bws = STACK
    layers = random_stack(widths, fan_ins, bws, seed=29)
    x = codes(widths[0], 21, hi=4, seed=3)
    net = engine.compile_network(layers, optimize_level=3,
                                 in_features=widths[0], autotune=True,
                                 block_b=16, autotune_block_bs=(8, 16),
                                 device="cpu")
    path = os.path.join(tmp_path, "port_tuned.npz")
    net.save(path)
    jnet = jengine.load(path)
    assert jnet.plan.source == "autotune"
    assert jnet.plan.variant.key == net.plan.variant.key
    assert jnet.plan.timings_us == net.plan.timings_us
    assert jnet.block_b == net.block_b and jnet.layout == net.layout
    want = np.asarray(network_table_forward(_tables(layers), x))
    np.testing.assert_array_equal(np.asarray(jnet(x)), want)
    np.testing.assert_array_equal(net(x).numpy(), want)


@pytest.fixture(scope="module")
def ref_tuned(tmp_path_factory):
    """An artifact the reference's autotuner made (timed in interpret
    mode), and the reference's outputs on seeded codes."""
    widths, fan_ins, bws = STACK
    layers = random_stack(widths, fan_ins, bws, seed=31)
    x = codes(widths[0], 23, hi=4, seed=4)
    jnet = jengine.compile_network(layers, optimize_level=3,
                                   in_features=widths[0], autotune=True,
                                   block_b=16, autotune_block_bs=(8, 16))
    path = str(tmp_path_factory.mktemp("ref_tuned") / "ref_tuned.npz")
    jnet.save(path)
    return path, jnet.plan, x, np.asarray(jnet(x))


def test_reference_autotuned_plan_replayed_not_measured_here(ref_tuned):
    path, jplan_, x, want = ref_tuned
    runs0 = engine.compile_runs()
    snap0 = obs.registry().snapshot()
    net = engine.load(path, device="cpu")
    # replayed as saved: the reference's variant, source and timings, no
    # search and no compiler run
    assert engine.compile_runs() == runs0
    assert _variants_total(obs.registry().snapshot()) == \
        _variants_total(snap0)
    assert net.plan.source == "autotune"
    assert net.plan.variant.key == jplan_.variant.key
    assert net.plan.timings_us == jplan_.timings_us
    assert net.layout == jplan_.layout and net.block_b == jplan_.block_b
    assert net.plan.backend is None
    assert not net.measured_here
    np.testing.assert_array_equal(net(x).numpy(), want)


def test_plan_from_another_backend_not_measured_here(ref_tuned, tmp_path):
    path = ref_tuned[0]
    arrays, meta = load_arrays(path)
    for backend, here in (("cuda:Some Other Card", False), ("cpu", True),
                          (None, False)):
        if backend is None:
            meta["plan"].pop("backend", None)
        else:
            meta["plan"]["backend"] = backend
        p = os.path.join(tmp_path, "b.npz")
        save_arrays(p, arrays, meta)
        net = engine.load(p, device="cpu")
        assert net.measured_here is here, backend
    # a backend without a search behind it is not a measurement
    heuristic = dataclasses.replace(net, plan=ExecutionPlan(
        variant=net.plan.variant, backend="cpu"))
    assert not heuristic.measured_here


def test_cli_reports_foreign_plan_without_timings(ref_tuned, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
         "--artifact", ref_tuned[0], "--smoke", "--device", "cpu",
         "--report-every-s", "0"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "timings not taken on this device (cpu)" in proc.stdout
    assert "us/forward" not in proc.stdout


def test_cli_autotune_smoke_names_its_device(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
         "--autotune", "--smoke", "--device", "cpu",
         "--report-every-s", "0"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "autotuned on cpu over 16 variants at 256 rows" in proc.stdout
    assert "compile-once contract: retraces=0 compiler_runs=0" in proc.stdout


# ---------------------------------------------------------------------------
# compat
# ---------------------------------------------------------------------------


def test_format1_artifact_loads_with_synthesized_plan(tmp_path):
    widths, fan_ins, bws = STACK
    layers = random_stack(widths, fan_ins, bws, seed=31)
    x = codes(widths[0], 15, hi=4, seed=3)
    net = engine.compile_network(layers, in_features=widths[0],
                                 device="cpu")
    live = net(x).numpy()
    path = os.path.join(tmp_path, "v1.npz")
    net.save(path)
    arrays, meta = load_arrays(path)
    meta["format"] = 1
    meta["plan"] = net.plan.variant.cost.as_dict()
    save_arrays(path, arrays, meta)
    net2 = engine.load(path, device="cpu")
    assert net2.plan.source == "synthesized"
    assert isinstance(net2.plan, ExecutionPlan)
    assert net2.plan.timings_us == {}
    assert net2.plan.variant.cost == FusedPlan.from_dict(meta["plan"])
    assert (net2.plan.layout, net2.plan.block_b) == (net.layout,
                                                     net.block_b)
    assert not net2.measured_here
    np.testing.assert_array_equal(net2(x).numpy(), live)


def test_load_rejects_newer_format(tmp_path):
    layers = random_stack((8, 6, 4), (2, 2), (2, 2), seed=9)
    net = engine.compile_network(layers, in_features=8, device="cpu")
    path = os.path.join(tmp_path, "future.npz")
    net.save(path)
    arrays, meta = load_arrays(path)
    meta["format"] = engine.FORMAT_VERSION + 1
    save_arrays(path, arrays, meta)
    with pytest.raises(ValueError, match="format"):
        engine.load(path, device="cpu")


def test_execution_plan_compat_surface():
    layers = random_stack((8, 6, 4), (2, 2), (2, 2), seed=9)
    cost = fused_plan(layers)
    plan = ExecutionPlan.from_fused(cost, "uniform", 32)
    assert (plan.layout, plan.block_b, plan.pack) == ("uniform", 32,
                                                      cost.pack)
    assert plan.fused is cost.fused and plan.reason == cost.reason
    assert plan.slab_bytes == cost.slab_bytes
    assert ExecutionPlan.from_dict(plan.as_dict()) == plan
    # a heuristic plan's record is the reference's: no backend, no routes
    assert set(plan.as_dict()) == {"variant", "source", "timings_us",
                                   "batch", "default_key"}
    tuned = ExecutionPlan(variant=plan.variant, source="autotune",
                          timings_us={plan.variant.key: 1.0}, batch=32,
                          default_key=plan.variant.key, backend="cpu",
                          routes={plan.variant.key: "plain"})
    assert ExecutionPlan.from_dict(tuned.as_dict()) == tuned
    # the reference's from_dict ignores the two additive keys
    jp = jautotune.ExecutionPlan.from_dict(tuned.as_dict())
    assert (jp.variant.key, jp.source, jp.timings_us) == (
        plan.variant.key, "autotune", {plan.variant.key: 1.0})


def test_artifact_fixture_plan_is_heuristic():
    net = engine.load(ARTIFACT, device="cpu")
    assert net.plan.source == "heuristic" and not net.measured_here


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(SRC).parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_front", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_block_b_spread_and_counters():
    """Phase 11b's arithmetic: the spread among block_b-only variants of
    each (layout, pack) and each group's best over the table's best."""
    cs = _chip_smoke()
    spread, gap = cs.block_b_spread({
        "mixed/b16/packed": 20.0, "mixed/b64/packed": 22.0,
        "uniform/b16/packed": 30.0, "uniform/b64/packed": 30.0,
        "per_layer/b16/unpacked": 80.0})
    assert spread == pytest.approx({"mixed/packed": 0.1,
                                    "uniform/packed": 0.0,
                                    "per_layer/unpacked": 0.0})
    assert gap == pytest.approx({"mixed/packed": 1.0,
                                 "uniform/packed": 1.5,
                                 "per_layer/unpacked": 4.0})
    snap = {"ingress_rejected_total": {"series": [
        {"labels": {"reason": "quota"}, "value": 7.0}]}}
    assert cs.counter_value(snap, "ingress_rejected_total",
                            reason="quota") == 7.0
    assert cs.counter_value(snap, "ingress_rejected_total",
                            reason="overloaded") == 0.0
    assert cs.counter_value({}, "nope") == 0.0
