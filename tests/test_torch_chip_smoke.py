"""``chip_smoke.py``'s rule for accepting a profiler trace, on the CPU.

Importing the script runs nothing (its work is in ``main()``), so its pure
functions can be checked here.  ``trace_accepted`` takes a trace only when
its run of measured kernel records is complete and, for device-bound calls,
its device time per call is at least ``DEVICE_BOUND_FLOOR`` (0.8) of the
CUDA-event time per call of the same calls.  The figures are one H100's
(``chip_smoke.py`` runs): float32 flash attention at (4, 16, 8, 2048, 128)
once read 1.927 ms of device time against 3.873 ms of event time (a trace
whose records were cut short); the complete readings of a sound run lie at
0.935 of their event time and above (bfloat16 flash at S 32768: 10.7928
against 11.5374 ms).
"""

import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_rules", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_import_runs_nothing_and_floor_is_stated(cs):
    assert callable(cs.main) and cs.DEVICE_BOUND_FLOOR == 0.8


@pytest.mark.parametrize("n_records,want,device,event,bound,accepted", [
    # float32 flash, 3 calls: half the event time, records cut short
    (3, 3, 1.9274886666666662, 3.8729, True, False),
    # the same calls read whole
    (3, 3, 3.8254, 3.8342, True, True),
    # the lowest complete device-bound reading: bfloat16 flash at S 32768
    (5, 5, 10.7928, 11.5374, True, True),
    # float32 masked matmul at 4096^3
    (3, 3, 3.30765, 3.33055, True, True),
    # exactly at the floor, and just below it
    (5, 5, 0.8, 1.0, True, True),
    (5, 5, 0.7999, 1.0, True, False),
    # model A's 256 x 64 x 64 masked matmul: host-bound (the event time is
    # the wrapper's host cost), so only the record count applies
    (200, 200, 0.00323, 0.02389, False, True),
    (200, 200, 0.00323, 0.02389, True, False),
    # the same calls with the stream held by the spin kernel until all
    # are queued: the card's gaps between 0.003 ms kernels still put the
    # reading below the floor, so the floor is for device-bound calls
    # alone; likewise the per-layer LUT kernels at batch 16
    (200, 200, 0.0032799, 0.0042992, False, True),
    (200, 200, 0.0032799, 0.0042992, True, False),
    (600, 600, 0.0057240, 0.0085432, True, False),
    # a record lost at either end of the run: never taken
    (4, 5, 1.0, 1.0, False, False),
    (4, 5, 1.0, 1.0, True, False),
    (0, 5, 0.0, 1.0, False, False),
    # a record too many (another kernel in the run)
    (6, 5, 1.0, 1.0, False, False),
])
def test_trace_accepted(cs, n_records, want, device, event, bound, accepted):
    assert cs.trace_accepted(n_records, want, device, event,
                             bound) is accepted


@pytest.mark.parametrize("dtype,d,route", [
    ("bfloat16", 128, "wgmma"), ("bfloat16", 12, "simt"),
    ("float32", 128, "tf32x3"), ("float32", 8, "tf32x3"),
    ("float32", 256, "tf32x3"), ("float32", 6, "simt"),
    ("float32", 264, "simt")])
def test_phase7_expects_the_wrappers_route(cs, dtype, d, route):
    """Phase 7's own statement of the route rule agrees with the
    wrapper's."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_route
    assert cs.expected_flash_route(dtype, d) == route
    assert flash_attention_route(getattr(torch, dtype), d) == route


def test_per_layer_bound_counts_each_launch_codes(cs):
    """A per-layer forward of model A at batch 4096 moves, launch by
    launch, its own codes in and out (16 + 64, 64 + 64 and 64 + 64 int32
    a row: 5 505 024 bytes, about 5.5 MB) and each layer's indices and
    tables once (3 x 64 x (3 + 512) int32: 395 520 bytes)."""
    shapes = [(64, 3, 512)] * 3
    codes = 4096 * (16 + 64 + 64 + 64 + 64 + 64) * 4
    assert codes == 5_505_024
    assert cs.per_layer_bytes(4096, 16, shapes) == codes + 395_520
    # model D: 16 -> 64 -> 32 -> 32 -> 5, fan-in 5 (1024 entries) and a
    # 5-neuron head at fan-in 6 (4096 entries)
    shapes_d = [(64, 5, 1024), (32, 5, 1024), (32, 5, 1024), (5, 6, 4096)]
    assert cs.per_layer_bytes(16, 16, shapes_d) == 4 * (
        16 * (16 + 64 + 64 + 32 + 32 + 32 + 32 + 5)
        + 64 * 1029 + 32 * 1029 * 2 + 5 * 4102)


def test_per_layer_bound_counts_the_entries_addressed(cs):
    """With ``entries`` the bound counts only the table entries a batch
    addresses; with every entry addressed it is the whole-tables count.
    ``addressed_entries`` counts distinct (neuron, entry) pairs layer by
    layer: two neurons reading bus wire 0 or 1 of a 1-bit bus, over rows
    (0, 0) and (0, 1), address 1 and 2 entries."""
    import torch

    shapes_d = [(64, 5, 1024), (32, 5, 1024), (32, 5, 1024), (5, 6, 4096)]
    full = [o * e for o, _, e in shapes_d]
    assert cs.per_layer_bytes(16, 16, shapes_d, full) == \
        cs.per_layer_bytes(16, 16, shapes_d)
    assert cs.per_layer_bytes(16, 16, shapes_d, [0, 0, 0, 0]) == \
        cs.per_layer_bytes(16, 16, shapes_d) - 4 * sum(full)
    idx = torch.tensor([[0], [1]], dtype=torch.int32)
    tab = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    codes = torch.tensor([[0, 0], [0, 1]], dtype=torch.int32)
    assert cs.addressed_entries([(idx, tab, 1)], codes) == [3]
    # a second layer sees the first one's outputs: rows (0, 1) and (0, 0)
    assert cs.addressed_entries([(idx, tab, 1), (idx, tab, 1)],
                                codes) == [3, 3]


@pytest.mark.parametrize("layout", ["uniform", "mixed"])
def test_fused_table_reads_one_entry_a_neuron_a_row(cs, layout):
    """A fused forward of one row reads one table element a neuron (the
    mixed slabs share tables between neurons, so at most that many); over
    model A's 4096 fixture rows it reads no more elements than the slab
    holds, and the uniform slabs read what the per-layer chain of the same
    tables addresses."""
    import torch

    from torch_port_util import load_ref, ref_triples

    from repro_torch import engine

    triples = ref_triples(load_ref())
    net = engine.compile_network(
        triples, optimize_level=3 if layout == "mixed" else None,
        in_features=16, block_b=16, device="cpu")
    assert net.layout == layout
    sl = net.slabs
    codes = torch.from_numpy(load_ref()["codes"])
    one_row = cs.fused_table_reads(sl, codes[:1])
    neurons = sum(m.n_out for m in sl.meta)
    assert (one_row == neurons if layout == "uniform"
            else 0 < one_row <= neurons)
    reads = cs.fused_table_reads(sl, codes)
    assert 0 < reads <= sl.table_slab.numel()
    if layout == "uniform":
        layers = [(torch.from_numpy(i), torch.from_numpy(t), bw)
                  for i, t, bw in triples]
        assert reads == sum(cs.addressed_entries(layers, codes))


def test_conv_gradient_gate_sees_tf32_operands_not_reordering(cs):
    """Phase 12c's gradient gate on the CPU: the same SparseConv step over
    the batch in another order (the same sums, added in another order)
    stays within ``CONV_GRAD_ULPS`` float32 units of each gradient's
    envelope, and a depthwise weight gradient whose operands are rounded
    to TF32 (10 mantissa bits, to nearest) is refused."""
    import copy

    import torch

    from repro_torch.core import SparseConv, SparseConvCfg
    from repro_torch.core.layers import depthwise
    from repro_torch.core.quantize import quantize

    cfg = SparseConvCfg(1, 16, 3, first_layer=True)
    mod = SparseConv(cfg, torch.Generator().manual_seed(0)).train()
    x, r = cs.conv_inputs(torch)
    env = cs.conv_grad_envelope(mod, x, r)

    def grads(xx, rr):
        m = copy.deepcopy(mod)
        seen = {}
        m.bn1.register_full_backward_hook(
            lambda _m, gi, go: seen.update(dh=gi[0]))
        (m(xx) * rr).sum().backward()
        return {n: p.grad for n, p in m.named_parameters()}, seen["dh"]

    def tf32(t):
        i = t.contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)

    want, dh = grads(x, r)
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(2))
    got, _ = grads(x[perm], r[perm])
    units = {n: cs.conv_grad_reading(got[n], want[n], env[n]) for n in want}
    assert max(units.values()) <= cs.CONV_GRAD_ULPS, units
    assert any(not torch.equal(got[n], want[n]) for n in want)
    probe = torch.zeros_like(mod.w_dw, requires_grad=True)
    gw, = torch.autograd.grad(depthwise(
        tf32(quantize(cfg.in_quant, x).value), probe, cfg.stride,
        cfg.replicate), probe, tf32(dh))
    assert cs.conv_grad_reading(mod.mask_dw * gw, want["w_dw"],
                                env["w_dw"]) > cs.CONV_GRAD_ULPS


def test_port_compiled_model_a_passes_its_check(cs, capsys):
    """``check_port_compiled`` passes the port's level-3 compile of model
    A's raw tables against the reference's artifact (here on the CPU), and
    fails a build whose stats differ."""
    import dataclasses

    import torch

    from torch_port_util import ARTIFACT, load_ref, ref_triples

    from repro_torch import engine

    net = engine.compile_network(ref_triples(load_ref()), optimize_level=3,
                                 in_features=16, block_b=16, device="cpu")
    stored = engine.load(ARTIFACT, device="cpu")
    cs.check_port_compiled(torch, net, stored)
    assert "equals model_a_l3.npz" in capsys.readouterr().out
    other = dataclasses.replace(
        net, stats=dataclasses.replace(net.stats, rounds=net.stats.rounds + 1))
    with pytest.raises(SystemExit):
        cs.check_port_compiled(torch, other, stored)


def test_record_filters(cs):
    rec = {"level": 3, "seconds": 1.0,
           "passes": [{"name": "cse", "seconds": 0.5, "round": 0}]}
    assert cs.untimed(rec) == {"level": 3,
                               "passes": [{"name": "cse", "round": 0}]}
    plan = {"source": "heuristic", "variant": {"layout": "mixed", "cost": {
        "fused": True, "vmem_budget_bytes": 183296,
        "headroom_bytes": 140168, "slab_bytes": 43128}}}
    assert cs.plan_without_budget(plan) == {
        "source": "heuristic", "variant": {"layout": "mixed", "cost": {
            "fused": True, "slab_bytes": 43128}}}


def test_compile_host_times_cover_levels_0_to_4(cs):
    from torch_port_util import random_stack

    layers = random_stack((16, 8, 4), (2, 2), (2, 2), seed=3)
    times = cs.compile_host_times({"X": layers})
    assert sorted(times) == [("X", lv) for lv in range(5)]
    assert all(t >= 0 for t in times.values())
