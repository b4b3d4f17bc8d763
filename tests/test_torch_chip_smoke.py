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


# ---------------------------------------------------------------------------
# phase 13's pure helpers: word packing, and the exact columns of 13c
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bw,n", [(1, 5), (2, 16), (3, 16)])
def test_word_packing_is_the_netlist_bus(cs, bw, n):
    """``pack_words`` puts feature f at bits [bw f, bw (f + 1)) (the
    reference test's word), and ``unpack_word`` inverts it."""
    import numpy as np

    rng = np.random.default_rng(bw)
    codes = rng.integers(0, 1 << bw, (8, n))
    words = cs.pack_words(codes, bw)
    for row, word in zip(codes, words):
        assert [(word >> (bw * f)) & (2 ** bw - 1) for f in range(n)] == [
            int(c) for c in row]
        assert cs.unpack_word(word, bw, n) == [int(c) for c in row]
        assert word < 1 << (bw * n)
    assert cs.pack_words([[1, 0, 3]], 2) == [0b110001]
    assert cs.unpack_word(0b110001, 2, 3) == [1, 0, 3]


def test_pack_words_drives_the_port_rtl(cs):
    """Packed words through ``evaluate_verilog`` give the table forward of
    the same rows (model A's raw tables, layer 0 only)."""
    import numpy as np
    import torch

    from torch_port_util import load_ref, ref_triples

    from repro_torch.compile import tables_from_triples
    from repro_torch.core import verilog as V
    from repro_torch.core.netlist import build_netlist
    from repro_torch.core.table_infer import network_table_forward

    tables = tables_from_triples(ref_triples(load_ref())[:1])
    files = V.generate_verilog(build_netlist(tables, 16))
    codes = np.random.default_rng(1).integers(0, 8, (4, 16), dtype=np.int32)
    want = network_table_forward(tables, torch.from_numpy(codes)).numpy()
    for word, row in zip(cs.pack_words(codes, 3), want):
        out = V.evaluate_verilog(files, word, 1)
        assert cs.unpack_word(out, tables[0].bw_out, 64) == list(row)


def test_training_step_kernels_by_kind(cs):
    """Phase 14b's breakdown of a step's device time: the masked matmul,
    other matrix products, copies and the rest (AdamW's elementwise
    passes), summing to the step's device time."""
    by_name = {
        "masked_matmul_wgmma_kernel(...)": 30.0,
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128": 20.0,
        "cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16>": 5.0,
        "nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_NNT": 4.0,
        "Memcpy HtoD (Pageable -> Device)": 0.5,
        "Memset (Device)": 0.25,
        "void at::native::vectorized_elementwise_kernel<4, ...>": 200.0,
        "void at::native::reduce_kernel<512, 1, ...>": 10.0}
    kinds = cs.kernel_kinds(by_name)
    assert kinds == {"masked_matmul": 30.0, "gemm": 29.0, "copy": 0.75,
                     "other": 210.0}
    assert sum(kinds.values()) == sum(by_name.values())
    assert cs.LM_MM_PER_LAYER_STEP * 28 == 252


@pytest.mark.parametrize("which", ["in", "out", "in_t", "out_t"])
def test_ffn_gate_passes_a_reordered_sum_and_refuses_bf16_accumulation(
        cs, which):
    """Phase 14a's gate (one bfloat16 step of the plain output plus 1e-3
    of its rms) on the LogicNet-FFN's masks at d_model 512, d_ff 1536
    (fan-in 16) and the FFN's operand scales: the same float32 sum taken
    in another order, rounded to bfloat16, passes it; the control that
    accumulates in bfloat16 across K tiles of 64 fails it, though the
    bfloat16 gate of ``MM_TOL`` (atol 5e-2) passes that control."""
    import numpy as np
    import torch

    from repro_torch.kernels.masked_matmul import masked_matmul_plain
    from repro_torch.models.config import LogicNetFFNCfg
    from repro_torch.models.layers import logicnet_masks

    mask_in, mask_out = logicnet_masks(512, 1536, LogicNetFFNCfg())
    mask = {"in": mask_in, "out": mask_out, "in_t": mask_in.t(),
            "out_t": mask_out.t()}[which].contiguous().bfloat16()
    k, n = mask.shape
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((256, k)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((k, n)) / k ** 0.5).astype(
        np.float32)).bfloat16()
    want = masked_matmul_plain(x, w, mask)
    limit = cs.ffn_limit(torch, want)
    # the float64 sum of the same products, in reverse order of k
    other = (x.double().flip(1) @ (w * mask).double().flip(0)).float(
        ).bfloat16()
    diff = (other.float() - want.float()).abs()
    assert bool((diff <= limit).all())
    control = cs.bf16_tile_accumulated(torch, x, w, mask)
    beyond = (control.float() - want.float()).abs() > limit
    assert int(beyond.sum()) > 0
    atol, rtol, steps = cs.MM_TOL["bfloat16"]
    assert bool(((control.float() - want.float()).abs()
                 <= cs.mm_limit(torch, want, atol, rtol, steps)).all())


# -- phase 15's pure helpers and phase 8's near-tie rule ------------------

def test_attention_layers_counts_the_flash_launches_of_a_prefill(cs):
    from repro_torch.configs import get_config
    assert [cs.attention_layers(get_config(a)) for a in cs.FAMILY_ARCHS] == \
        [16, 0, 9]


def test_no_drop_config_gives_every_token_a_place(cs):
    """At capacity E / k an expert has a place for every token of its
    group (cap = group size), and the (token, k) pairs of any routing lose
    none; at the config's own 1.25 four decode slots share one place an
    expert."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("olmoe-1b-7b")
    wide = cs.no_drop_config(cfg)
    assert wide.moe.capacity_factor == 8.0 and wide.moe.top_k == 8
    assert [moe.capacity(wide, g) for g in (2, 4, 128, 1024)] == \
        [2, 4, 128, 1024]
    assert moe.capacity(cfg, 4) == 1
    # every slot picks the same 8 experts: the worst case
    topi = torch.arange(8).expand(1, 4, 8)
    routes = [{"topi": topi}]
    assert cs.drops_per_call(routes, wide) == [0]
    assert cs.drops_per_call(routes, cfg) == [24]
    # distinct experts for every slot: nothing to drop at cap 1
    assert cs.drops_per_call([{"topi": torch.arange(32).reshape(1, 4, 8)}],
                             cfg) == [0]


def test_drops_per_call_groups_long_calls(cs):
    """A prefill call of 2048 tokens forms two groups of 1024."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b")
    topi = torch.arange(8).expand(2, 1024, 8)          # all on 8 experts
    cap = 160                                          # int(1.25·1024·8/64)
    assert cs.drops_per_call([{"topi": topi}], cfg) == [2 * 8 * (1024 - cap)]


def test_route_rule(cs):
    """At bfloat16 a position past the contract passes only at or after a
    position of its row whose expert set differs from the reference's; at
    float32 every position is held."""
    import numpy as np
    import torch
    want = np.zeros((2, 10, 4), np.float32)
    got = torch.zeros((2, 10, 4))
    differ = np.zeros((2, 10), bool)
    assert cs.lm_check_routes("ok", got, want, "bfloat16", differ) == 0.0
    got[0, 6, 1] = 0.3                                  # past 0.05
    with pytest.raises(SystemExit):
        cs.lm_check_routes("no difference", got, want, "bfloat16", differ)
    differ[1, 2] = True                                 # another row's
    with pytest.raises(SystemExit):
        cs.lm_check_routes("other row", got, want, "bfloat16", differ)
    differ[0, 4] = True                                 # before it
    assert cs.lm_check_routes("explained", got, want, "bfloat16",
                              differ) == 0.0
    with pytest.raises(SystemExit):
        cs.lm_check_routes("float32", got, want, "float32", differ)
    differ[0, 4], differ[0, 8] = False, True            # after it: not
    with pytest.raises(SystemExit):
        cs.lm_check_routes("after", got, want, "bfloat16", differ)


def _router_case():
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config("olmoe-1b-7b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    return moe, cfg, p, x


def test_record_routing_wraps_the_router(cs):
    """Each router call's top-k experts, in call order, while active; the
    router is put back after."""
    import torch
    moe, cfg, p, x = _router_case()
    inner = moe._router
    with cs.record_routing() as rec:
        moe.moe_apply(p, cfg, x)
        moe.moe_apply(p, cfg, x[:1])
    assert moe._router is inner
    moe.moe_apply(p, cfg, x)
    k = cfg.moe.top_k
    assert [tuple(r["topi"].shape) for r in rec] == [(2, 8, k), (1, 8, k)]
    assert torch.equal(rec[0]["topi"], inner(p, x, cfg)[0])


def test_pin_routing_takes_the_given_experts(cs):
    """The router takes the given experts, weighed by the softmax of its
    own logits there; a choice left over fails; the router is put back."""
    import torch
    moe, cfg, p, x = _router_case()
    inner = moe._router
    other = (inner(p, x, cfg)[0] + 1) % cfg.moe.n_experts
    with cs.pin_routing([other]):
        topi, weights, _ = moe._router(p, x, cfg)
    assert moe._router is inner
    assert torch.equal(topi, other)
    torch.testing.assert_close(
        weights, torch.softmax((x @ p["router"]).gather(-1, other), -1))
    with pytest.raises(SystemExit):
        with cs.pin_routing([other, other]):
            moe._router(p, x, cfg)
    assert moe._router is inner


def test_routes_differ_compares_expert_sets(cs):
    """The same experts in another order are the same choice; decode's
    calls (step by step, every layer) line up with prefill's layers; a
    fixture's (layers, B, S, K) choices give one sorted array a layer."""
    import numpy as np
    import torch
    pre = [{"topi": torch.tensor([[[1, 2], [3, 4], [5, 6]]])},
           {"topi": torch.tensor([[[0, 1], [0, 2], [0, 3]]])}]
    dec = []
    for t in range(3):
        for layer in range(2):
            topi = pre[layer]["topi"][:, t:t + 1].clone()
            if (t, layer) == (0, 0):
                topi = topi.flip(-1)                   # order within k
            if (t, layer) == (2, 1):
                topi[..., 1] = 7                       # another expert
            dec.append({"topi": topi})
    got = cs.decode_routes(dec, 2, 1, 3)
    assert [g.shape for g in got] == [(1, 3, 2), (1, 3, 2)]
    differ = cs.routes_differ(cs.route_sets(pre, (1, 3)), got)
    assert differ.tolist() == [[False, False, True]]
    assert [a.tolist() for a in cs.fixture_route_sets(
        np.array([[[[2, 1], [0, 3]]]]))] == [[[[1, 2], [0, 3]]]]
    assert cs.at_or_after([[False, True, False],
                           [False, False, False]]).tolist() == \
        [[False, True, True], [False, False, False]]


def test_device_ms_takes_the_run_after_the_spin_kernel(cs):
    """The measured calls queue behind the spin kernel; the lead calls run
    before it.  With fewer measured calls than lead calls (5 flash calls
    against 20) the lead run is the longer, and taking the longest run, as
    the rule did, read a run of the wrong length (device time lost since
    the lead calls came in); the run after the spin kernel is right.
    Without a spin record, the longest run."""
    from collections import namedtuple
    R = namedtuple("R", "start end")

    def calls(t0, n, dur=300):
        return [R(t0 + i * dur, t0 + (i + 1) * dur) for i in range(n)]

    lead = calls(0, 20)
    spin_end = 6000 + 50_000
    measured = calls(spin_end + 10, 5)
    after = calls(measured[-1].end + 30_000, 1)
    runs, got = cs.measured_run(lead + measured + after, spin_end)
    assert [len(r) for r in runs] == [20, 5, 1] and got == measured
    runs, got = cs.measured_run(lead[15:] + measured + after, spin_end)
    assert got == measured
    assert cs.measured_run(lead + measured + after, None)[1] == lead
    long = calls(spin_end + 10, 200)
    last = calls(long[-1].end + 30_000, 1)
    assert cs.measured_run(lead + long + last, spin_end)[1] == long


# ---------------------------------------------------------------------------
# phase 17: the families trained
# ---------------------------------------------------------------------------

def test_full_training_runs_are_the_launchers_with_the_stated_cuts(cs,
                                                                   tmp_path):
    """17b's runs are ``launch.train --full --arch ...`` at its defaults
    (lr 3e-4, remat "full", bfloat16 compute, ``LogicNetFFNCfg()`` where
    asked), no checkpoint before the last step; the only cuts are
    olmoe-1b-7b's depth (16 -> 8 layers) and the batch and sequence of
    each run (qwen2-vl-2b: 8 x 1024, 256 vision positions and 768 text;
    whisper-medium: 8 x 448, its text context)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import LogicNetFFNCfg
    runs = {arch: (logicnet, b, s, cut)
            for arch, logicnet, b, s, cut in cs.FT_FULL}
    assert runs == {"olmoe-1b-7b": (False, 8, 256, {"n_layers": 8}),
                    "mamba2-370m": (False, 8, 256, {}),
                    "zamba2-2.7b": (True, 8, 256, {}),
                    "whisper-medium": (False, 8, 448, {}),
                    "qwen2-vl-2b": (True, 8, 1024, {})}
    for arch, (logicnet, b, s, cut) in runs.items():
        args = cs.full_train_args(str(tmp_path), arch, logicnet, b, s)
        cfg = cs.full_train_config(args, cut)
        want = get_config(arch)
        if logicnet:
            want = dataclasses.replace(want, logicnet_ffn=LogicNetFFNCfg())
        assert cfg == dataclasses.replace(want, **cut)
        assert (args.lr, args.global_batch, args.seq) == (3e-4, b, s)
        assert args.ckpt_every > cs.FT_FULL_STEPS and not args.resume
        assert cfg.remat == "full" and cfg.compute_dtype == "bfloat16"
    assert cs.full_train_config(
        cs.full_train_args(str(tmp_path), "olmoe-1b-7b", False, 8, 256),
        runs["olmoe-1b-7b"][3]).n_layers == 8
    vlm = get_config("qwen2-vl-2b")
    assert runs["qwen2-vl-2b"][2] - vlm.vision_tokens == 768
    assert runs["whisper-medium"][2] <= get_config("whisper-medium").attn_chunk


def test_expected_masked_matmul_launches_from_the_config(cs):
    """9 masked products a LogicNet-FFN and step at remat "full" (3
    forward, 3 recomputed, 3 input gradients): qwen2-vl-2b's 28 layers
    252, zamba2-2.7b's shared block at its 9 sites 81; none where the
    reference's LogicNet-FFN never runs (a MoE layer takes ``moe``
    first, mamba2 has no FFN, whisper's layers call the dense FFN)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import LogicNetFFNCfg

    def with_ffn(arch):
        return dataclasses.replace(get_config(arch),
                                   logicnet_ffn=LogicNetFFNCfg())
    assert cs.masked_matmul_per_step(with_ffn("qwen2-vl-2b")) == 252
    assert cs.masked_matmul_per_step(with_ffn("zamba2-2.7b")) == 81
    assert cs.masked_matmul_per_step(with_ffn("qwen3-1.7b")) == 252
    for arch in ("olmoe-1b-7b", "mamba2-370m", "whisper-medium"):
        assert cs.masked_matmul_per_step(with_ffn(arch)) == 0
        assert cs.masked_matmul_per_step(get_config(arch)) == 0
    assert cs.masked_matmul_per_step(get_config("zamba2-2.7b")) == 0


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-vl-2b"])
def test_masked_matmul_calls_a_remat_step_make(cs, arch, monkeypatch):
    """The count the constant stands for, taken on the CPU: a remat
    "full" training step of the smoke config with the LogicNet-FFN calls
    the masked-matmul wrapper 9 times a FFN site (the wrapper launches the
    kernel on the card wherever it is called on a CUDA tensor)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import masked_matmul as mm_mod
    from repro_torch.launch import steps
    from repro_torch.models.config import LogicNetFFNCfg
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full",
                              logicnet_ffn=LogicNetFFNCfg())
    calls = []
    real = mm_mod.masked_matmul

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(mm_mod, "masked_matmul", counted)
    state = steps.make_train_state(cfg, seed=0, device="cpu")
    batch = cs.train_batch(torch, cfg, 0, torch.device("cpu"))
    steps.make_train_step(cfg)(state, batch)
    assert len(calls) == cs.masked_matmul_per_step(cfg) == \
        9 * cs.attention_layers(cfg)


def test_moe_bfloat16_steps_are_set_aside_after_a_differing_expert_set(cs):
    """A loss past its gate passes only at or after the first step whose
    expert sets differ from the record's; the steps before it, and every
    step where none differs, are held."""
    import numpy as np
    topi = np.zeros((5, 2, 1, 3, 2), np.int8)
    topi[..., 1] = 1
    same = [cs.fixture_route_sets(topi[i]) for i in range(5)]
    assert cs.first_differing_step(same, topi) is None
    moved = [s.copy() for s in [np.stack(x) for x in same]]
    moved[2][1, 0, 2] = [0, 3]                 # step 3, layer 2, position 3
    assert cs.first_differing_step([list(m) for m in moved], topi) == 2
    rtol = [1e-5, 2e-3, 1e-5, 5e-3, 1e-5]
    assert cs.unexplained_steps(rtol, 1e-3, None) == [1, 3]
    assert cs.unexplained_steps(rtol, 1e-3, 2) == [1]
    assert cs.unexplained_steps(rtol, 1e-3, 1) == []
    assert cs.unexplained_steps([0.06], 0.05, 0) == []
    assert cs.unexplained_steps([0.06], 0.05, None) == [0]


def test_train_check_refuses_a_miss(cs):
    """17a's gate function on a made-up float32 run of the record's
    shapes: the port's own readings pass; a loss off by 2e-3, a parameter
    off by 2e-5, or a pruned weight left standing each fail."""
    import copy

    import torch
    fx = cs.train_record()
    run = "qwen3-1.7b+logicnet"
    cfg = cs.train_config("qwen3-1.7b", True, "float32")
    got = cs.train_five_steps(torch, cfg, cs.train_arrays(fx, run),
                              torch.device("cpu"))
    rec = cs.train_check(run, "float32", cfg, got, fx)
    assert rec["param_err"] <= cs.FT_PARAM_ATOL and rec["conditioned"] > 0
    bad = copy.deepcopy(got)
    bad["losses"][3] *= 1.002
    with pytest.raises(SystemExit):
        cs.train_check(run, "float32", cfg, bad, fx)
    bad = copy.deepcopy(got)
    w = bad["params"]["layers.1.attn.wq"]
    with torch.no_grad():
        w[0, 0, 0] += 2e-5
    bad["conditioned"]["layers.1.attn.wq"][0, 0, 0] = False
    with pytest.raises(SystemExit):
        cs.train_check(run, "float32", cfg, bad, fx)
    bad = copy.deepcopy(got)
    m = bad["params"]["layers.0.ffn.mask_in"]
    w = bad["params"]["layers.0.ffn.wi_up"]
    with torch.no_grad():
        w[m == 0] = 1e-3
    with pytest.raises(SystemExit):
        cs.train_check(run, "bfloat16", cfg, bad, {
            **fx, f"{run}.bfloat16.losses": fx[f"{run}.float32.losses"],
            f"{run}.bfloat16.grad_norm0": fx[f"{run}.float32.grad_norm0"]})


def test_seeded_vision_replaces_only_the_zero_vision_embeddings(cs):
    """17b's qwen2-vl batches: the launcher's tokens and labels, seeded
    standard-normal bfloat16 vision embeddings a step (the same for the
    parity run and the main one); a batch without them is untouched."""
    import torch
    dev = torch.device("cpu")

    def batches(step):
        return {"tokens": torch.full((2, 8), step),
                "vision_embeds": torch.zeros((2, 4, 6),
                                             dtype=torch.bfloat16)}
    a, b = (cs.seeded_vision(torch, batches, dev) for _ in range(2))
    x0, x1 = a(0), a(1)
    assert torch.equal(x0["tokens"], batches(0)["tokens"])
    assert x0["vision_embeds"].dtype == torch.bfloat16
    assert float(x0["vision_embeds"].float().std()) > 0.5
    assert torch.equal(x0["vision_embeds"], b(0)["vision_embeds"])
    assert not torch.equal(x0["vision_embeds"], x1["vision_embeds"])
    plain = cs.seeded_vision(torch, lambda s: {"tokens": torch.ones(2)},
                             dev)
    assert plain(3).keys() == {"tokens"}


# -- phase 18: the mesh path's rules -----------------------------------------

def _dryrun_record(**kw):
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "16x16",
           "status": "ok", "chips": 256, "cost": {"flops": 1.0},
           "collectives": {"total": 2.0}, "pod_on_weights": False}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("change,want", [
    ({}, []),
    ({"mesh": "2x16x16", "chips": 512, "pod_on_weights": True}, []),
    ({"status": "FAILED", "error": "boom"}, ["status FAILED: boom"]),
    ({"cost": {"flops": 0.0}}, ["no FLOPs"]),
    ({"collectives": {"total": 0.0}}, ["no collectives"]),
    ({"chips": 8}, ["8 ranks, not 256"]),
    ({"mesh": "2x16x16", "chips": 512}, ["the pod axis shards no weight"]),
])
def test_mesh_dryrun_check(cs, change, want):
    """Phase 18d refuses a production-mesh cell that failed, traced no
    FLOPs or collectives, ran on another number of ranks, or (multi-pod)
    left the pod axis off the weights."""
    assert cs.mesh_dryrun_check(_dryrun_record(**change)) == want


def test_mesh_dryrun_check_on_a_real_record(tmp_path):
    """A record ``launch.dryrun`` writes for a skipped cell has no mesh
    fields: the check refuses it (phase 18d's cells all run)."""
    import json
    import os
    import subprocess
    import sys
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen3-1.7b__long_500k__16x16.json")
                     .read_text())
    assert rec["status"] == "skipped"
    spec = importlib.util.spec_from_file_location("chip_smoke_rules", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.mesh_dryrun_check(rec) == ["status skipped: None"]


def test_serve_tokens_line(cs):
    out = ("[serve] qwen3-1.7b: 32 decode steps x 4 slots on one device "
           "(9.1 ms/step)\n[serve] tokens [[1, 2], [3, 4]]\n")
    assert cs.serve_tokens_line(out) == "[serve] tokens [[1, 2], [3, 4]]"
    assert cs.serve_tokens_line("[serve] qwen3-1.7b: ...") is None


def test_mesh_param_reads_a_one_rank_shard(cs):
    import torch
    t = torch.arange(4.0)
    assert cs.mesh_param(t) is t
