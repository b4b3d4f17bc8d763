"""The reading of a traced segment, on records made up here: units between
markers, busy and idle time, idle gaps named by the host phase, device
time by kind, and a trace that lost a record or a marker refused."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench.harness import trace


def event(name, start_us, end_us):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start_us * 1000,
        end_ns=lambda: end_us * 1000, device_type=lambda: DeviceType.CUDA,
        is_user_annotation=lambda: False)


def profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def segment(drop=None):
    # marker, unit 0 (two kernels, a 100 us gap), marker, unit 1, marker
    ev = [event("spin_kernel", 0, 10),
          event("masked_matmul_wgmma_kernel", 20, 120),
          event("vectorized_elementwise_kernel", 220, 320),
          event("spin_kernel", 330, 340),
          event("masked_matmul_wgmma_kernel", 350, 450),
          event("vectorized_elementwise_kernel", 450, 550),
          event("spin_kernel", 560, 570)]
    return [e for i, e in enumerate(ev) if i != drop]


def phases():
    ph = trace.Phases()
    # host clock 1 s behind the device's: the gap at 120-220 us falls in
    # "step", the rest in the loop
    ph.spans = [("step", 1e-6 * 110 + 1, 1e-6 * 230 + 1)]
    return ph


def test_units_busy_idle_and_kinds():
    t, why = trace._read(profile(segment()), 2, phases(), 1e6, ["a", "a"])
    assert why == "" and len(t.units) == 2
    assert abs(t.window_s - 550e-6) < 1e-12       # 10 us to 560 us
    assert abs(t.busy_s - 400e-6) < 1e-12
    assert abs(t.gaps["step"] - 100e-6) < 1e-12
    assert abs(t.kernel_s(("masked_matmul",)) - 200e-6) < 1e-12
    kinds = t.by_kind()
    assert abs(kinds["masked_matmul"] - 100e-6) < 1e-12
    assert abs(kinds["other"] - 100e-6) < 1e-12
    b = t.breakdown()
    assert [k for k, _ in b["device_ops"]][0].startswith(("masked", "vec"))
    assert b["idle_gaps"][0][0] == "step"


def test_a_lost_record_or_marker_is_refused():
    t, why = trace._read(profile(segment(drop=2)), 2, phases(), 1e6,
                         ["a", "a"])
    assert t is None and "records" in why
    t, why = trace._read(profile(segment(drop=3)), 2, phases(), 1e6,
                         ["a", "a"])
    assert t is None and "markers" in why
    # units of different shapes may hold different counts
    t, _ = trace._read(profile(segment(drop=2)), 2, phases(), 1e6,
                       ["a", "b"])
    assert t is not None
