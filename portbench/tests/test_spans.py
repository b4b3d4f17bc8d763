"""The reading of a span segment, on records made up here: device records
put down to spans by their launch, backward records by the forward
operator autograd's node came from, the paths' device time summing to
the unit's, idle gaps named by harness phase and program span, and a
segment that does not stand leaving a traced line as it was."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench.harness import spans, trace

STEP, AUTOGRAD = 1, 2


def event(name, start_us, end_us, *, device=DeviceType.CPU,
          annotation=False, corr=0, linked=0, thread=STEP, seq=-1, fwd=0):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start_us * 1000,
        end_ns=lambda: end_us * 1000, device_type=lambda: device,
        is_user_annotation=lambda: annotation, correlation_id=lambda: corr,
        linked_correlation_id=lambda: linked,
        start_thread_id=lambda: thread, sequence_nr=lambda: seq,
        fwd_thread_id=lambda: fwd)


def span(name, a, b, thread=STEP):
    return event(name, a, b, annotation=True, thread=thread)


def launch(corr, t, thread=STEP, op=0, name="cudaLaunchKernel"):
    return event(name, t, t + 1, corr=corr, linked=op, thread=thread)


def kernel(name, a, b, corr):
    return event(name, a, b, device=DeviceType.CUDA, corr=corr,
                 linked=corr)


def unit_events(t0=0):
    """One train step between two markers (times in µs from ``t0``).

    Host: ``train_step`` over ``forward`` (``ffn``, ``loss``),
    ``backward`` (autograd's thread runs two nodes and a recomputed
    ``ffn``), ``nan_guard`` and ``adamw``.  Device: A (forward ffn), B
    (loss), C (backward of A's operator), D (recomputed ffn), E (backward
    of an operator outside any inner span), F (autograd's thread outside
    any node), G (adamw), H (no launch in the trace), then the marker."""
    t = t0
    return [
        launch(100 + t, t + 0), kernel("spin_kernel", t + 10, t + 20,
                                       100 + t),
        span("train_step", t + 5, t + 200), span("forward", t + 6, t + 60),
        span("ffn", t + 10, t + 30), span("loss", t + 40, t + 55),
        span("backward", t + 60, t + 150), span("nan_guard", t + 150,
                                                t + 158),
        span("adamw", t + 158, t + 195),
        span("ffn", t + 85, t + 95, thread=AUTOGRAD),
        # forward operators: the FFN's matmul, the loss's, the embedding
        event("aten::mm", t + 12, t + 14, corr=1 + t, seq=7 + t),
        event("aten::logsumexp", t + 45, t + 47, corr=2 + t, seq=9 + t),
        event("aten::embedding", t + 7, t + 8, corr=3 + t, seq=5 + t),
        launch(101 + t, t + 12.5, op=1 + t),
        kernel("masked_matmul_wgmma_kernel", t + 25, t + 35, 101 + t),
        launch(102 + t, t + 46, op=2 + t),
        kernel("reduce_kernel", t + 50, t + 60, 102 + t),
        # backward nodes on autograd's thread
        event(spans.BACKWARD_NODE + ": MmBackward0", t + 70, t + 80,
              corr=10 + t, thread=AUTOGRAD, seq=7 + t, fwd=STEP),
        event("aten::mm", t + 71, t + 79, corr=11 + t, thread=AUTOGRAD),
        launch(103 + t, t + 72, thread=AUTOGRAD, op=11 + t),
        kernel("masked_matmul_wgmma_kernel", t + 80, t + 90, 103 + t),
        launch(104 + t, t + 88, thread=AUTOGRAD),
        kernel("elementwise_kernel", t + 98, t + 110, 104 + t),
        event(spans.BACKWARD_NODE + ": EmbeddingBackward0", t + 120,
              t + 130, corr=12 + t, thread=AUTOGRAD, seq=5 + t, fwd=STEP),
        launch(105 + t, t + 122, thread=AUTOGRAD),
        kernel("embedding_backward_kernel", t + 130, t + 140, 105 + t),
        launch(106 + t, t + 135, thread=AUTOGRAD),
        kernel("add_kernel", t + 140, t + 150, 106 + t),
        launch(107 + t, t + 165, name="cuLaunchKernelEx"),
        kernel("multi_tensor_apply_kernel", t + 170, t + 180, 107 + t),
        kernel("memset", t + 185, t + 190, 999 + t),
        # the projection of a span onto the device is not work
        event("adamw", t + 170, t + 190, device=DeviceType.CUDA),
    ]


def segment(units=1, drop_marker=False):
    ev = []
    for k in range(units):
        ev += unit_events(t0=1000 * k)
    end = 1000 * units
    if not drop_marker:
        ev += [launch(9000, end - 804), kernel("spin_kernel", end - 800,
                                               end - 790, 9000)]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))


def phases():
    ph = trace.Phases()
    # the host clock 10 µs behind the device's first marker start
    ph.spans = [("step", 5e-6, 199e-6)]
    return ph


def read(units=1, keys=None, **kw):
    keys = keys or ["a"] * units
    return spans.read(segment(units, **kw), units, phases(), 10.0, keys)


def test_records_go_to_spans_by_launch_and_by_sequence_nr():
    t, why = read()
    assert why == "" and t.tries == 0
    got = {p: round(s * 1e6, 6) for p, (s, _) in t.by_path().items()}
    assert got == {"train_step/forward/ffn": 10,       # A, by launch
                   "train_step/forward/loss": 10,      # B
                   # C by sequence_nr, D: the recomputed span
                   "train_step/backward/ffn": 22,
                   # E (its forward under no inner span) and F
                   "train_step/backward": 20,
                   "train_step/adamw": 10,             # G
                   "outside": 5}                       # H: no launch
    assert t.records() == 8 and t.units[0]["spans"] == 8
    assert abs(t.span_s("ffn") - 32e-6) < 1e-12
    assert abs(t.span_s("backward") - 42e-6) < 1e-12
    assert abs(t.span_s("forward") - 20e-6) < 1e-12
    assert abs(t.fallback_share("backward") - 20 / 42) < 1e-12
    kinds = t.by_path_kind()
    assert kinds["train_step/backward/ffn"] == {"masked_matmul": 10e-6,
                                                "other": 12e-6}
    assert kinds["outside"] == {"copy": 5e-6}


def test_paths_sum_to_the_unit():
    t, _ = read()
    assert abs(t.units[0]["device_s"] - 77e-6) < 1e-12
    assert t.conservation() < 1e-12
    assert abs(t.busy_s - 77e-6) < 1e-12
    assert abs(t.window_s - 180e-6) < 1e-12
    assert abs(sum(t.gaps.values()) + t.busy_s - t.window_s) < 1e-12


def test_gaps_named_by_phase_and_span():
    t, _ = read()
    got = {k: round(v * 1e6, 6) for k, v in t.gaps.items()}
    assert got == {"step/ffn": 5 + 8,           # before A; before D (its
                   #                             thread's recomputed ffn)
                   "step/loss": 15,             # before B
                   "step/backward": 20 + 20,    # before C and before E
                   "step/adamw": 20 + 5,        # before G and H
                   "step/train_step": 10}       # before the last marker
    assert t.breakdown()["idle_gaps"][0] == ["step/backward",
                                             t.gaps["step/backward"]]


def test_units_average_and_stand_checks():
    t, _ = read(units=2)
    assert len(t.units) == 2 and t.records() == 8
    assert abs(t.span_s("adamw") - 10e-6) < 1e-12
    t, why = read(drop_marker=True)
    assert t is None and "markers" in why
    # two units of one shape must hold as many records
    ev = segment(2).profiler.kineto_results.events()
    short = [e for e in ev if e.name() != "add_kernel"
             or e.start_ns() > 1e6]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: short)))
    t, why = spans.read(prof, 2, phases(), 10.0, ["a", "a"])
    assert t is None and "records" in why
    t, _ = spans.read(prof, 2, phases(), 10.0, ["a", "b"])
    assert t is not None


def test_graft_and_flatten():
    assert spans._graft("train_step/backward",
                        "train_step/forward/attn") == "train_step/backward/attn"
    assert spans._graft("train_step/backward",
                        "train_step/forward") == "train_step/backward"
    line = spans._flatten([(0, 10, "a"), (2, 4, "b"), (4, 6, "c")])
    assert [spans._at(line, t) for t in (-1, 1, 2, 4, 5, 6, 10)] == [
        None, "a", "b", "c", "c", "a", None]


def test_metrics_of_each_kind():
    t, _ = read()
    assert spans.metric("adamw_ms.train", t) == 1e3 * 10e-6
    assert spans.metric("launches_per_step.train", t) == 8
    assert all(spans.metric(name, None) is None for name in spans.METRICS)
    line = {"metrics": {"step_mfu.train": {"value": 2.5, "unit": "%"}},
            "breakdown": {"device_ops": [["k", 1.0]],
                          "idle_gaps": [["step", 1.0]]}}
    out = spans.add_to_line(line, "train", t)
    assert sorted(out["metrics"]) == sorted(
        ["step_mfu.train"] + [n for n in spans.METRICS
                              if n.endswith(".train")])
    assert out["metrics"]["launches_per_step.train"]["unit"] == "count"
    assert out["breakdown"]["device_ops"] == [["k", 1.0]]
    assert out["breakdown"]["idle_gaps"][0][0] == "step/backward"
    assert line["metrics"].keys() == {"step_mfu.train"}


def test_a_segment_that_does_not_stand_leaves_the_line():
    t, _ = read(drop_marker=True)
    line = {"metrics": {"step_mfu.train": {"value": 2.5, "unit": "%"}},
            "breakdown": {"idle_gaps": [["step", 1.0]]}}
    assert spans.add_to_line(line, "train", t) is line
