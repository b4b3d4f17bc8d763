"""Run one cell of BENCHMARK.json as ``portbench/run.py --trace 1`` does,
with the span segment (``portbench/harness/spans.py``) after the plain
traced segment, and report what the program's step spans show.

    python3 tools/span_profile.py --workload <cell> --seed <n> \
        --seconds <s> [--cost-units 8] [--out spans.json]

from the root of a checkout, on a machine with a CUDA device.  The
harness's cell modules (``portbench/harness/{train,prefill}.py``) call
``trace.traced`` once, after the window and before the reference; here
that name in each of them is replaced by a function that runs, on the
same units, the plain segment (whose trace the run's per-layer metrics
read, as in a traced run), then the span segment, then ``--cost-units``
units alternating spans off and on without the profiler (the spans' host
cost).  The last line of standard output is the run's result line with
the span metrics added and its idle gaps named by span; ``--out`` gets
the line with the span segment's device time, launches and spans a
unit by path, the share of ``backward`` linked to no forward span, the
two segments' windows and idle shares, and the spans' cost.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def span_ns(n: int = 200_000) -> dict:
    """Host ns of one ``with span(...)`` block, spans off and on (no
    profiler running)."""
    from repro_torch.obs.trace import span, spans_enabled

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("forward"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = loop()
    with spans_enabled():
        on = loop()
    return {"off": off, "on": on}


def unit_cost(run_unit, units: int) -> dict:
    """Host ms of ``units`` units (each ended by a synchronise), spans off
    and on in turns (off, on, on, off, ...), by the unit's key; the mean
    over keys of the on units' median less the off units'."""
    import torch
    from portbench.harness.trace import no_phases
    from repro_torch.obs.trace import spans_enabled
    out: dict = {"off": {}, "on": {}}
    for k in range(units):
        on = k % 4 in (1, 2)
        t0 = time.perf_counter()
        if on:
            with spans_enabled():
                key = run_unit(no_phases)
        else:
            key = run_unit(no_phases)
        torch.cuda.synchronize()
        out["on" if on else "off"].setdefault(key, []).append(
            1e3 * (time.perf_counter() - t0))
    both = [key for key in out["on"] if key in out["off"]]
    diffs = [statistics.median(out["on"][key])
             - statistics.median(out["off"][key]) for key in both]
    off = [statistics.median(out["off"][key]) for key in both]
    return {"ms_by_key": {s: {str(k): v for k, v in d.items()}
                          for s, d in out.items()},
            "on_less_off_ms": statistics.mean(diffs) if diffs else None,
            "off_ms": statistics.mean(off) if off else None}


def idle_share(t) -> float:
    return 1.0 - t.busy_s / t.window_s


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost-units", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from portbench.harness import prefill, runner, spans, spec, train, trace
    from portbench.harness.log import note
    from portbench.run import power_limit
    cell = spec.cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        sys.exit("span_profile: no CUDA device is visible")
    torch.set_num_threads(2)
    got: dict = {}

    def with_spans(run_unit, n, lead=1, tries=3):
        got["plain"] = trace.traced(run_unit, n, lead, tries)
        got["spans"] = spans.traced(run_unit, n, lead, tries)
        got["cost"] = unit_cost(run_unit, args.cost_units)
        return got["plain"]

    train.traced = prefill.traced = with_spans
    line = runner.run(cell, args.seed, args.seconds, True, "cuda", T_START)
    st, plain = got["spans"], got["plain"]
    line = spans.add_to_line(line, cell.kind, st)
    report = {"workload": args.workload, "seed": args.seed,
              "card": power_limit(), "line": line,
              "span_ns": span_ns(), "unit_cost": got["cost"],
              "plain": {"window_s_a_unit": plain.window_s / len(plain.units),
                        "idle_share": idle_share(plain),
                        "tries": plain.tries, "gaps_s": plain.gaps}}
    if st is not None:
        n_spans = [u["spans"] for u in st.units]
        report["spans"] = {
            "window_s_a_unit": st.window_s / len(st.units),
            "idle_share": idle_share(st), "tries": st.tries,
            "conservation": st.conservation(),
            "backward_fallback_share": st.fallback_share("backward"),
            "spans_a_unit": n_spans,
            "by_path_ms_records": {p: [1e3 * s, n] for p, (s, n)
                                   in st.by_path().items()},
            "by_path_kind_ms": {p: {k: 1e3 * s for k, s in kinds.items()}
                                for p, kinds in st.by_path_kind().items()},
            "gaps_s": st.gaps}
        for p, (s, n) in st.by_path().items():
            note(f"span {p}: {1e3 * s:.3f} device ms, {n:.1f} records a "
                 f"unit")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in report if k != "line"},
                     indent=1)[:20000], file=sys.stderr)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
