#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` and serves fpga4hep model A (16 -> 64 -> 64 -> 64, fan-in 3, 3-bit
codes) from the committed fixture (``tests/fixtures/torch_port``: the
reference's level-3 artifact, the raw truth tables and the reference's
outputs on 4096 seeded input rows).  Phases, each of which must pass:

1. **kernels** — each of the three LUT kernels (mixed fused, uniform fused,
   per-layer) at model A's widths, at batches 0, 1, 16, 1000 and 4096,
   called directly and through the engine: bit-exact against its plain
   PyTorch version on the card and against the reference's outputs.
2. **serving** — for each layout, every launch counter set to 0, then
   ``run_closed_loop`` (4 clients x 4 requests of 1-8 rows, 3-bit codes)
   through ``ServingTier``: outputs bit-exact with ``net(codes)``, zero
   kernel builds and zero compiler runs after warmup, and the layout's
   kernel launched.  Its launch count is what the ``kernels`` line reports.
3. **times** — median CUDA-event time per forward of each kernel and of its
   plain version at batch 16 (the serving bucket) and 4096, calls issued
   back to back from Python (so host launch gaps count), and the device
   time per forward that ``torch.profiler`` records for the kernels alone
   (``device_ms``), beside the bound: the larger of the bytes the forward
   must move (codes in, codes out, slabs once) over 3.35 TB/s and its
   int32 operations over 33.5 TOP/s (half the 67 TFLOP/s fp32 CUDA-core
   rate: Hopper has 64 INT32 lanes per SM against 128 FP32).  No single PyTorch call computes
   these functions, so ``library_ms`` is null.

The next-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout,
it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port"
BATCHES = (0, 1, 16, 1000, 4096)
TIME_BATCHES = (16, 4096)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
SOURCE = "src/repro_torch/kernels/csrc/lut_kernels.cu"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, iters: int, reps: int = 7) -> float:
    """Median over ``reps`` of CUDA-event time per call over ``iters``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int) -> float | None:
    """Device time per call of every kernel ``fn`` launches, from the
    profiler's CUDA activity (None when the profiler records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir() or not FIXTURE.is_dir():
        fail(f"{ROOT} is not a checkout of the repo (no src/repro_torch or "
             f"tests/fixtures/torch_port)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import engine, serve
    from repro_torch.kernels import _build
    from repro_torch.kernels.lut_lookup import lut_lookup, lut_lookup_plain
    from repro_torch.kernels.lut_network import (lut_network,
                                                 lut_network_mixed,
                                                 lut_network_mixed_plain,
                                                 lut_network_plain)

    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"kernel library built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: {_build.library_path().name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    ref = np.load(FIXTURE / "model_a_ref.npz")
    codes_all = torch.from_numpy(ref["codes"]).to(dev)
    triples = [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
               for i in range(len(ref["bws"]))]
    nets = {
        "mixed": engine.load(str(FIXTURE / "model_a_l3.npz")),
        "uniform": engine.compile_network(triples, block_b=16),
        "per_layer": engine.compile_network(triples, fused=False,
                                            block_b=16),
    }
    for layout, net in nets.items():
        if net.layout != layout or net.device.type != "cuda":
            fail(f"{layout}: engine chose {net.layout} on {net.device}")

    def per_layer_kernel(c):
        for idx, tab, bw in nets["per_layer"].layers:
            c = lut_lookup(c, idx, tab, bw)
        return c

    def per_layer_plain(c):
        for idx, tab, bw in nets["per_layer"].layers:
            c = lut_lookup_plain(c, idx, tab, bw)
        return c

    s_mixed, s_uniform = nets["mixed"].slabs, nets["uniform"].slabs
    kernels = {
        "mixed": dict(
            name="lut_mixed_forward", wrapper=lut_network_mixed,
            kernel=lambda c: lut_network_mixed(c, s_mixed),
            plain=lambda c: lut_network_mixed_plain(c, s_mixed),
            replaces="src/repro/kernels/lut_network.py:541",
            slab_bytes=nbytes(s_mixed.idx_slab, s_mixed.shift_slab,
                              s_mixed.width_slab, s_mixed.table_slab,
                              s_mixed.row_meta, s_mixed.layer_meta,
                              s_mixed.perm),
            # per neuron element: mask, shift, add; per code: bound, address
            ops_per_row=sum(m.n_out * (3 * m.fan_in + 2)
                            for m in s_mixed.meta)),
        "uniform": dict(
            name="lut_uniform_forward", wrapper=lut_network,
            kernel=lambda c: lut_network(c, s_uniform),
            plain=lambda c: lut_network_plain(c, s_uniform),
            replaces="src/repro/kernels/lut_network.py:270",
            slab_bytes=nbytes(s_uniform.idx_slab, s_uniform.table_slab,
                              s_uniform.layer_meta, s_uniform.perm),
            ops_per_row=sum(m.n_out * (2 * m.fan_in + 2)
                            for m in s_uniform.meta)),
        "per_layer": dict(
            name="lut_layer_forward", wrapper=lut_lookup,
            kernel=per_layer_kernel, plain=per_layer_plain,
            replaces="src/repro/kernels/lut_lookup.py:86",
            slab_bytes=sum(nbytes(i, t)
                           for i, t, _ in nets["per_layer"].layers),
            ops_per_row=sum(i.shape[0] * (2 * i.shape[1] + 2)
                            for i, _, _ in nets["per_layer"].layers)),
    }
    n_in, n_out = codes_all.shape[1], nets["mixed"].n_out

    # -- phase 1: every kernel against its plain version and the reference
    for layout, k in kernels.items():
        want_all = ref[f"out_{layout}"]
        k["max_abs_err"] = 0
        for b in BATCHES:
            codes = codes_all[:b].contiguous()
            before = k["wrapper"].launches
            got = k["kernel"](codes)
            via_engine = nets[layout](codes)
            plain = k["plain"](codes)
            torch.cuda.synchronize()
            launched = k["wrapper"].launches - before
            if b and not launched:
                fail(f"{k['name']} batch {b}: kernel not launched")
            if b == 0 and launched:
                fail(f"{k['name']} batch 0 launched a kernel")
            err = int((got.long() - plain.long()).abs().max()) if b else 0
            k["max_abs_err"] = max(k["max_abs_err"], err)
            want = torch.from_numpy(want_all[:b]).to(dev)
            for what, out in (("kernel", got), ("engine", via_engine),
                              ("plain", plain)):
                if out.shape != (b, n_out) or out.dtype != torch.int32:
                    fail(f"{k['name']} batch {b}: {what} gave "
                         f"{out.dtype} {tuple(out.shape)}")
                if not torch.equal(out, want):
                    fail(f"{k['name']} batch {b}: {what} output differs "
                         f"from the reference's")
        log(f"phase 1 {k['name']}: bit-exact vs plain and reference at "
            f"batches {BATCHES}")

    # -- phase 2: the main path, serving each layout through the tier
    for layout, k in kernels.items():
        for other in kernels.values():
            other["wrapper"].launches = 0
        rep = serve.run_closed_loop(nets[layout], n_clients=4,
                                    n_per_client=4, rows_min=1, rows_max=8,
                                    bw=3, seed=0)
        k["launches"] = k["wrapper"].launches
        st = rep.stats
        if not k["launches"]:
            fail(f"serving {layout}: {k['name']} was never launched")
        if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
            fail(f"serving {layout}: compile-once contract broken: {st}")
        legs = " ".join(f"{leg}={rep.breakdown[leg]['mean_ms']:.3f}"
                        for leg in ("queue_wait", "assembly", "device"))
        log(f"phase 2 serving {layout}: {rep.n_requests} requests "
            f"({rep.rows} rows) bit-exact, p50={rep.p50_ms:.3f} ms "
            f"p99={rep.p99_ms:.3f} ms, {rep.rows_per_sec:.0f} rows/s, "
            f"{st['batches']} batches (flushes {st['flush_causes']}), "
            f"mean legs ms: {legs}; {k['name']} launches={k['launches']}, "
            f"retraces={st['retraces_after_warmup']} "
            f"compiler_runs={st['compiler_runs_after_warmup']}")

    # -- phase 3: times beside the bound
    records = []
    for layout, k in kernels.items():
        rec = {"name": k["name"], "route": "cuda", "source": SOURCE,
               "replaces": k["replaces"], "launches": k["launches"],
               "max_abs_err": k["max_abs_err"]}
        for b in TIME_BATCHES:
            codes = codes_all[:b].contiguous()
            iters = 200 if b <= 16 else 50
            ms = cuda_ms(lambda: k["kernel"](codes), iters)
            plain_ms = cuda_ms(lambda: k["plain"](codes), iters)
            dev_ms = device_ms(lambda: k["kernel"](codes), iters)
            moved = b * (n_in + n_out) * 4 + k["slab_bytes"]
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = b * k["ops_per_row"] / INT32_OPS_PER_S * 1e3
            suffix = "" if b == TIME_BATCHES[0] else f"_b{b}"
            rec.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                        f"device_ms{suffix}": dev_ms,
                        f"bound_ms{suffix}": max(bytes_ms, ops_ms),
                        f"bound_by{suffix}": ("bytes" if bytes_ms >= ops_ms
                                              else "operations")})
            log(f"phase 3 {k['name']} batch {b}: {ms:.5f} ms/forward, "
                f"device {dev_ms} ms, plain {plain_ms:.5f} ms, bound "
                f"{max(bytes_ms, ops_ms):.6f} ms ({moved} B)")
        rec["library_ms"] = None
        rec["batch"] = TIME_BATCHES[0]
        records.append(rec)

    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
