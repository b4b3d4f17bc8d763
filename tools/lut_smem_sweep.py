#!/usr/bin/env python3
"""Sweep the smem LUT kernels' design choices on the card.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 tools/lut_smem_sweep.py [--out build/lut_smem_sweep.json]

For model A's mixed slabs (the level-3 artifact) and uniform slabs (its
raw tables), at batches 16, 1000 and 4096, it times
``csrc/lut_fused_smem.cu`` in the routed layout at every batch-rows-a-tile
(4, 8, 16, 32; ``smem_tile_rows`` is the rule) and block size (256, 512,
1024 threads), its output checked bit for bit against the plain version
first.  Each reading is device-paced: a spin kernel holds the stream
while the host queues the calls, and CUDA events bracket them (ms a
launch, gaps between kernels included; median of 5).  Then, at the routed
choice (``SMEM_THREADS``, ``smem_tile_rows``), in turns (global, bulk,
one-barrier, one-barrier, bulk, global): the per-stage mbarriers with the
1-D bulk copy against one ``__syncthreads`` with 16-byte loads by every
thread (``_launch_smem(bulk=False)``), and the first design (route
``global``), each also as ``torch.profiler`` device time
(``chip_smoke.device_ms``).  Last, the host's cost of one wrapper call
(``lut_network_mixed`` / ``lut_network``, microseconds of host clock a
call while a spin kernel holds the stream) on the routed ``smem`` route
and, with ``lut_fused_route`` replaced for the measurement, on the
``global`` route, in turns.  It prints ptxas's registers and spills of
the smem kernels, the card's name and power limit, and writes every
reading to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCHES = (16, 1000, 4096)
ROWS = (4, 8, 16, 32)
THREADS = (256, 512, 1024)
ITERS = 200
REPS = 5


def held_ms(torch, cs, fn) -> float:
    """Median over REPS of CUDA-event ms a call over ITERS calls queued
    behind a spin kernel (device-paced)."""
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cs.SPIN_CYCLES)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / ITERS)
    return statistics.median(times)


def host_us(torch, cs, fn) -> float:
    """Median over REPS of host-clock microseconds a call over ITERS calls
    issued while a spin kernel holds the stream (so none waits for the
    card)."""
    import time
    times = []
    for _ in range(REPS):
        torch.cuda._sleep(cs.SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        times.append((time.perf_counter() - t0) / ITERS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "lut_smem_sweep.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("lut_smem_sweep: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import lut_network as P

    _build.build(verbose=True)
    _build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    dev = torch.device("cuda")
    ref = np.load(cs.FIXTURE / "model_a_ref.npz")
    codes_all = torch.from_numpy(ref["codes"]).to(dev)
    triples = [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
               for i in range(len(ref["bws"]))]
    slabs_by = {
        "mixed": engine.load(str(cs.FIXTURE / "model_a_l3.npz"),
                             device=dev).slabs,
        "uniform": P.build_network_slabs(triples, device=dev),
    }
    plain_by = {"mixed": P.lut_network_mixed_plain,
                "uniform": P.lut_network_plain}
    result = {"card": smi, "iters": ITERS, "reps": REPS, "grid": {},
              "staging": {}}
    for name, slabs in slabs_by.items():
        for b in BATCHES:
            codes = codes_all[:b].contiguous()
            n_in = codes.shape[1]
            want = plain_by[name](codes, slabs)
            # the plain uniform output is a transposed view: the kernels
            # write row-major
            out = torch.empty((b, slabs.n_out), dtype=torch.int32,
                              device=dev)
            state = P._smem_state(slabs, n_in)
            layout = state.layout
            grid = {}
            for threads in THREADS:
                for rows in ROWS:
                    def fn(threads=threads, rows=rows):
                        P._launch_smem(codes, out, state, threads=threads,
                                       tile_rows=rows)
                    fn()
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        sys.exit(f"{name} batch {b} threads {threads} "
                                 f"rows {rows}: output differs from the "
                                 f"plain version")
                    grid[f"{threads}x{rows}"] = held_ms(torch, cs, fn)
            best = min(grid, key=grid.get)
            rule = P.smem_tile_rows(b, layout.tile_b,
                                    P._sm_count(dev.index or 0))
            result["grid"][f"{name}_b{b}"] = grid
            print(f"{name} batch {b}: ms a launch (device-paced) by "
                  f"threads x rows a tile: "
                  + " ".join(f"{k}={v:.5f}" for k, v in grid.items())
                  + f"; best {best}; routed {P.SMEM_THREADS}x{rule}",
                  flush=True)

            calls = {
                "bulk": lambda: P._launch_smem(codes, out, state),
                "one_barrier": lambda: P._launch_smem(codes, out, state,
                                                      bulk=False),
                "global": lambda: P._launch_global(codes, slabs, out),
            }
            turns = {k: [] for k in calls}
            for k in ("global", "bulk", "one_barrier", "one_barrier",
                      "bulk", "global"):
                turns[k].append(held_ms(torch, cs, calls[k]))
            dev_ms = {k: cs.device_ms(fn, ITERS) for k, fn in calls.items()}
            result["staging"][f"{name}_b{b}"] = {
                "tile_rows": rule, "threads": P.SMEM_THREADS,
                "held_ms": turns, "device_ms": dev_ms}
            print(f"{name} batch {b} at {P.SMEM_THREADS}x{rule}: "
                  + " ".join(f"{k} held {statistics.mean(v):.5f} ms "
                             f"({', '.join(f'{x:.5f}' for x in v)}) device "
                             f"{dev_ms[k]}" for k, v in turns.items()),
                  flush=True)
    result["host_us"] = {}
    routed = P.lut_fused_route
    wrappers = {"mixed": P.lut_network_mixed, "uniform": P.lut_network}
    for name, slabs in slabs_by.items():
        codes = codes_all[:16].contiguous()
        turns = {"smem": [], "global": []}
        for route in ("global", "smem", "smem", "global"):
            P.lut_fused_route = routed if route == "smem" else (
                lambda layout: "global")
            try:
                turns[route].append(host_us(
                    torch, cs, lambda: wrappers[name](codes, slabs)))
            finally:
                P.lut_fused_route = routed
        result["host_us"][name] = turns
        print(f"{name} batch 16: host us a wrapper call: "
              + " ".join(f"{k} {statistics.mean(v):.2f} ({v})"
                         for k, v in turns.items()), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "out": args.out}), flush=True)


if __name__ == "__main__":
    main()
