#!/usr/bin/env python3
"""Sweep the per-layer LUT kernel's design choices on the card.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 tools/lut_layer_sweep.py [--out build/lut_layer_sweep.json]

For fpga4hep model A's raw tables (3 layers, ``model_a_ref.npz``) and
model D's (4 layers, ``model_d_ref.npz``), at batches 16, 128, 256, 1000
and 4096, it times a whole per-layer forward, every launch of it called
directly (uncounted), over: the tables' entry type (int32 as stored, or a
uint8 copy), the route (``smem``: tables staged in shared memory;
``direct``: read in place; both from ``csrc/lut_layer_smem.cu``), neurons
a tile (``TILE_O``, as a cap: a layer takes fewer where its tables do not
fit) and rows a batch tile (``TILE_B``), with programmatic dependent
launch; then, in turns (first design, rule, rule on uint8 tables, rule
without PDL, rule with the dependents launched at the kernel's start, and
back), the routes the rule picks (``lut_layer_route``) against the first
design (``lut_layer_forward`` in ``csrc/lut_kernels.cu``).  Every
configuration's output is checked bit for bit against the plain chain
first.  Each reading is device-paced
(``chip_smoke.paced_ms``: a spin kernel holds the stream while the host
queues 50 forwards, CUDA events bracket them; ms a forward, gaps between
kernels included, median of 5).  Last, the host's cost of one wrapper
call at batch 16 (microseconds of host clock while a spin kernel holds
the stream), the routed ``lut_lookup`` against the first design behind
the same checks, in turns.  It prints ptxas's registers and spills, the
card's name and power limit, and writes every reading to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCHES = (16, 128, 256, 1000, 4096)
TILE_O = (8, 16, 32, 64)
TILE_B = (4, 8, 16, 32, 64, 128)
HOST_ITERS = 200
REPS = 5


def host_us(torch, cs, fn) -> float:
    """Median over REPS of host-clock microseconds a call over HOST_ITERS
    calls issued while a spin kernel holds the stream."""
    import time
    times = []
    for _ in range(REPS):
        torch.cuda._sleep(cs.SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_ITERS):
            fn()
        times.append((time.perf_counter() - t0) / HOST_ITERS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "lut_layer_sweep.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("lut_layer_sweep: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import lut_lookup as L

    _build.build(verbose=True)
    _build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    dev = torch.device("cuda")
    sms = L._sm_count(dev.index or 0)
    models = {}
    for name, fixture in (("A", "model_a_ref.npz"), ("D", "model_d_ref.npz")):
        ref = np.load(cs.FIXTURE / fixture)
        layers = [tuple(torch.from_numpy(ref[f"{a}_{i}"]).to(dev)
                        for a in ("idx", "table")) + (int(ref["bws"][i]),)
                  for i in range(len(ref["bws"]))]
        # the same tables as uint8 (every entry of models A and D fits)
        layers8 = [(i, t.to(torch.uint8), bw) for i, t, bw in layers]
        assert all(torch.equal(t8.to(torch.int32), t) for (_, t, _), (
            _, t8, _) in zip(layers, layers8))
        models[name] = (torch.from_numpy(ref["codes"]).to(dev), layers,
                        layers8)

    def chain(layers, route, pdl=1, tile_o=None, tile_b=None):
        """A forward with every launch called directly: ``route`` "smem" or
        "direct" (forced, at the caps given), "rule" or "first"."""
        def call(c):
            for idx, tab, bw in layers:
                out = torch.empty((c.shape[0], idx.shape[0]),
                                  dtype=torch.int32, device=dev)
                if route == "first":
                    L._launch_first(c, idx, tab, bw, out)
                else:
                    geom = L.lut_layer_route(
                        c.shape[0], c.shape[1], idx.shape[0], idx.shape[1],
                        tab.shape[1], sms, tab.element_size(),
                        route=None if route == "rule" else route,
                        tile_o=tile_o, tile_b=tile_b)
                    L._launch_layer(c, idx, tab, bw, out, geom, pdl=pdl)
                c = out
            return c
        return call

    def plain(layers, c):
        for idx, tab, bw in layers:
            c = L.lut_lookup_plain(c, idx, tab, bw)
        return c

    result = {"card": smi, "reps": REPS, "paced_iters": cs.PACED_ITERS,
              "grid": {}, "turns": {}, "rule": {}, "host_us": {}}
    for name, (codes_all, layers, layers8) in models.items():
        for b in BATCHES:
            codes = codes_all[:b].contiguous()
            want = plain(layers, codes)

            def reading(fn, what):
                got = fn(codes)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"model {name} batch {b} {what}: output "
                             f"differs from the plain chain")
                return cs.paced_ms(lambda: fn(codes))

            grid = {}
            for dtype, tabs in (("int32", layers), ("uint8", layers8)):
                for route in ("smem", "direct"):
                    for to in TILE_O:
                        for tb in TILE_B:
                            k = f"{dtype}/{route}/o{to}/b{tb}"
                            grid[k] = reading(
                                chain(tabs, route, tile_o=to, tile_b=tb), k)
            found = {k: v for k, v in grid.items() if v is not None}
            best = min(found, key=found.get) if found else None
            used, n_in = [], codes.shape[1]
            for idx, tab, _ in layers:
                g = L.lut_layer_route(b, n_in, idx.shape[0], idx.shape[1],
                                      tab.shape[1], sms)
                used.append(g._asdict())
                n_in = idx.shape[0]
            fns = {"first": chain(layers, "first"),
                   "rule": chain(layers, "rule"),
                   "rule_uint8": chain(layers8, "rule"),
                   "rule_no_pdl": chain(layers, "rule", pdl=0),
                   "rule_trigger_first": chain(layers, "rule", pdl=2)}
            turns = {k: [] for k in fns}
            for k in ("first", "rule", "rule_uint8", "rule_no_pdl",
                      "rule_trigger_first", "rule_trigger_first",
                      "rule_no_pdl", "rule_uint8", "rule", "first"):
                turns[k].append(reading(fns[k], k))
            key = f"{name}_b{b}"
            result["grid"][key] = grid
            result["turns"][key] = turns
            result["rule"][key] = used
            print(f"model {name} batch {b}: ms a forward (device-paced) by "
                  f"tables/route/neurons a tile/rows a tile: "
                  + " ".join(f"{k}={v}" for k, v in grid.items())
                  + f"; best {best} {grid.get(best)}", flush=True)
            rule = [(g["route"], g["tile_o"], g["tile_b"], g["grid_o"],
                     g["grid_b"]) for g in used]
            print(f"model {name} batch {b} in turns: "
                  + " ".join(f"{k} {v}" for k, v in turns.items())
                  + f"; rule (route, tile_o, tile_b, grid_o, grid_b): "
                  f"{rule}", flush=True)
    for name, (codes_all, layers, _) in models.items():
        codes = codes_all[:16].contiguous()
        idx, tab, bw = layers[1]
        x = plain(layers[:1], codes).contiguous()

        def first_wrapped():
            out = L._layer_args(x, idx, tab, "lut_lookup")
            L._launch_first(x, idx, tab, bw, out)

        turns = {"routed": [], "first": []}
        for k in ("first", "routed", "routed", "first"):
            turns[k].append(host_us(
                torch, cs, first_wrapped if k == "first"
                else (lambda: L.lut_lookup(x, idx, tab, bw))))
        result["host_us"][name] = turns
        print(f"model {name} layer 1 batch 16: host us a wrapper call: "
              + " ".join(f"{k} {statistics.mean(v):.2f} ({v})"
                         for k, v in turns.items()), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "out": args.out}), flush=True)


if __name__ == "__main__":
    main()
