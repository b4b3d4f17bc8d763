#!/usr/bin/env python3
"""Sweep the per-layer LUT kernel's design choices on the card.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 tools/lut_layer_sweep.py [--out build/lut_layer_sweep.json]
                                     [--only models|mnist]

For fpga4hep model A's raw tables (3 layers, ``model_a_ref.npz``) and
model D's (4 layers, ``model_d_ref.npz``), at batches 16, 128, 256, 1000
and 4096, it times a whole per-layer forward, every launch of it called
directly (uncounted), over: the tables' entry type (int32 as stored, or a
uint8 copy), the route (``smem``: tables staged in shared memory;
``direct``: read in place; both from ``csrc/lut_layer_smem.cu``), neurons
a tile (``TILE_O``, as a cap: a layer takes fewer where its tables do not
fit) and rows a batch tile (``TILE_B``); then, in turns (rule, rule on
uint8 tables, and back), the routes the rule picks (``lut_layer_route``).
Every configuration's output is checked bit for bit against the plain
chain first.  Each reading is device-paced
(``chip_smoke.paced_ms``: a spin kernel holds the stream while the host
queues 50 forwards, CUDA events bracket them; ms a forward, gaps between
kernels included, median of 5).  Last, the host's cost of one
``lut_lookup`` call at batch 16 (microseconds of host clock while a spin
kernel holds the stream), twice.

Then the MNIST widths (``--only mnist`` runs this part alone): the
layers of Table 7.1's widest MLP (784 -> 2048 and 2048 -> 2048 at fan-in
5, 2-bit codes, 1024-entry int32 tables; seeded random tables and codes)
at batches 1, 16, 256 and 4096, each layer launch timed device-paced on
the rule's route, on each route forced at its own geometry, and on route
``direct`` at larger neuron tiles (``MNIST_DIRECT_TILE_O``), beside the
staged-codes bytes each geometry copies into shared memory summed over
its blocks (``lut_lookup.staged_codes_bytes``); and the whole 784 -> 2048 ->
2048 -> 2048 forward by the rule and on each route forced.  It prints
ptxas's registers and spills, the card's name and power limit, and
writes every reading to ``--out``.
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
MNIST_BATCHES = (1, 16, 256, 4096)
# (n_in, n_out, fan_in, bw): the layers of mlp((2048, 2048, 2048), 2, 5)
MNIST_LAYERS = ((784, 2048, 5, 2), (2048, 2048, 5, 2))
MNIST_DIRECT_TILE_O = (64, 128, 256)


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


def mnist_sweep(torch, cs, L, dev, sms, chain, plain) -> dict:
    """The MNIST-width readings (see the module docstring)."""
    import numpy as np

    rng = np.random.default_rng(0)
    layers = []
    for n_in, n_out, fan_in, bw in MNIST_LAYERS + MNIST_LAYERS[1:]:
        idx = np.stack([np.sort(rng.choice(n_in, fan_in, replace=False))
                        for _ in range(n_out)]).astype(np.int32)
        tab = rng.integers(0, 2 ** bw, (n_out, 2 ** (fan_in * bw)),
                           dtype=np.int32)
        layers.append((torch.from_numpy(idx).to(dev),
                       torch.from_numpy(tab).to(dev), bw))
    codes_all = torch.from_numpy(rng.integers(
        0, 4, (max(MNIST_BATCHES), MNIST_LAYERS[0][0]),
        dtype=np.int32)).to(dev)
    out = {}
    for b in MNIST_BATCHES:
        codes = codes_all[:b].contiguous()
        want = plain(layers, codes)
        ins = [codes]
        for idx, tab, bw in layers[:-1]:
            ins.append(L.lut_lookup_plain(ins[-1], idx, tab, bw))
        rec = {"layers": {}, "forward": {}}
        for li, (n_in, n_out, fan_in, _) in enumerate(MNIST_LAYERS):
            x = ins[li].contiguous()
            one = [layers[li]]
            ref = plain(one, x)
            n_e = layers[li][1].shape[1]
            geoms = {"rule": L.lut_layer_route(b, n_in, n_out, fan_in, n_e,
                                               sms)}
            for route in ("smem", "direct"):
                try:
                    geoms[route] = L.lut_layer_route(b, n_in, n_out, fan_in,
                                                     n_e, sms, route=route)
                except ValueError:
                    pass
            for to in MNIST_DIRECT_TILE_O:
                geoms[f"direct/o{to}"] = L.lut_layer_route(
                    b, n_in, n_out, fan_in, n_e, sms, route="direct",
                    tile_o=to)
            readings = {}
            for key, g in geoms.items():
                fn = chain(one, g.route, tile_o=g.tile_o, tile_b=g.tile_b)
                got = fn(x)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    sys.exit(f"mnist layer {n_in}->{n_out} batch {b} {key}: "
                             f"output differs from the plain version")
                readings[key] = {
                    "ms": cs.paced_ms(lambda: fn(x)), **g._asdict(),
                    "staged_codes_bytes": L.staged_codes_bytes(g, b, n_in)}
            rec["layers"][f"{n_in}->{n_out}"] = readings
            print(f"mnist layer {n_in}->{n_out} batch {b}: "
                  + " ".join(f"{k}={v['ms']} ms ({v['route']} o{v['tile_o']} "
                             f"b{v['tile_b']} grid {v['grid_o']}x"
                             f"{v['grid_b']}, {v['staged_codes_bytes']} B "
                             f"staged)" for k, v in readings.items()),
                  flush=True)
        for route in ("rule", "smem", "direct"):
            fn = chain(layers, route)
            try:
                got = fn(codes)
            except ValueError as e:
                rec["forward"][route] = str(e)
                continue
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                sys.exit(f"mnist forward batch {b} {route}: output differs "
                         f"from the plain chain")
            rec["forward"][route] = cs.paced_ms(lambda: fn(codes))
        print(f"mnist forward 784->2048->2048->2048 batch {b}: "
              + " ".join(f"{k}={v}" for k, v in rec["forward"].items()),
              flush=True)
        out[f"b{b}"] = rec
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "lut_layer_sweep.json"))
    ap.add_argument("--only", choices=("models", "mnist"), default=None,
                    help="run one part of the sweep")
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

    def chain(layers, route, tile_o=None, tile_b=None):
        """A forward with every launch called directly: ``route`` "smem" or
        "direct" (forced, at the caps given) or "rule"."""
        def call(c):
            for idx, tab, bw in layers:
                out = torch.empty((c.shape[0], idx.shape[0]),
                                  dtype=torch.int32, device=dev)
                geom = L.lut_layer_route(
                    c.shape[0], c.shape[1], idx.shape[0], idx.shape[1],
                    tab.shape[1], sms, tab.element_size(),
                    route=None if route == "rule" else route,
                    tile_o=tile_o, tile_b=tile_b)
                L._launch_layer(c, idx, tab, bw, out, geom)
                c = out
            return c
        return call

    def plain(layers, c):
        for idx, tab, bw in layers:
            c = L.lut_lookup_plain(c, idx, tab, bw)
        return c

    result = {"card": smi, "reps": REPS, "paced_iters": cs.PACED_ITERS,
              "grid": {}, "turns": {}, "rule": {}, "host_us": {}}
    if args.only == "mnist":
        models = {}
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
            fns = {"rule": chain(layers, "rule"),
                   "rule_uint8": chain(layers8, "rule")}
            turns = {k: [] for k in fns}
            for k in ("rule", "rule_uint8", "rule_uint8", "rule"):
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
        turns = {"routed": [host_us(torch, cs,
                                    lambda: L.lut_lookup(x, idx, tab, bw))
                            for _ in range(2)]}
        result["host_us"][name] = turns
        print(f"model {name} layer 1 batch 16: host us a wrapper call: "
              + " ".join(f"{k} {statistics.mean(v):.2f} ({v})"
                         for k, v in turns.items()), flush=True)
    if args.only != "models":
        result["mnist"] = mnist_sweep(torch, cs, L, dev, sms, chain, plain)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "out": args.out}), flush=True)


if __name__ == "__main__":
    main()
