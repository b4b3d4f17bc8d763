"""Readings that the output check's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 101,102,103 [--out <file.json>]

For each of ``--seeds``: the program's readings of a sound run against
the reference (the lower readings).  For each of ``--control-seeds``: the
control, the reference computed with float8 e4m3 products put in the
program's place, against the float32 reference (the upper readings); for a
training cell also the fault "half of the batch left out, the mean taken
over the rest", planted in the reference put in the program's place.  A
state left unchanged reads 1 on ``change_gap`` and needs no run.

Training cells drive the program's set-up exactly as a run does (its
check steps); a prefill cell runs the calls a run's check compares,
back to back at the cell's own load.  Prints one JSON object: each
number's readings, and each seed judged under the committed limits.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def half_batches(batches: list[dict]) -> list[dict]:
    return [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]


def train_readings(cell, seeds, control_seeds, device) -> dict:
    from portbench.harness import check, train
    from portbench.harness.train import hyper
    out = {"sound": {}, "control": {}, "half_batch": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        state, step, batches, prog = train.setup(cell, seed, device)
        del state, step
        _free()
        ref = train.reference(cell, seed, batches, device)
        out["sound"][seed] = check.train_numbers(prog, ref)
        out.setdefault("worst_leaves", {})[seed] = check.worst_leaves(prog,
                                                                      ref)
        _free()
        log(f"seed {seed}: {out['sound'][seed]} "
            f"({time.perf_counter() - t0:.1f} s)")
    for seed in control_seeds:
        from portbench.harness.gen import TrainBatches, make_params
        from portbench.reference.train import follow
        cfg, tr = cell.config, cell.traffic
        batches = TrainBatches(seed, tr["batch"], tr["seq_len"],
                               cfg["vocab"], device)
        ref = train.reference(cell, seed, batches, device)
        _free()
        ctl = train.reference(cell, seed, batches, device, prec="fp8")
        out["control"][seed] = check.train_numbers(ctl, ref)
        out.setdefault("control_worst_leaves", {})[seed] = \
            check.worst_leaves(ctl, ref)
        _free()
        half = follow(cfg, make_params(cfg, seed, device),
                      half_batches(batches.first(tr["check_steps"])),
                      hyper(tr), lambda: make_params(cfg, seed, device))
        out["half_batch"][seed] = check.train_numbers(half, ref)
        _free()
        zero = dict.fromkeys(ref["grads"], 0.0)
        out.setdefault("state_unchanged", {})[seed] = check.train_numbers(
            {"losses": ref["losses"], "grads": zero, "changes": zero}, ref)
        log(f"control seed {seed}: {out['control'][seed]}; half batch "
            f"{out['half_batch'][seed]}")
    return out


def prefill_readings(cell, seeds, control_seeds, device) -> dict:
    import torch

    from portbench.harness import gen, port, prefill
    from portbench.reference.model import exact_matmuls, last_logits
    cfg, tr = cell.config, cell.traffic
    out = {"sound": {}, "control": {}}

    def calls_of(seed):
        lengths = [n for n in sorted(set(gen.length_block(tr["lengths"])))
                   for _ in range(int(tr["check_per_length"]))]
        prompts = gen.Prompts(seed, "prompts", tr["tokens_per_call"],
                              cfg["vocab"], device)
        return [{"length": n, "tokens": prompts.next(n)} for n in lengths]

    for seed in seeds:
        t0 = time.perf_counter()
        mcfg = port.model_cfg(cfg)
        model = port.serving_model(mcfg, gen.make_params(cfg, seed, device))
        step = port.prefill_step(mcfg)
        calls = calls_of(seed)
        for c in calls:
            c["served"] = step(model, {"tokens": c["tokens"]}).argmax(-1)
        del model, step
        _free()
        params = gen.make_params(cfg, seed, device)
        out["sound"][seed] = {"token_gap": prefill.token_gap(cfg, params,
                                                             calls)}
        del params
        _free()
        log(f"seed {seed}: {out['sound'][seed]} "
            f"({time.perf_counter() - t0:.1f} s)")
    for seed in control_seeds:
        params = gen.make_params(cfg, seed, device)
        calls = [dict(c, served=torch.zeros(1)) for c in calls_of(seed)]

        def fp8_pick(tokens):
            with exact_matmuls():
                return last_logits(params, cfg, tokens, "fp8").argmax(-1)

        out["control"][seed] = {"token_gap": prefill.token_gap(
            cfg, params, calls, served=fp8_pick)}
        del params
        _free()
        log(f"control seed {seed}: {out['control'][seed]}")
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def summary(readings: dict) -> dict:
    """Per number: the lower reading (the largest sound one), the control's
    smallest, each fault's smallest."""
    out = {}
    if not readings["sound"]:
        return out
    for name in next(iter(readings["sound"].values())):
        row = {"lower": max(r[name] for r in readings["sound"].values())}
        for key in ("control", "half_batch", "state_unchanged"):
            if readings.get(key):
                row[key] = min(r[name] for r in readings[key].values())
        out[name] = row
    return out


def judged(readings: dict, limits: dict) -> dict:
    """``correct`` of each seed's readings under the committed limits
    (``portbench/limits/<workload>.json``): true for the sound seeds,
    false for the control's and the faults'."""
    from portbench.harness import check
    return {key: {seed: check.judge(r, limits)[0]
                  for seed, r in readings[key].items()}
            for key in ("sound", "control", "half_batch", "state_unchanged")
            if readings.get(key)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import spec
    cell = spec.cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    fn = train_readings if cell.kind == "train" else prefill_readings
    readings = fn(cell, seeds, control, args.device)
    result = {"workload": args.workload, "readings": readings,
              "summary": summary(readings),
              "judged": judged(readings, cell.limits)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"summary": result["summary"],
                      "judged": result["judged"]}))


if __name__ == "__main__":
    main()
