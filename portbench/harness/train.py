"""A training cell: ``launch.steps.make_train_step`` with AdamW, steps
back to back on one state.

Set-up fills the program's train state from the seed and drives it
through ``check_steps`` steps on the window's own call and feed (they
also warm up every kernel and shape): their losses, the first gradient as
AdamW takes it (read from the first moment after step 1) and each leaf's
change after the last of them are the program's readings.  The window
then runs steps until ``--seconds`` have passed and ends when the last
completes.  After it, the program's state is freed and the reference
follows the same check steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench.harness import check, gen, port
from portbench.harness.log import note
from portbench.harness.trace import no_phases, traced
from portbench.reference.train import change_norms, follow, leaf_norms


def hyper(traffic: dict) -> dict:
    return {k: traffic[k] for k in ("lr", "b1", "b2", "eps", "weight_decay",
                                    "clip_norm")}


def program_readings(state: dict, step, batches, n: int, b1: float,
                     initial) -> dict:
    """Run the ``n`` check steps and read the program's numbers."""
    out = {"losses": []}
    for i in range(n):
        state, loss = step(state, batches.next())
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = {k: x / (1.0 - b1) for k, x in
                            leaf_norms(state["opt"]["m"]).items()}
    out["changes"] = change_norms(state["params"], initial())
    return out


def setup(cell, seed: int, device):
    """The program's train state from the seed, driven through the check
    steps: ``(state, step, batches, readings)``."""
    cfg, tr = cell.config, cell.traffic
    mcfg = port.model_cfg(cfg)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    params = gen.make_params(cfg, seed, device)
    sync()
    note("weights drawn")
    state = port.train_state(mcfg, params)
    del params
    step = port.train_step(mcfg, tr)
    sync()
    batches = gen.TrainBatches(seed, tr["batch"], tr["seq_len"],
                               cfg["vocab"], device)
    note("train state filled")
    readings = program_readings(
        state, step, batches, tr["check_steps"], tr["b1"],
        lambda: gen.make_params(cfg, seed, device))
    note(f"check steps: losses {readings['losses']}")
    return state, step, batches, readings


def reference(cell, seed: int, batches, device, prec: str = "f32") -> dict:
    """The reference's readings over the run's first batches."""
    cfg, tr = cell.config, cell.traffic
    return follow(cfg, gen.make_params(cfg, seed, device),
                  batches.first(tr["check_steps"]), hyper(tr),
                  lambda: gen.make_params(cfg, seed, device), prec)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    tr = cell.traffic
    state, step, batches, readings = setup(cell, seed, device)
    tokens = tr["batch"] * tr["seq_len"]

    def unit(phase):
        with phase("batch"):
            batch = batches.next()
        with phase("step"):
            _, loss = step(state, batch)
        return tokens, loss

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(unit(no_phases)[1])
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    failed = sum(not math.isfinite(float(x)) for x in losses)
    result = {
        "attempted": len(losses), "failed": failed,
        "metrics": {"train_tokens_per_s": len(losses) * tokens / window_s,
                    "setup_s": setup_s},
        "window": {"seconds": window_s, "steps": len(losses),
                   "tokens_per_step": tokens, "batch": tr["batch"],
                   "seq_len": tr["seq_len"]},
        "peak_bytes": peak, "trace": None}
    note(f"window: {len(losses)} steps in {window_s:.3f} s")
    if trace:
        result["trace"] = traced(lambda phase: unit(phase)[0],
                                 tr["trace_steps"])
        note(f"trace read ({result['trace'].tries} tries); device s a unit "
             f"by kind: {result['trace'].by_kind()}")
    del state, step, losses, unit
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    ref = reference(cell, seed, batches, device)
    note(f"reference: losses {ref['losses']}")
    result["correct"], result["compared"] = check.judge(
        check.train_numbers(readings, ref), cell.limits)
    return result
