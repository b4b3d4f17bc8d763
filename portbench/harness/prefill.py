"""A prefill cell: a closed loop of one caller, each call
``launch.steps.make_prefill_step`` (the last position's logits) over one
batch of prompts of one length, the greedy token of each sequence taken
as served.  The program's prefill writes no KV cache and takes one length
a call, so a batch is ``tokens_per_call // length`` rows of that length.

Each call's prompt length comes from the seed's order of the traffic's
block of lengths (``gen.length_block``: every block of calls holds each
once).  Set-up warms up one call of each length.  A call's latency runs
from the call to its completion (a synchronise); a call that raises or
returns logits that are not finite has failed and counts as infinitely
late.  After the window a sample of the finished calls,
``check_per_length`` of each length drawn from the seed (the longest
among them), is run through the reference and each served token's gap
read.
"""

from __future__ import annotations

import gc
import math
import random
import time

import torch

from portbench.harness import check, gen, port
from portbench.harness.log import note
from portbench.harness.trace import no_phases, traced
from portbench.reference.model import exact_matmuls, last_logits


def p95(values: list[float]) -> float:
    """The 95th percentile, nearest rank: the smallest value with at least
    95 % of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def latency_table(calls: list[dict]) -> dict:
    out = {}
    for length in sorted({c["length"] for c in calls}):
        ms = sorted(1e3 * c["latency"] for c in calls
                    if c["length"] == length)
        out[length] = (len(ms), round(ms[len(ms) // 2], 3),
                       round(p95(ms), 3), round(ms[-1], 3))
    return out


def sample(calls: list[dict], per_length: int, seed: int) -> list[int]:
    """Indices of the finished calls the check runs: ``per_length`` of
    each length (all of them where fewer finished), drawn from the
    seed."""
    rng = random.Random(gen.subseed(seed, "sample"))
    out = []
    for length in sorted({c["length"] for c in calls}):
        idx = [i for i, c in enumerate(calls) if c["length"] == length]
        out += rng.sample(idx, min(per_length, len(idx)))
    return sorted(out)


def token_gap(cfg: dict, params: dict, calls: list[dict],
              served=None) -> float:
    """The widest gap over the calls' sequences between the reference's
    best last-position logit and its logit of the served token (with
    ``served``, a function of a call's tokens, the token it picks
    instead: the control's)."""
    worst = 0.0
    with exact_matmuls():
        for c in calls:
            if c["served"] is None:
                return math.inf
            ref = last_logits(params, cfg, c["tokens"])
            tok = c["served"] if served is None else served(c["tokens"])
            if tok.shape != ref.shape[:1]:
                return math.inf
            gap = ref.max(dim=-1).values - ref.gather(
                1, tok.long()[:, None]).squeeze(1)
            worst = max(worst, float(gap.max()))
    return worst


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    cfg, tr = cell.config, cell.traffic
    mcfg = port.model_cfg(cfg)
    model = port.serving_model(mcfg, gen.make_params(cfg, seed, device))
    prefill = port.prefill_step(mcfg)
    block = gen.length_block(tr["lengths"])
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)

    def call(tokens: torch.Tensor, phase) -> dict:
        with phase("call"):
            t0 = time.perf_counter()
            try:
                logits = prefill(model, {"tokens": tokens})
                served = logits.argmax(dim=-1)
                finite = torch.isfinite(logits).all()
                sync()
            except RuntimeError:
                return {"served": None, "finite": False,
                        "latency": math.inf}
            return {"served": served, "finite": finite,
                    "latency": time.perf_counter() - t0}

    warm = gen.Prompts(seed, "warmup", tr["tokens_per_call"], cfg["vocab"],
                       device)
    for length in sorted(set(block)):
        call(warm.next(length), no_phases)
    note(f"prefill shapes warmed up: lengths {sorted(set(block))}")
    order = gen.prompt_lengths(seed, block)
    prompts = gen.Prompts(seed, "prompts", tr["tokens_per_call"],
                          cfg["vocab"], device)

    def unit(phase) -> dict:
        length = next(order)
        with phase("batch"):
            tokens = prompts.next(length)
        out = call(tokens, phase)
        out.update(length=length, tokens=tokens)
        return out

    sync()
    setup_s = time.perf_counter() - t_start
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    calls = []
    t0 = time.perf_counter()
    while True:
        calls.append(unit(no_phases))
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    for c in calls:
        if c["served"] is not None and not bool(c["finite"]):
            c["served"], c["latency"] = None, math.inf
    failed = sum(c["served"] is None for c in calls)
    n_tokens = sum(c["tokens"].numel() for c in calls)
    result = {
        "attempted": len(calls), "failed": failed,
        "metrics": {"prefill_tokens_per_s": n_tokens / window_s,
                    "prefill_p95_ms": 1e3 * p95([c["latency"]
                                                 for c in calls]),
                    "setup_s": setup_s},
        "window": {"seconds": window_s, "calls": len(calls)},
        "peak_bytes": peak, "trace": None}
    note(f"window: {len(calls)} calls in {window_s:.3f} s; ms a call by "
         f"length (n, median, p95, max): {latency_table(calls)}")
    if trace:
        result["trace"] = traced(lambda phase: unit(phase)["length"],
                                 tr["trace_calls"])
        note(f"trace read ({result['trace'].tries} tries); device s a unit "
             f"by kind: {result['trace'].by_kind()}")
    picked = [calls[i] for i in sample(calls, int(tr["check_per_length"]),
                                       seed)]
    for c in picked:
        c["served"] = None if c["served"] is None else c["served"].cpu()
        c["tokens"] = c["tokens"].cpu()
    del model, prefill, calls, unit, call
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    params = gen.make_params(cfg, seed, device)
    for c in picked:
        c["tokens"] = c["tokens"].to(device)
        if c["served"] is not None:
            c["served"] = c["served"].to(device)
    value = token_gap(cfg, params, picked)
    note(f"reference over {len(picked)} calls, "
         f"{sum(c['tokens'].shape[0] for c in picked)} served tokens")
    ok, result["compared"] = check.judge({"token_gap": value}, cell.limits)
    result["correct"] = ok and failed == 0
    return result
