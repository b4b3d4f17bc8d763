"""Model FLOPs of the traced prefill calls (``counts.prefill_flops``: the
forward, the LM head at the last position) over the seconds in which the
device was busy with them, as a share of the H100's 989 TFLOP/s bfloat16
peak.  Beside ``device_idle_pct.prefill`` it parts the window's rate into
the device's own efficiency and the time it waited."""


def read(run):
    t = run.trace
    if run.cell.kind != "prefill" or t is None or t.busy_s <= 0:
        return None
    c, tokens = run.counts, run.cell.traffic["tokens_per_call"]
    flops = sum(c.prefill_flops(run.cell.config, tokens // u["key"],
                                u["key"]) for u in t.units)
    return 100.0 * flops / t.busy_s / c.PEAK_BF16_FLOPS
