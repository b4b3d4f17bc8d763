"""Model FLOPs of the traced training steps (``counts.train_step_flops``:
3 x the forward, the LogicNet-FFN at its kept connections, recompute not
counted) over the seconds in which the device was busy with them, as a
share of the H100's 989 TFLOP/s bfloat16 peak.  Beside
``device_idle_pct.train`` it parts the window's rate into the device's
own efficiency and the time it waited."""


def read(run):
    t = run.trace
    if run.cell.kind != "train" or t is None or t.busy_s <= 0:
        return None
    w, c = run.window, run.counts
    flops = c.train_step_flops(run.cell.config, w["batch"],
                               w["seq_len"]) * len(t.units)
    return 100.0 * flops / t.busy_s / c.PEAK_BF16_FLOPS
