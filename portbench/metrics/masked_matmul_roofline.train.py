"""The least time of a training step's logical masked products (forward
and input gradient, 3 each an FFN, ``counts.masked_matmul_bound_s``) over
the traced device time of the kernels named below, the remat's second
forward included; %."""

KERNELS = ("masked_matmul",)


def read(run):
    t = run.trace
    if run.cell.kind != "train" or t is None:
        return None
    spent = t.kernel_s(KERNELS)
    if spent <= 0:
        return None
    rows = run.window["batch"] * run.window["seq_len"]
    bound = run.counts.masked_matmul_bound_s(run.cell.config, rows,
                                             backward=True)
    return 100.0 * bound * len(t.units) / spent
