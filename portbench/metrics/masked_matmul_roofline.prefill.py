"""The least time of the traced prefill calls' masked products (3 an FFN,
forward only, ``counts.masked_matmul_bound_s`` at each call's rows times
its length) over the traced device time of the kernels named below; %."""

KERNELS = ("masked_matmul",)


def read(run):
    t = run.trace
    if run.cell.kind != "prefill" or t is None:
        return None
    spent = t.kernel_s(KERNELS)
    if spent <= 0:
        return None
    tokens = run.cell.traffic["tokens_per_call"]
    bound = sum(run.counts.masked_matmul_bound_s(
        run.cell.config, tokens // u["key"] * u["key"], backward=False)
        for u in t.units)
    return 100.0 * bound / spent
