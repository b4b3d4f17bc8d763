"""The least time of the prefill calls' causal attention
(``counts.flash_bound_s``: q, k, v and o once, or 4·head_dim·heads FLOP a
causal pair) over the traced device time of the kernels named below; %."""

KERNELS = ("flash_attention",)


def read(run):
    t = run.trace
    if run.cell.kind != "prefill" or t is None:
        return None
    spent = t.kernel_s(KERNELS)
    if spent <= 0:
        return None
    tokens = run.cell.traffic["tokens_per_call"]
    bound = sum(run.counts.flash_bound_s(run.cell.config, tokens // u["key"],
                                         u["key"]) for u in t.units)
    return 100.0 * bound / spent
