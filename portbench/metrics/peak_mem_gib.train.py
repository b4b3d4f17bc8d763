"""``torch.cuda.max_memory_allocated()`` over the measured window, GiB."""


def read(run):
    if run.cell.kind != "train" or not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
