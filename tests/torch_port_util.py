"""Shared inputs for the ``test_torch_*`` files (the port vs the reference).

Every input is made with numpy from a seed and handed to both packages.
"""

import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_port")
ARTIFACT = os.path.join(FIXTURE_DIR, "model_a_l3.npz")
REF = os.path.join(FIXTURE_DIR, "model_a_ref.npz")
TRAIN = os.path.join(FIXTURE_DIR, "model_a_train.npz")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small CPU ops spend most of their time in the thread pool; one
    intra-op thread keeps the plain versions fast under test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def random_stack(widths, fan_ins, bws, seed=0, hi=None):
    """Random ``(idx, table, bw_in)`` triples; codes in ``[0, hi or 2^bw)``."""
    rng = np.random.default_rng(seed)
    layers = []
    for (n_in, n_out), fi, bw in zip(zip(widths[:-1], widths[1:]),
                                     fan_ins, bws):
        fi = min(fi, n_in)
        idx = np.stack([np.sort(rng.choice(n_in, fi, replace=False))
                        for _ in range(n_out)]).astype(np.int32)
        tab = rng.integers(0, hi or 2 ** bw, (n_out, 2 ** (fi * bw)),
                           dtype=np.int32)
        layers.append((idx, tab, bw))
    return layers


def het_fan_in_stack(widths, bws, fan_in_choices, seed=0):
    """A reference ``CNet`` whose neurons have different fan-ins, so its
    mixed lowering has width-0 padding elements and ragged entry counts."""
    from repro import compile as C

    rng = np.random.default_rng(seed)
    layers = []
    for li, ((n_in, n_out), bw) in enumerate(zip(zip(widths[:-1],
                                                     widths[1:]), bws)):
        bw_out = bws[li + 1] if li + 1 < len(bws) else bw
        neurons = []
        for _ in range(n_out):
            fi = min(int(rng.choice(fan_in_choices)), n_in)
            idx = np.sort(rng.choice(n_in, fi, replace=False)).astype(
                np.int32)
            tab = rng.integers(0, 2 ** bw_out, 2 ** (fi * bw),
                               dtype=np.int32)
            neurons.append(C.CNeuron(idx, tab))
        layers.append(C.CLayer(neurons, bw, bw_out))
    net = C.CNet(widths[0], layers)
    net.validate()
    return net


def codes(n_in, batch, hi=4, seed=0):
    return np.random.default_rng(seed).integers(0, hi, (batch, n_in),
                                                dtype=np.int32)


def t(a):
    """numpy -> CPU torch tensor (contiguous copy)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def load_ref():
    with np.load(REF) as z:
        return {k: z[k] for k in z.files}


def ref_triples(ref):
    return [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
            for i in range(len(ref["bws"]))]


def load_train():
    with np.load(TRAIN) as z:
        return {k: z[k] for k in z.files}
