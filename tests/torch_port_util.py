"""Shared inputs for the ``test_torch_*`` files (the port vs the reference).

Every input is made with numpy from a seed and handed to both packages.
"""

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_port")
ARTIFACT = os.path.join(FIXTURE_DIR, "model_a_l3.npz")
REF = os.path.join(FIXTURE_DIR, "model_a_ref.npz")
TRAIN = os.path.join(FIXTURE_DIR, "model_a_train.npz")
MIXED_CASES = os.path.join(FIXTURE_DIR, "lut_mixed_cases.npz")


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


def untimed(d):
    """A compile-stats record with every ``seconds`` field dropped."""
    if isinstance(d, dict):
        return {k: untimed(v) for k, v in d.items() if k != "seconds"}
    if isinstance(d, list):
        return [untimed(v) for v in d]
    return d


def assert_same_cover(a, b):
    """Two SOP covers (either package's) equal, or both budget fallbacks."""
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.n_in, a.out_bits, a.bits) == (b.n_in, b.out_bits, b.bits)
    assert (a.n_terms, a.n_literals) == (b.n_terms, b.n_literals)
    np.testing.assert_array_equal(a.table(), b.table())


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


class MixedTables(NamedTuple):
    """A mixed-width layer as the reference compiler lowers it (the fields
    ``build_mixed_network_slabs`` reads), held in numpy alone."""

    indices: np.ndarray
    shifts: np.ndarray
    elem_widths: np.ndarray
    entry_bits: np.ndarray
    tables: tuple


def mixed_cases():
    """The reference compiler's mixed lowering of the LUT edge cases of
    ``test_torch_kernels.py``: {name: (n_in, [layer tables])}."""
    from repro import compile as C

    def from_triples(layers, n_in):
        net = C.CNet.from_tables(C.tables_from_triples(layers),
                                 in_features=n_in)
        return net.to_mixed_tables()

    boundary = random_stack((8, 10, 6), (2, 2), (2, 2), seed=9)
    idx, tab, bw = boundary[-1]
    boundary[-1] = (idx, (tab % 2) * 255, bw)
    dedup = random_stack((8, 12, 6), (2, 2), (2, 2), seed=6)
    for li, (idx, tab, bw) in enumerate(dedup):
        tab = tab.copy()
        tab[1::2] = tab[0]
        dedup[li] = (idx, tab, bw)
    compiled = random_stack((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), seed=13)
    return {
        "het": (10, het_fan_in_stack((10, 16, 12, 8), (2, 2, 2), (1, 2, 3),
                                     seed=3).to_mixed_tables()),
        "boundary": (8, from_triples(boundary, 8)),
        "dedup": (8, from_triples(dedup, 8)),
        "compiled": (12, C.optimize(C.tables_from_triples(compiled), 3,
                                    in_features=12).mixed_tables),
    }


def mixed_case_arrays(cases) -> dict:
    """``mixed_cases()`` as flat arrays (each layer's tables end to end)."""
    out = {}
    for name, (n_in, layers) in cases.items():
        out[f"{name}.n_in"] = np.asarray(n_in, np.int32)
        for i, L in enumerate(layers):
            for f in ("indices", "shifts", "elem_widths", "entry_bits"):
                out[f"{name}.{i}.{f}"] = np.asarray(getattr(L, f), np.int32)
            out[f"{name}.{i}.tables"] = np.concatenate(
                [np.asarray(t, np.int32) for t in L.tables])
    return out


def write_mixed_cases(path=MIXED_CASES):
    """Regenerate the committed fixture (needs the reference, JAX on the
    CPU): ``JAX_PLATFORMS=cpu PYTHONPATH=src:tests python -c 'import
    torch_port_util as u; u.write_mixed_cases()'``."""
    np.savez_compressed(path, **mixed_case_arrays(mixed_cases()))


def load_mixed_cases(path=MIXED_CASES):
    """The committed fixture as {name: (n_in, [MixedTables])}, numpy only
    (the card-only tests run where JAX is not installed)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    cases = {}
    for key in arrays:
        name, rest = key.split(".", 1)
        if rest != "n_in":
            continue
        layers, i = [], 0
        while f"{name}.{i}.indices" in arrays:
            a = {f: arrays[f"{name}.{i}.{f}"] for f in
                 ("indices", "shifts", "elem_widths", "entry_bits",
                  "tables")}
            ends = np.cumsum(1 << a["entry_bits"].astype(np.int64))
            tables = tuple(np.split(a["tables"], ends[:-1]))
            layers.append(MixedTables(a["indices"], a["shifts"],
                                      a["elem_widths"], a["entry_bits"],
                                      tables))
            i += 1
        cases[name] = (int(arrays[key]), layers)
    return cases


def lower_uniform(layers):
    """Uniform ``(idx, table, bw_in)`` triples as the compiler's mixed
    lowering of them (shift ``bw_in * k``, width ``bw_in``)."""
    out = []
    for idx, tab, bw in layers:
        o, fi = idx.shape
        out.append(MixedTables(
            idx, np.tile(np.arange(fi, dtype=np.int32) * bw, (o, 1)),
            np.full((o, fi), bw, np.int32), np.full(o, fi * bw, np.int32),
            tuple(tab)))
    return out


def budget_stack(mixed: bool):
    """Layers whose fused-plan estimate is exactly the plan's budget
    (183 296 bytes): fan-in 4 of 1-bit codes, 716 neurons a layer (64
    bytes a neuron mixed, 4 layers; 32 uniform, 8 layers)."""
    n_layers = 4 if mixed else 8
    layers = random_stack((716,) * (n_layers + 1), (4,) * n_layers,
                          (1,) * n_layers, seed=2)
    return lower_uniform(layers) if mixed else layers


def with_table_offset(slabs, pad=1):
    """The same slabs with the table slab a contiguous view ``pad``
    elements into a larger buffer (an odd byte offset for int8 tables)."""
    import dataclasses

    tab = slabs.table_slab
    buf = torch.zeros(tab.numel() + pad, dtype=tab.dtype, device=tab.device)
    buf[pad:] = tab.reshape(-1)
    view = buf[pad:].reshape(tab.shape)
    assert view.data_ptr() % 16 and view.is_contiguous()
    fields = {f.name: getattr(slabs, f.name)
              for f in dataclasses.fields(slabs) if f.init}
    return type(slabs)(**{**fields, "table_slab": view})
