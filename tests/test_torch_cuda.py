"""The port's CUDA kernels on the card: ``PYTHONPATH=src python -m pytest
-m cuda tests/test_torch_cuda.py`` (torch and numpy only, so it runs where
JAX is not installed).  Without a CUDA device every test here skips.

Each kernel must be bit-exact (tolerance 0: integer codes) with its plain
version on the same CUDA tensors, count one launch per call, and refuse
tensors it cannot take.
"""

import numpy as np
import pytest
import torch

from torch_port_util import ARTIFACT, codes, load_ref, random_stack

from repro_torch import engine
from repro_torch.kernels import lut_network as P
from repro_torch.kernels.lut_lookup import lut_lookup, lut_lookup_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _check(wrapper, kernel, plain, x):
    before = wrapper.launches
    got = kernel(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (1 if x.shape[0] else 0)
    assert got.dtype == torch.int32 and got.device == x.device
    assert torch.equal(got, plain(x))
    return got


@pytest.mark.parametrize("batch", [1, 33, 1000])
def test_kernels_match_plain_versions(dev, batch):
    ms = engine.load(ARTIFACT, device=dev).slabs
    layers = random_stack((10, 12, 9, 7), (2, 3, 1), (2, 2, 3), seed=5)
    us = P.build_network_slabs(layers, device=dev)
    wide = random_stack((12, 20), (3,), (2,), seed=1, hi=1000)
    idx, tab = _on(dev, *wide[0][:2])
    bw = wide[0][2]
    x16 = _on(dev, codes(16, batch, hi=8, seed=batch))[0]
    x10 = _on(dev, codes(10, batch, hi=4, seed=batch))[0]
    x12 = _on(dev, codes(12, batch, hi=8, seed=batch))[0]   # some entries
    _check(P.lut_network_mixed, lambda c: P.lut_network_mixed(c, ms),
           lambda c: P.lut_network_mixed_plain(c, ms), x16)
    _check(P.lut_network, lambda c: P.lut_network(c, us),
           lambda c: P.lut_network_plain(c, us), x10)
    out = _check(lut_lookup, lambda c: lut_lookup(c, idx, tab, bw),
                 lambda c: lut_lookup_plain(c, idx, tab, bw), x12)
    assert int(out.max()) >= 256          # int32 tables, wide codes


def test_model_a_matches_reference_outputs(dev):
    ref = load_ref()
    x = _on(dev, ref["codes"])[0]
    net = engine.load(ARTIFACT, device=dev)
    assert torch.equal(net(x).cpu(), torch.from_numpy(ref["out_mixed"]))
    triples = [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
               for i in range(3)]
    for kw, name in (({}, "uniform"), ({"fused": False}, "per_layer")):
        net = engine.compile_network(triples, block_b=16, device=dev, **kw)
        assert net.layout == name
        assert torch.equal(net(x).cpu(),
                           torch.from_numpy(ref[f"out_{name}"]))


def test_batch_zero_launches_nothing(dev):
    ms = engine.load(ARTIFACT, device=dev).slabs
    before = P.lut_network_mixed.launches
    out = P.lut_network_mixed(torch.zeros((0, 16), dtype=torch.int32,
                                          device=dev), ms)
    assert out.shape == (0, 64) and P.lut_network_mixed.launches == before


def test_wrappers_refuse_what_the_kernels_cannot_take(dev):
    idx, tab, bw = random_stack((8, 6), (2,), (2,))[0]
    idx_d, tab_d = _on(dev, idx, tab)
    x = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        lut_lookup(x.long(), idx_d, tab_d, bw)
    with pytest.raises(ValueError, match="contiguous"):
        lut_lookup(torch.zeros((8, 4), dtype=torch.int32, device=dev).T,
                   idx_d, tab_d, bw)
    with pytest.raises(ValueError, match="expected"):
        lut_lookup(x, idx_d.cpu(), tab_d, bw)
    us = P.build_network_slabs([(idx, tab, bw)], device="cpu")
    with pytest.raises(ValueError, match="slabs on"):
        P.lut_network(x, us)
