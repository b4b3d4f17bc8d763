"""The port's LUT kernels against the reference's Pallas kernels.

Each Hopper kernel of ``repro_torch.kernels`` has a plain-torch version
that its wrapper runs on CPU tensors; here those run beside the
reference's Pallas kernels in interpret mode (as ``repro.kernels.ops``
runs them on the CPU), on the same seeded numpy inputs.  Every path is
integer, so the tolerance is 0: outputs and slab arrays must match bit for
bit.  Covered: random stacks, int8-packed boundary codes 0/255, width-0
padding elements, row-dedup offsets, ``out_perm``, padded uniform slabs,
out-of-range entries (0 in both), batch 0 and ragged batches.  The CUDA
kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (codes, het_fan_in_stack, one_torch_thread,  # noqa: F401
                             random_stack, t)

from repro import compile as C
from repro.kernels import lut_network as J
from repro.kernels.lut_lookup import lut_lookup_pallas
from repro.kernels.ref import lut_lookup_ref as jax_lookup_ref
from repro_torch.kernels import lut_network as P
from repro_torch.kernels.lut_lookup import lut_lookup
from repro_torch.kernels.ref import lut_lookup_ref


def _np(x):
    return np.asarray(x)


def _same_mixed_slabs(port, ref):
    for name in ("idx_slab", "shift_slab", "width_slab", "table_slab"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      _np(getattr(ref, name)))
        assert getattr(port, name).numpy().dtype == _np(
            getattr(ref, name)).dtype
    assert port.meta == ref.meta
    assert port.out_perm == ref.out_perm
    assert port.packed == ref.packed
    assert port.dedup_entries_saved == ref.dedup_entries_saved


def _mixed_both(mixed, x, block_b=8, **build):
    """(port output, Pallas output, port slabs, reference slabs)."""
    ps = P.build_mixed_network_slabs(mixed, device="cpu", **build)
    js = J.build_mixed_network_slabs(mixed, **build)
    got = P.lut_network_mixed(t(x), ps).numpy()
    want = _np(J.lut_network_mixed_pallas(jnp.asarray(x), js,
                                          block_b=block_b, interpret=True))
    return got, want, ps, js


@pytest.mark.parametrize("n_in,n_out,fan_in,bw,batch,seed", [
    (12, 20, 3, 2, 17, 0),
    (16, 64, 3, 3, 9, 1),
    (6, 5, 1, 4, 1, 2),
])
def test_lut_lookup_matches_pallas(n_in, n_out, fan_in, bw, batch, seed):
    """Per-layer kernel's plain version == lut_lookup_pallas == both refs."""
    (idx, tab, _), = random_stack((n_in, n_out), (fan_in,), (bw,), seed=seed)
    x = codes(n_in, batch, hi=2 ** bw, seed=seed + 10)
    got = lut_lookup(t(x), t(idx), t(tab), bw)
    assert got.dtype == torch.int32 and got.shape == (batch, n_out)
    want = _np(lut_lookup_pallas(jnp.asarray(x), jnp.asarray(idx),
                                 jnp.asarray(tab), bw, block_b=8,
                                 interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        lut_lookup_ref(t(x), t(idx), t(tab), bw).numpy(),
        _np(jax_lookup_ref(jnp.asarray(x), jnp.asarray(idx),
                           jnp.asarray(tab), bw)))
    np.testing.assert_array_equal(lut_lookup_ref(t(x), t(idx), t(tab),
                                                 bw).numpy(), want)


def test_out_of_range_entries_give_zero():
    """Codes wider than bw_in push entries past the table: the Pallas
    kernels' one-hot gathers give 0 there (per-layer and uniform), and so
    do the port's."""
    layers = random_stack((8, 10, 6), (2, 2), (2, 2), seed=3, hi=3)
    x = codes(8, 13, hi=16, seed=4)            # codes up to 15 at bw_in=2
    idx, tab, bw = layers[0]
    got = lut_lookup(t(x), t(idx), t(tab), bw).numpy()
    want = _np(lut_lookup_pallas(jnp.asarray(x), jnp.asarray(idx),
                                 jnp.asarray(tab), bw, block_b=8,
                                 interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any()
    # uniform tables hold codes 1..3 only, so a 0 out of the first layer can
    # only be an out-of-range entry
    nz = [(i, tb + 1, b) for i, tb, b in layers]
    ps = P.build_network_slabs(nz, device="cpu")
    js = J.build_network_slabs(nz)
    got = P.lut_network(t(x), ps).numpy()
    want = _np(J.lut_network_pallas(jnp.asarray(x), js, block_b=8,
                                    interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pack", [None, False])
@pytest.mark.parametrize("widths,fan_ins,bws", [
    ((12, 20, 16, 8), (3, 3, 3), (2, 2, 2)),
    # fan-in and entry count differ by layer: every layer but the widest
    # reads a padded [:n_out, :fan_in] / [:n_out, :n_entries] slice
    ((10, 12, 9, 7), (2, 3, 1), (2, 2, 3)),
])
def test_uniform_matches_pallas(widths, fan_ins, bws, pack):
    layers = random_stack(widths, fan_ins, bws, seed=5)
    ps = P.build_network_slabs(layers, pack=pack, device="cpu")
    js = J.build_network_slabs(layers, pack=pack)
    np.testing.assert_array_equal(ps.idx_slab.numpy(), _np(js.idx_slab))
    np.testing.assert_array_equal(ps.table_slab.numpy(), _np(js.table_slab))
    assert ps.meta == js.meta and ps.packed == js.packed
    assert ps.slab_breakdown() == js.vmem_breakdown()
    assert (P.estimate_slab_bytes(layers, pack)
            == J.estimate_slab_bytes(layers, pack))
    x = codes(widths[0], 21, seed=6)
    got = P.lut_network(t(x), ps).numpy()
    want = _np(J.lut_network_pallas(jnp.asarray(x), js, block_b=8,
                                    interpret=True))
    np.testing.assert_array_equal(got, want)


def test_mixed_heterogeneous_fan_ins_width0_padding_and_out_perm():
    """Ragged fan-ins give width-0 padding elements; the final layer's
    group sort gives a non-trivial out_perm."""
    net = het_fan_in_stack((10, 16, 12, 8), (2, 2, 2), (1, 2, 3), seed=3)
    mixed = net.to_mixed_tables()
    x = codes(10, 23, seed=0)
    got, want, ps, js = _mixed_both(mixed, x)
    _same_mixed_slabs(ps, js)
    assert (ps.width_slab == 0).any()
    assert ps.out_perm is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, C.forward_codes(net, x))
    assert (P.estimate_mixed_slab_bytes(mixed)
            == J.estimate_mixed_slab_bytes(mixed))


@pytest.mark.parametrize("pack", [True, False])
def test_mixed_packed_boundary_codes(pack):
    """Codes 0 and 255 survive the uint8 view and the unsigned widening."""
    layers = random_stack((8, 10, 6), (2, 2), (2, 2), seed=9)
    idx, tab, bw = layers[-1]
    layers[-1] = (idx, (tab % 2) * 255, bw)
    net = C.CNet.from_tables(C.tables_from_triples(layers), in_features=8)
    x = codes(8, 19, seed=2)
    got, want, ps, js = _mixed_both(net.to_mixed_tables(), x, pack=pack)
    _same_mixed_slabs(ps, js)
    assert set(np.unique(want)) == {0, 255}
    np.testing.assert_array_equal(got, want)


def test_mixed_dedup_offsets():
    """Row dedup stores identical tables once; every group then carries
    per-neuron offsets (all or nothing), read by the port as by Pallas."""
    layers = random_stack((8, 12, 6), (2, 2), (2, 2), seed=6)
    for li, (idx, tab, bw) in enumerate(layers):
        tab = tab.copy()
        tab[1::2] = tab[0]
        layers[li] = (idx, tab, bw)
    net = C.CNet.from_tables(C.tables_from_triples(layers), in_features=8)
    mixed = net.to_mixed_tables()
    x = codes(8, 17, seed=1)
    got, want, ps, js = _mixed_both(mixed, x)
    _same_mixed_slabs(ps, js)
    assert ps.dedup_entries_saved > 0
    assert all(g.offs is not None for m in ps.meta for g in m.groups)
    np.testing.assert_array_equal(got, want)
    got_plain, want_plain, *_ = _mixed_both(mixed, x, dedup=False)
    np.testing.assert_array_equal(got_plain, want_plain)
    np.testing.assert_array_equal(got, got_plain)


def test_mixed_random_compiled_stack():
    """A random stack through the reference compiler's level-3 lowering."""
    layers = random_stack((12, 20, 16, 8), (3, 3, 3), (2, 2, 2), seed=13)
    res = C.optimize(C.tables_from_triples(layers), 3, in_features=12)
    x = codes(12, 27, seed=1)
    got, want, ps, js = _mixed_both(res.mixed_tables, x)
    _same_mixed_slabs(ps, js)
    np.testing.assert_array_equal(got, want)


def test_batch_zero_and_ragged_batches():
    layers = random_stack((8, 10, 6), (2, 2), (2, 2), seed=2)
    net = het_fan_in_stack((6, 8, 5), (2, 2), (1, 2), seed=1)
    ms = P.build_mixed_network_slabs(net.to_mixed_tables(), device="cpu")
    us = P.build_network_slabs(layers, device="cpu")
    idx, tab, bw = layers[0]
    for fn, n_in, n_out in (
            (lambda c: P.lut_network_mixed(c, ms), 6, 5),
            (lambda c: P.lut_network(c, us), 8, 6),
            (lambda c: lut_lookup(c, t(idx), t(tab), bw), 8, 10)):
        empty = fn(torch.zeros((0, n_in), dtype=torch.int32))
        assert empty.shape == (0, n_out) and empty.dtype == torch.int32
    x = codes(6, 13, seed=8)                     # 13 % block_b != 0
    js = J.build_mixed_network_slabs(net.to_mixed_tables())
    np.testing.assert_array_equal(
        P.lut_network_mixed(t(x), ms).numpy(),
        _np(J.lut_network_mixed_pallas(jnp.asarray(x), js, block_b=8,
                                       interpret=True)))


def test_slabs_reject_reads_outside_them():
    """Slab metadata comes from artifact files: anything that would send a
    kernel read outside the slabs is refused when the slabs are built."""
    net = het_fan_in_stack((6, 8, 5), (2, 2), (1, 2), seed=1)
    ms = P.build_mixed_network_slabs(net.to_mixed_tables(), device="cpu")
    fields = dict(idx_slab=ms.idx_slab, shift_slab=ms.shift_slab,
                  width_slab=ms.width_slab, table_slab=ms.table_slab,
                  meta=ms.meta, out_perm=ms.out_perm, packed=ms.packed)
    last = ms.meta[-1]
    g = last.groups[-1]
    bad_group = g._replace(offs=(ms.table_slab.numel(),) * g.n_out)
    bad_meta = ms.meta[:-1] + (last._replace(
        groups=last.groups[:-1] + (bad_group,)),)
    with pytest.raises(ValueError, match="outside"):
        P.MixedNetworkSlabs(**{**fields, "meta": bad_meta})
    with pytest.raises(ValueError, match="permutation"):
        P.MixedNetworkSlabs(**{**fields, "out_perm": (0,) * last.n_out})
    with pytest.raises(ValueError, match="int32"):
        P.MixedNetworkSlabs(**{**fields,
                               "idx_slab": ms.idx_slab.to(torch.int64)})
    us = P.build_network_slabs(random_stack((8, 6), (2,), (2,)),
                               device="cpu")
    m = us.meta[0]
    with pytest.raises(ValueError, match="does not fit"):
        P.NetworkSlabs(us.idx_slab, us.table_slab,
                       (m._replace(n_entries=m.n_entries * 2),), us.packed)


def test_pack_true_wide_codes_raise():
    layers = random_stack((6, 6), (2,), (2,), seed=4)
    idx, tab, bw = layers[0]
    layers[0] = (idx, tab + 300, bw)
    with pytest.raises(ValueError, match="pack=True"):
        P.build_network_slabs(layers, pack=True, device="cpu")
    assert not P.build_network_slabs(layers, device="cpu").packed
