"""The LogicNet-FFN's two paths on the CPU: the route rule and the plain
versions of the fused path.

``logicnet_ffn_route`` picks the fused ``wi`` stage (the input quantizer,
then one launch for both masked products, SiLU, their product and the
quantizer) only for bfloat16 CUDA operands on the ``wgmma`` route, a
QuantReLU, SiLU, no DTensor and no gradient; it is checked here as a pure
function.  The fused path's plain versions (``quant_relu``,
``masked_matmul_swiglu_quant`` on CPU and ``meta`` tensors) must equal
the composed path bit for bit in bfloat16: the kernels repeat the
composed path's roundings, and ``tests/test_torch_cuda.py`` holds them
to it on the card.
"""

import pytest
import torch
import torch.nn.functional as F

from torch_port_util import one_torch_thread  # noqa: F401

from repro_torch._device import abstract_run
from repro_torch.core.quantize import QuantizerCfg, quantize
from repro_torch.kernels import masked_matmul as MM
from repro_torch.kernels.masked_matmul import (logicnet_ffn_route,
                                               masked_matmul_plain,
                                               masked_matmul_swiglu_quant,
                                               masked_matmul_swiglu_quant_plain,
                                               quant_relu, quant_relu_plain)
from repro_torch.models import layers as L
from repro_torch.models.config import LogicNetFFNCfg

_FUSED = dict(device_type="cuda", dtype=torch.bfloat16, k=2048, n=6144,
              bit_width=4, act_fn="silu", dtensor=False, needs_grad=False)


@pytest.mark.parametrize("change,route", [
    ({}, "fused"),
    ({"k": 2560, "n": 10240}, "fused"),
    ({"k": 1536, "n": 8960}, "fused"),
    ({"bit_width": 2}, "fused"),
    ({"needs_grad": True}, "composed"),
    ({"dtype": torch.float32}, "composed"),
    ({"dtype": torch.float16}, "composed"),
    ({"dtensor": True}, "composed"),
    ({"act_fn": "gelu"}, "composed"),
    ({"device_type": "cpu"}, "composed"),
    ({"device_type": "meta"}, "composed"),
    ({"bit_width": 1}, "composed"),
    ({"k": 2044}, "composed"),
    ({"n": 6140}, "composed"),
])
def test_logicnet_ffn_route(change, route):
    args = {**_FUSED, **change}
    kw = {k: args.pop(k) for k in ("dtensor", "needs_grad")}
    assert logicnet_ffn_route(*args.values(), **kw) == route


def _ffn(seed, d_model=64, d_ff=192, dtype=torch.bfloat16, scale=1.0):
    """A LogicNet-FFN's parameters (fan-in-16 masks) and an input of 37
    rows whose hidden activations spread over the quantizer's range."""
    gen = torch.Generator().manual_seed(seed)
    masks = L.logicnet_masks(d_model, d_ff, LogicNetFFNCfg())
    p = L.logicnet_ffn_init(gen, d_model, d_ff, masks, dtype)
    for key in ("wi_gate", "wi_up"):
        p[key] = (torch.randn(p[key].shape, generator=gen) * 0.5).to(dtype)
    x = (torch.randn((37, d_model), generator=gen) * scale).to(dtype)
    return p, x


def _hq_composed(p, x, q):
    xq = quantize(q, x.float()).value.to(x.dtype)
    h = (F.silu(masked_matmul_plain(xq, p["wi_gate"], p["mask_in"]))
         * masked_matmul_plain(xq, p["wi_up"], p["mask_in"]))
    return quantize(q, h.float()).value.to(x.dtype)


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("seed,scale", [(0, 0.5), (1, 1.0), (2, 2.0)])
@pytest.mark.parametrize("bw,max_val", [(4, 4.0), (2, 1.0)])
def test_plain_fused_equals_composed_bit_for_bit(seed, scale, bw, max_val):
    p, x = _ffn(seed, scale=scale)
    q = QuantizerCfg(bw, max_val)
    want = _hq_composed(p, x, q)
    got = masked_matmul_swiglu_quant(quant_relu(x, q), p["wi_gate"],
                                     p["wi_up"], p["mask_in"], q)
    assert got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(want))
    # the levels are spread: not all clipped, not all zero
    levels = torch.unique(torch.round(want.float() / q.step))
    assert len(levels) >= min(q.n_levels, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_branch_of_the_ffn_equals_composed(seed, monkeypatch):
    """The FFN's fused branch, forced on CPU tensors (its wrappers then
    run their plain versions), gives the composed branch's output bit for
    bit, and ``logicnet_ffn_apply.paths`` counts each branch."""
    p, x = _ffn(seed, scale=1.0 + seed)
    cfg = LogicNetFFNCfg()
    before = dict(L.logicnet_ffn_apply.paths)
    want = L.logicnet_ffn_apply(p, x[None], cfg)
    assert L.logicnet_ffn_apply.paths["composed"] == before["composed"] + 1
    monkeypatch.setattr(L, "logicnet_ffn_route", lambda *a, **k: "fused")
    got = L.logicnet_ffn_apply(p, x[None], cfg)
    assert L.logicnet_ffn_apply.paths["fused"] == before["fused"] + 1
    assert got.shape == want.shape == (1, 37, 64)
    assert torch.equal(_bits(got), _bits(want))


def test_cpu_ffn_takes_the_composed_path_with_and_without_grad():
    p, x = _ffn(3)
    before = dict(L.logicnet_ffn_apply.paths)
    launches = (MM.quant_relu.launches,
                MM.masked_matmul_swiglu_quant.launches)
    with torch.no_grad():
        L.logicnet_ffn_apply(p, x, LogicNetFFNCfg())
    L.logicnet_ffn_apply(p, x.requires_grad_(), LogicNetFFNCfg())
    assert L.logicnet_ffn_apply.paths == {
        "fused": before["fused"], "composed": before["composed"] + 2}
    assert (MM.quant_relu.launches,
            MM.masked_matmul_swiglu_quant.launches) == launches
    assert MM.masked_matmul_swiglu_quant.launches_by_route == {
        "wgmma": MM.masked_matmul_swiglu_quant.launches}


def test_meta_tensors_give_shapes_inside_abstract_run():
    q = QuantizerCfg(4, 4.0)
    x = torch.empty((5, 64), dtype=torch.bfloat16, device="meta")
    w = torch.empty((64, 192), dtype=torch.bfloat16, device="meta")
    with abstract_run():
        xq = quant_relu(x, q)
        hq = masked_matmul_swiglu_quant(xq, w, w, w, q)
    assert (xq.shape, xq.dtype, xq.device.type) == (
        (5, 64), torch.bfloat16, "meta")
    assert (hq.shape, hq.dtype, hq.device.type) == (
        (5, 192), torch.bfloat16, "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        quant_relu(x, q)


def test_quantizer_edges_match_quantize():
    """``quant_relu_plain`` is ``quantize``'s forward value: -0 becomes
    +0 (the STE's ``q + (x - x)``) and values past the bounds clip, as
    the kernels' clip and ``+ 0.0f`` do."""
    q = QuantizerCfg(4, 4.0)
    step = float(torch.tensor(q.step, dtype=torch.float32))
    vals = [-0.0, 0.0, -1.0, 5.0, float("inf"), float("-inf"), 4.0,
            *(step * (k + 0.5) for k in range(15))]
    x = torch.tensor(vals, dtype=torch.float32)
    got = quant_relu_plain(x, q)
    assert torch.equal(got, quantize(q, x).value)
    assert not bool(torch.signbit(got).any())
    assert float(got[4]) == 4.0 and float(got[5]) == 0.0


def test_plain_keeps_bfloat16_roundings_of_the_composed_path():
    """SiLU and the product round to bfloat16 in the composed path: the
    plain version equals it, and a float32 SwiGLU (one rounding) does not
    on every seed (the roundings are part of the function)."""
    q = QuantizerCfg(4, 4.0)
    differs = 0
    for seed in range(4):
        p, x = _ffn(10 + seed, d_model=128, d_ff=512, scale=1.5)
        xq = quant_relu_plain(x, q)
        gate = masked_matmul_plain(xq, p["wi_gate"], p["mask_in"])
        up = masked_matmul_plain(xq, p["wi_up"], p["mask_in"])
        once = quant_relu_plain(
            (F.silu(gate.float()) * up.float()), q).to(torch.bfloat16)
        got = masked_matmul_swiglu_quant_plain(xq, p["wi_gate"], p["wi_up"],
                                               p["mask_in"], q)
        assert torch.equal(_bits(got), _bits(_hq_composed(p, x, q)))
        differs += int((once != got).sum())
    assert differs > 0
