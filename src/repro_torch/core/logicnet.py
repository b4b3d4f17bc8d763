"""LogicNet network assembly (paper Part II): the port of
``repro.core.logicnet``.

A LogicNet is a stack of SparseLinear layers and an optional final
DenseQuantLinear (Tables 6.1 / 7.1).  :class:`LogicNet` holds them as an
``nn.Module``; the module-level functions follow the reference's flow:
``init`` -> ``forward`` / ``loss_fn`` / ``accuracy`` -> ``generate_tables``
-> ``verify_tables`` / ``sparse_head_forward`` / ``to_verilog``.

``from_reference`` and ``to_reference`` carry weights between the
reference's list of layer dicts (``{"params": {"w", "b", "bn": {"scale",
"bias"}}, "mask", "bn_state": {"mean", "var"}}``, numpy arrays) and a
:class:`LogicNet`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.core import layers as L
from repro_torch.core import table_infer
from repro_torch.core import truth_table as TT
from repro_torch.core.quantize import QuantizerCfg, codes, dequantize_code


@dataclasses.dataclass(frozen=True)
class LogicNetCfg:
    """Model family of the paper's experiments.

    hidden: neuron counts per hidden layer (HL column).
    fan_in: per-neuron synapses X (uniform across hidden layers).
    bw:     activation bit-width BW.
    final_dense: dense final layer (the usual MNIST/JSC choice); when False
                 the final layer is sparse with fan_in_fc synapses (X_fc).
    bw_fc:  output bit-width of the network (BW_fc).
    skips:  list of (src_layer, dst_layer) activation concatenations.
    """

    in_features: int
    n_classes: int
    hidden: tuple[int, ...]
    fan_in: int
    bw: int
    final_dense: bool = True
    fan_in_fc: int | None = None
    bw_fc: int = 3
    max_val: float = 2.0
    skips: tuple[tuple[int, int], ...] = ()

    def _skip_width(self, dst: int) -> int:
        return sum(self.hidden[s] if s > 0 else self.in_features
                   for s, d in self.skips if d == dst)

    def layer_cfgs(self) -> list[Any]:
        cfgs: list[Any] = []
        widths = [self.in_features, *self.hidden]
        for i, out_f in enumerate(self.hidden):
            in_f = widths[i] + self._skip_width(i)
            cfgs.append(L.SparseLinearCfg(
                in_f, out_f, min(self.fan_in, in_f), self.bw, self.max_val))
        in_f = widths[-1] + self._skip_width(len(self.hidden))
        if self.final_dense:
            cfgs.append(L.DenseQuantLinearCfg(
                in_f, self.n_classes, self.bw, self.max_val))
        else:
            cfgs.append(L.SparseLinearCfg(
                in_f, self.n_classes,
                min(self.fan_in_fc or self.fan_in, in_f), self.bw,
                self.max_val))
        return cfgs

    @property
    def out_quant(self) -> QuantizerCfg:
        return QuantizerCfg(self.bw_fc, self.max_val)

    def luts(self) -> list[int]:
        """Per-layer analytical LUT cost (LUTL1..LUTLn columns).

        Final *sparse* layers are costed at 2*BW_fc output bits (the
        signed-logit accounting of Table 6.1 models D and E).
        """
        out = []
        cfgs = self.layer_cfgs()
        for i, c in enumerate(cfgs):
            if isinstance(c, L.SparseLinearCfg):
                bw_out = (cfgs[i + 1].bw_in if i + 1 < len(cfgs)
                          else 2 * self.bw_fc)
                out.append(c.luts(bw_out))
            else:
                out.append(int(round(c.luts())))
        return out

    def total_luts(self) -> int:
        return sum(self.luts())


class LogicNet(nn.Module):
    """The layers of a :class:`LogicNetCfg`; ``forward(x) -> logits``.

    In training mode every BatchNorm updates its running statistics in
    place.  Layer i's mask is the a-priori mask of ``mask_seed + i``; its
    weights come from ``generator`` (zeros without one).
    """

    def __init__(self, cfg: LogicNetCfg,
                 generator: torch.Generator | None = None,
                 mask_seed: int = 0):
        super().__init__()
        self.cfg = cfg
        layers = []
        for i, c in enumerate(cfg.layer_cfgs()):
            if isinstance(c, L.SparseLinearCfg):
                layers.append(L.SparseLinear(c, generator, mask_seed + i))
            else:
                layers.append(L.DenseQuantLinear(c, generator))
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.layers[0].w.device

    @contextlib.contextmanager
    def mode(self, train: bool):
        """Run the block in training (batch-statistics) or eval mode, then
        restore the previous mode."""
        was = self.training
        self.train(train)
        try:
            yield self
        finally:
            self.train(was)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acts = [x]
        h = x
        for i, layer in enumerate(self.layers):
            inp = h
            for s, d in self.cfg.skips:
                if d == i:
                    inp = torch.cat([inp, acts[s]], dim=-1)
            h = layer(inp)
            acts.append(h)
        return h


def init(cfg: LogicNetCfg, generator: torch.Generator, mask_seed: int = 0,
         device=None) -> LogicNet:
    """A freshly initialised network on ``device`` (default ``cuda``).

    The weights are drawn on the CPU from ``generator``, so a seed gives
    the same network on every device.
    """
    dev = resolve_device(device)
    return LogicNet(cfg, generator, mask_seed).to(dev)


def _as_input(net: LogicNet, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=net.device)


def _labels(net: LogicNet, y) -> torch.Tensor:
    return torch.as_tensor(y, device=net.device).long()


def forward(net: LogicNet, x, train: bool = False) -> torch.Tensor:
    """Float (STE fake-quant) forward -> logits.  ``train=True`` uses batch
    statistics and updates the running ones in place."""
    with net.mode(train):
        return net(_as_input(net, x))


def loss_fn(net: LogicNet, x, y, train: bool = True) -> torch.Tensor:
    """Mean negative log-likelihood of the labels."""
    logp = torch.log_softmax(forward(net, x, train), dim=-1)
    return -logp.gather(1, _labels(net, y)[:, None]).mean()


def accuracy(net: LogicNet, x, y) -> float:
    with torch.no_grad():
        logits = forward(net, x, train=False)
    return float((logits.argmax(-1) == _labels(net, y)).float().mean())


# ---------------------------------------------------------------------------
# Conversion: NEQs -> HBBs (design-flow step 3)
# ---------------------------------------------------------------------------

def generate_tables(net: LogicNet) -> list[TT.LayerTruthTable]:
    """Truth tables for every *sparse* layer (a dense final layer stays
    arithmetic, as in the thesis)."""
    cfg = net.cfg
    if cfg.skips:
        raise NotImplementedError(
            "table conversion for skip topologies needs bus rewiring; "
            "train-time support only (as in the thesis)")
    cfgs = cfg.layer_cfgs()
    tables = []
    for i, (c, layer) in enumerate(zip(cfgs, net.layers)):
        if not isinstance(c, L.SparseLinearCfg):
            break
        out_q = cfgs[i + 1].in_quant if i + 1 < len(cfgs) else cfg.out_quant
        tables.append(TT.generate_sparse_linear_table(c, layer, out_q))
    return tables


def verify_tables(net: LogicNet, tables: list[TT.LayerTruthTable], x,
                  fused: bool = False, optimize_level: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Functional verification: float path vs table path on the sparse stack.

    Returns ``(codes_float_path, codes_table_path)`` on the network's
    device; the contract is exact equality.  The float path runs the
    sparse layers in eval mode (on the card: the masked-matmul kernel);
    the table path runs the per-layer LUT kernel, or with ``fused=True``
    the compiled whole-network kernel.  ``optimize_level`` first shrinks
    the tables through the truth-table compiler (``repro_torch.compile``);
    the equality must survive it.  With ``fused=True`` that serves the
    compiler's mixed-width lowering, so this is also the mixed kernel's
    end-to-end check.
    """
    cfgs = net.cfg.layer_cfgs()
    x = _as_input(net, x)
    table_out = table_infer.network_table_forward(
        tables, codes(cfgs[0].in_quant, x), fused=fused,
        optimize_level=optimize_level)
    with net.mode(False), torch.no_grad():
        h = x
        for layer in net.layers[:len(tables)]:
            h = layer(h)
    out_q = (cfgs[len(tables)].in_quant if len(tables) < len(cfgs)
             else net.cfg.out_quant)
    return codes(out_q, h), table_out


def sparse_head_forward(net: LogicNet, tables: list[TT.LayerTruthTable], x,
                        fused: bool = False) -> torch.Tensor:
    """Deployment-style forward: the sparse stack through its tables, then
    the dense final layer (if any) in arithmetic, in eval mode."""
    cfgs = net.cfg.layer_cfgs()
    in_codes = codes(cfgs[0].in_quant, _as_input(net, x))
    out_codes = table_infer.network_table_forward(tables, in_codes,
                                                  fused=fused)
    if len(tables) == len(cfgs):
        return out_codes
    h = dequantize_code(cfgs[-1].in_quant, out_codes)
    with net.mode(False), torch.no_grad():
        return net.layers[-1](h)


def to_verilog(net: LogicNet, pipeline: bool = False,
               optimize_level: int | None = None,
               sop: bool = False) -> dict[str, str]:
    """Generate RTL; ``optimize_level`` routes the netlist through the
    truth-table compiler first — deduped/shrunk case-statement modules with
    don't-care entries folded into each module's ``default:`` arm.
    ``sop=True`` emits two-level sum-of-products assigns for neurons the
    minimizer covered (``optimize_level=4`` attaches the covers); the rest
    keep the case-statement form."""
    from repro_torch.core import netlist as NL
    from repro_torch.core import verilog

    tables = generate_tables(net)
    if optimize_level is not None:
        from repro_torch.compile import optimize
        nl = optimize(tables, optimize_level,
                      in_features=net.cfg.in_features).netlist
    else:
        nl = NL.build_netlist(tables, net.cfg.in_features)
    return verilog.generate_verilog(nl, pipeline, sop=sop)


# ---------------------------------------------------------------------------
# Weight carry between the reference's layer dicts and the port's module
# ---------------------------------------------------------------------------

def from_reference(cfg: LogicNetCfg, model: list[dict],
                   device=None) -> LogicNet:
    """A :class:`LogicNet` holding the reference's parameters, masks and
    batch-norm state (arrays of any kind numpy can read)."""
    net = LogicNet(cfg)
    with torch.no_grad():
        for layer, d in zip(net.layers, model):
            p = d["params"]
            for dst, src in ((layer.w, p["w"]), (layer.b, p["b"]),
                             (layer.bn.scale, p["bn"]["scale"]),
                             (layer.bn.bias, p["bn"]["bias"]),
                             (layer.bn.mean, d["bn_state"]["mean"]),
                             (layer.bn.var, d["bn_state"]["var"])):
                dst.copy_(torch.from_numpy(np.array(src, np.float32)))
            if isinstance(layer, L.SparseLinear):
                layer.mask.copy_(torch.from_numpy(
                    np.array(d["mask"], np.float32)))
    return net.to(resolve_device(device))


_LEAVES = {"w": ("params", "w"), "b": ("params", "b"),
           "bn.scale": ("params", "bn", "scale"),
           "bn.bias": ("params", "bn", "bias"),
           "bn.mean": ("bn_state", "mean"), "bn.var": ("bn_state", "var"),
           "mask": ("mask",)}


def reference_to_arrays(model: list[dict], prefix: str) -> dict:
    """The reference's layer dicts as flat ``<prefix>.<layer>.<leaf>``
    float32 numpy arrays: the inverse of :func:`reference_from_arrays`."""
    out = {}
    for i, layer in enumerate(model):
        for leaf, path in _LEAVES.items():
            node = layer
            for key in path:
                node = node.get(key) if isinstance(node, dict) else None
            if node is not None:
                out[f"{prefix}.{i}.{leaf}"] = np.asarray(node, np.float32)
    return out


def reference_from_arrays(arrays: dict, prefix: str) -> list[dict]:
    """The reference's layer dicts from flat ``<prefix>.<layer>.<leaf>``
    arrays (leaves ``w``, ``b``, ``bn.scale``, ``bn.bias``, ``bn.mean``,
    ``bn.var``, ``mask``), the form the test fixtures are saved in."""
    model: list[dict] = []
    for key, value in arrays.items():
        head, _, rest = key.partition(".")
        if head != prefix:
            continue
        layer, _, leaf = rest.partition(".")
        while len(model) <= int(layer):
            model.append({})
        node = model[int(layer)]
        *path, last = _LEAVES[leaf]
        for k in path:
            node = node.setdefault(k, {})
        node[last] = value
    return model


def to_reference(net: LogicNet) -> list[dict]:
    """The reference's list of layer dicts, as numpy arrays."""
    def a(t):
        return t.detach().cpu().numpy().copy()

    model = []
    for layer in net.layers:
        d = {"params": {"w": a(layer.w), "b": a(layer.b),
                        "bn": {"scale": a(layer.bn.scale),
                               "bias": a(layer.bn.bias)}},
             "bn_state": {"mean": a(layer.bn.mean), "var": a(layer.bn.var)}}
        if isinstance(layer, L.SparseLinear):
            d["mask"] = a(layer.mask)
        model.append(d)
    return model
