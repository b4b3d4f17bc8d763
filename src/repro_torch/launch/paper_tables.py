"""One function per table of the thesis, trained on one GPU:
``python -m repro_torch.launch.paper_tables``.

The port's counterpart of ``benchmarks/paper_tables.py``: the same
functions, row names and derived fields.  Each function returns a list of
CSV rows ``(name, us_per_call, derived)``.  Training rows use the
synthetic stand-ins for FPGA4HEP and MNIST (``repro_torch.data``): the
LUT-cost columns are exact, the accuracy columns show trends (bit-width
up -> accuracy up; iterative >= a-priori; skips free), not the paper's
absolute numbers.  Every trained network without skips also has its
truth tables generated and verified exactly on 200 held-out rows (on the
card through the per-layer LUT kernel); a mismatch fails its table::

    python -m repro_torch.launch.paper_tables --quick          # on the card
    python -m repro_torch.launch.paper_tables --csv tables.csv
    python -m repro_torch.launch.paper_tables --quick --device cpu

A table that raises becomes one ``<table>/ERROR`` row, so the CSV still
holds the others.  :func:`check_rows` refuses such rows and an inexact
column (Tables 2.1 and 6.1's ``exact=``, Table 7.3's ``sparse_luts``
across skips); the command exits non-zero after writing the rows.
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import fpga4hep, mnist as mnist_cfg
from repro_torch.core import layers as L
from repro_torch.core import logicnet as LN
from repro_torch.core import lut_cost as LC
from repro_torch.core.layers import SparseConv, SparseConvCfg
from repro_torch.core.netlist import build_netlist
from repro_torch.core.quantize import QuantizerCfg
from repro_torch.core.train import auc_roc_ovr, train_logicnet
from repro_torch.core.truth_table import (generate_sparse_linear_table,
                                          minimized_lut_estimate)
from repro_torch.core.verilog import generate_verilog
from repro_torch.data import jet_substructure_data, mnist_like_data
# the MNIST tables' data: procedural digits, flattened and centred (a
# 1-bit input quantizer thresholds at 0)
from repro_torch.launch.train_mnist_logicnet import mnist_data as _mnist_data
from repro_torch.optim.adamw import AdamWCfg, adamw_update, init_opt_state

Row = tuple[str, float, str]

# training steps of (the jet tables, the MNIST MLP tables, Table 7.4) in a
# full and a quick (``--quick``) run: the reference's budgets
BUDGETS = {False: (300, 250, 200), True: (120, 100, 80)}
VERIFY_ROWS = 200


def _sync(dev) -> None:
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, *a, sync=None, **kw):
    """``fn(*a, **kw)`` and its wall microseconds; with a CUDA device as
    ``sync`` that card is synchronised before each reading of the clock."""
    _sync(sync)
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    _sync(sync)
    return out, (time.perf_counter() - t0) * 1e6


def _verify(net: LN.LogicNet, x, tables=None) -> None:
    """Generate (or take) ``net``'s truth tables and hold the table path to
    the float path on ``x[:VERIFY_ROWS]``, bit for bit."""
    if tables is None:
        tables = LN.generate_tables(net)
    f_codes, t_codes = LN.verify_tables(net, tables, x[:VERIFY_ROWS])
    if not torch.equal(f_codes, t_codes):
        raise RuntimeError("truth-table verification failed: "
                           f"{int((f_codes != t_codes).sum())} codes differ")


# ---------------------------------------------------------------------------

def table_2_1(device=None) -> list[Row]:
    """Static mapping cost to 6:1 LUTs (exact reproduction; host
    arithmetic, whatever the ``device``)."""
    rows = []
    expect = {6: 1, 7: 3, 8: 5, 9: 11, 10: 21, 11: 43}
    for f, n in expect.items():
        r, us = _timed(LC.static_mapping_row, f)
        ok = r.n_6luts == n
        rows.append((f"table2.1/fanin{f}", us,
                     f"n6luts={r.n_6luts} expected={n} "
                     f"util={r.pct_utilized:.2f}% exact={ok}"))
    return rows


def table_5_1(device=None) -> list[Row]:
    """Truth-table generation size/time vs fan-in bits (paper: 15-20b),
    then the Verilog of each table."""
    dev = resolve_device(device)
    rows = []
    for bits in (8, 12, 16):
        fan_in, bw = bits // 2, 2
        cfg = L.SparseLinearCfg(in_features=max(fan_in * 2, 16),
                                out_features=1, fan_in=fan_in, bw_in=bw)
        layer = L.SparseLinear(cfg, torch.Generator().manual_seed(0)).to(dev)
        tt, us = _timed(generate_sparse_linear_table, cfg, layer,
                        QuantizerCfg(bw), sync=dev)
        nl = build_netlist([tt], cfg.in_features)
        files = generate_verilog(nl)
        vsize = sum(len(t) for t in files.values()) / 1e6
        rows.append((f"table5.1/{bits}bit", us,
                     f"verilog_mb={vsize:.3f} entries={tt.n_entries}"))
    return rows


def table_5_2(budget: int = 300, device=None) -> list[Row]:
    """Analytical LUT cost vs post-'synthesis' estimate.

    Vivado is unavailable; the minimization proxy (constant bits,
    duplicate neurons, dead inputs) is a *lower* bound on what synthesis
    finds, reported in the paper's (analytical, synthesized, reduction)
    format.
    """
    x, y = jet_substructure_data(4000, seed=1)
    rows = []
    for name in ("C", "E"):
        cfg = fpga4hep.MODELS[name]()
        res = train_logicnet(cfg, x[:3500], y[:3500], x[3500:], y[3500:],
                             method="apriori", steps=budget, device=device)
        tables = LN.generate_tables(res.model)
        _verify(res.model, x[3500:], tables)
        analytical = sum(cfg.luts()[:len(tables)])
        t0 = time.perf_counter()
        minimized = sum(minimized_lut_estimate(t) for t in tables)
        us = (time.perf_counter() - t0) * 1e6
        red = analytical / max(minimized, 1)
        rows.append((f"table5.2/model{name}", us,
                     f"analytical={analytical} minimized={minimized} "
                     f"reduction={red:.2f}x"))
    return rows


def table_6_1(device=None) -> list[Row]:
    """Model descriptions A-E: per-layer analytical LUTs (exact columns;
    host arithmetic, whatever the ``device``)."""
    expected = {
        "A": [2112, 2112, 2112], "B": [4224, 2112, 1056],
        "C": [128, 64, 64], "D": [2688, 1344, 1344, 3400],
        "E": [640, 640, 640, 200],
    }
    rows = []
    for name, fn in fpga4hep.MODELS.items():
        cfg = fn()
        luts, us = _timed(cfg.luts)
        want = expected[name]
        got = luts[:len(want)]
        rows.append((f"table6.1/model{name}", us,
                     f"luts={got} expected={want} exact={got == want}"))
    return rows


def table_6_2(budget: int = 300, device=None) -> list[Row]:
    """JSC classification: AUC-ROC + total LUTs per model (A-E)."""
    x, y = jet_substructure_data(6000, seed=0)
    xt, yt, xv, yv = x[:5000], y[:5000], x[5000:], y[5000:]
    rows = []
    for name, fn in fpga4hep.MODELS.items():
        cfg = fn()
        res, us = _timed(train_logicnet, cfg, xt, yt, xv, yv,
                         method="apriori", steps=budget, device=device,
                         sync=resolve_device(device))
        us /= budget
        _verify(res.model, xv)
        aucs = auc_roc_ovr(res.model, xv, yv)
        avg = float(np.nanmean(list(aucs.values()))) * 100
        rows.append((f"table6.2/model{name}", us,
                     f"avg_auc={avg:.2f} acc={res.accuracy:.3f} "
                     f"luts={cfg.total_luts()}"))
    return rows


def table_6_3(budget: int = 300, device=None) -> list[Row]:
    """A-priori fixed sparsity vs iterative pruning (JSC)."""
    x, y = jet_substructure_data(6000, seed=2)
    xt, yt, xv, yv = x[:5000], y[:5000], x[5000:], y[5000:]
    rows = []
    for name in ("C", "E"):
        cfg = fpga4hep.MODELS[name]()
        accs = {}
        for method in ("apriori", "iterative"):
            # thesis: iterative pruning "takes about 10x longer to train";
            # 2x here keeps the comparison honest on a small budget.
            res = train_logicnet(cfg, xt, yt, xv, yv, method=method,
                                 steps=budget * (2 if method == "iterative"
                                                 else 1), seed=3,
                                 device=device)
            _verify(res.model, xv)
            aucs = auc_roc_ovr(res.model, xv, yv)
            accs[method] = float(np.nanmean(list(aucs.values()))) * 100
        rows.append((f"table6.3/model{name}", 0.0,
                     f"apriori={accs['apriori']:.2f} "
                     f"iterative={accs['iterative']:.2f}"))
    return rows


def _train_mnist(cfg, data, budget, device, **kw):
    xt, yt, xv, yv = data
    res = train_logicnet(cfg, xt, yt, xv, yv, steps=budget, lr=5e-3,
                         device=device, **kw)
    if not cfg.skips:
        _verify(res.model, xv)
    return res


def table_7_1(budget: int = 250, device=None) -> list[Row]:
    """MNIST MLP width/depth sweep: LUTs vs accuracy."""
    data = _mnist_data()
    rows = []
    for hidden, bw, fan_in in [((512,), 2, 6), ((1024,), 2, 5),
                               ((512, 512), 2, 6),
                               ((1024, 1024), 2, 5),
                               ((512, 512, 512), 2, 6)]:
        cfg = mnist_cfg.mlp(hidden, bw, fan_in)
        res = _train_mnist(cfg, data, budget, device, method="apriori")
        tag = "x".join(map(str, hidden))
        rows.append((f"table7.1/{tag}_bw{bw}_x{fan_in}", 0.0,
                     f"acc={res.accuracy:.4f} luts={cfg.total_luts()}"))
    return rows


def fig_7_2_bitwidth(budget: int = 250, device=None) -> list[Row]:
    """Accuracy vs bit-width (Fig 7.2/6.8): bw 1->2 helps, 2->3 less."""
    data = _mnist_data()
    rows = []
    for bw in (1, 2, 3):
        cfg = mnist_cfg.mlp((512, 512), bw, 5)
        res = _train_mnist(cfg, data, budget, device, method="apriori")
        rows.append((f"fig7.2/bw{bw}", 0.0,
                     f"acc={res.accuracy:.4f} luts={cfg.total_luts()}"))
    return rows


def table_7_2(budget: int = 250, device=None) -> list[Row]:
    """Pruning methods on MNIST: a-priori vs momentum vs iterative."""
    data = _mnist_data()
    cfg = mnist_cfg.mlp((512, 512), 2, 6)
    rows = []
    for method in ("apriori", "momentum", "iterative"):
        res = _train_mnist(cfg, data, budget * (2 if method == "iterative"
                                                else 1), device,
                           method=method, seed=5)
        rows.append((f"table7.2/{method}", 0.0,
                     f"acc={res.accuracy:.4f}"))
    return rows


def table_7_3(budget: int = 250, device=None) -> list[Row]:
    """Skip connections: accuracy up, sparse-layer LUT cost unchanged."""
    data = _mnist_data()
    rows = []
    for n_skip, skips in [(0, ()), (1, ((0, 2),)), (2, ((0, 2), (1, 3)))]:
        cfg = mnist_cfg.mlp((256, 256, 256), 2, 6, skips=skips)
        res = _train_mnist(cfg, data, budget, device, method="apriori",
                           seed=7)
        sparse_luts = sum(cfg.luts()[:3])
        rows.append((f"table7.3/skip{n_skip}", 0.0,
                     f"acc={res.accuracy:.4f} sparse_luts={sparse_luts}"))
    return rows


def conv_cfg(variant: str) -> SparseConvCfg:
    """Table 7.4's SparseConv layer for one ablation variant."""
    return SparseConvCfg(in_channels=1, out_channels=16, kernel_size=3,
                         stride=2,
                         x_k=9 if variant in ("FP", "FP_DW") else 5,
                         x_s=16 if variant in ("FP", "FP_DW") else 5,
                         bw_in=8 if variant != "QUANT_X_DW" else 2,
                         bw_mid=8 if variant != "QUANT_X_DW" else 2,
                         first_layer=True)


# Table 7.4's optimiser (the clip is active: gradient norms start near 1.3)
CONV_HEAD_OPT = AdamWCfg(lr=5e-3, clip_norm=1.0)


def conv_head_cfg() -> LN.LogicNetCfg:
    """Table 7.4's LogicNet head on the conv layer's 13x13x16 outputs."""
    return LN.LogicNetCfg(16 * 13 * 13, 10, hidden=(128,), fan_in=6, bw=2,
                          final_dense=True, bw_fc=2)


def train_conv_head(conv: SparseConv, head: LN.LogicNet, data, budget: int,
                    batch: int = 128) -> tuple[np.ndarray, torch.Tensor]:
    """Table 7.4's loop: ``budget`` AdamW steps (``CONV_HEAD_OPT``) of
    ``conv`` and ``head`` together on ``batch`` rows a step, drawn by
    ``default_rng(0)`` from the training half of ``data = (xt, yt, xv,
    yv)``, every batch norm's running statistics updated in place.

    Returns each step's loss and :func:`conv_head_logits` of ``xv``, on
    the device that holds ``conv``.
    """
    dev = conv.w_dw.device
    xt, yt = (torch.as_tensor(a, device=dev) for a in data[:2])
    yt = yt.long()
    params = {**{f"conv.{k}": p for k, p in conv.named_parameters()},
              **{f"head.{k}": p for k, p in head.named_parameters()}}
    opt = init_opt_state(params)

    conv.train()
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(budget):
        idx = torch.from_numpy(rng.integers(0, len(xt), batch)).to(dev)
        h = conv(xt[idx])
        nll = LN.loss_fn(head, h.reshape(h.shape[0], -1), yt[idx],
                         train=True)
        grads = torch.autograd.grad(nll, list(params.values()))
        adamw_update(CONV_HEAD_OPT, params, dict(zip(params, grads)), opt)
        losses.append(nll.detach())

    return (np.array([float(v) for v in losses], np.float32),
            conv_head_logits(conv, head, data[2]))


def conv_head_logits(conv: SparseConv, head: LN.LogicNet,
                     x) -> torch.Tensor:
    """Eval-mode logits of ``head`` on ``conv``'s outputs (running batch
    statistics); leaves ``conv`` in eval mode."""
    conv.eval()
    with torch.no_grad():
        h = conv(torch.as_tensor(x, device=conv.w_dw.device))
        return LN.forward(head, h.reshape(h.shape[0], -1), train=False)


def table_7_4(budget: int = 200, device=None) -> list[Row]:
    """Convolution ablation (FP / FP_DW / FP_X_DW / QUANT_X_DW) on the
    SparseConv stack: quantization costs the most accuracy (§7)."""
    dev = resolve_device(device)
    x, y = mnist_like_data(2400, seed=1)
    data = (x[:2000], y[:2000], x[2000:], y[2000:])
    yv = torch.as_tensor(data[3], device=dev).long()
    rows = []
    for variant in ("FP_DW", "FP_X_DW", "QUANT_X_DW"):
        conv = SparseConv(conv_cfg(variant),
                          torch.Generator().manual_seed(11)).to(dev)
        head = LN.init(conv_head_cfg(), torch.Generator().manual_seed(12),
                       device=dev)
        _, logits = train_conv_head(conv, head, data, budget)
        acc = float((logits.argmax(-1) == yv).float().mean())
        rows.append((f"table7.4/{variant}", 0.0, f"acc={acc:.4f}"))
    return rows


def timed_tables(quick: bool = False, device=None
                 ) -> tuple[list[Row], dict[str, float]]:
    """Every table's rows, and each table's wall seconds (the card
    synchronised at both ends).  A table that raises gives one
    ``<table>/ERROR`` row holding the exception."""
    b, bm, bc = BUDGETS[quick]
    parts = [
        ("table2.1", table_2_1, {"device": device}),
        ("table5.1", table_5_1, {"device": device}),
        ("table5.2", table_5_2, {"budget": b, "device": device}),
        ("table6.1", table_6_1, {"device": device}),
        ("table6.2", table_6_2, {"budget": b, "device": device}),
        ("table6.3", table_6_3, {"budget": b, "device": device}),
        ("table7.1", table_7_1, {"budget": bm, "device": device}),
        ("fig7.2", fig_7_2_bitwidth, {"budget": bm, "device": device}),
        ("table7.2", table_7_2, {"budget": bm, "device": device}),
        ("table7.3", table_7_3, {"budget": bm, "device": device}),
        ("table7.4", table_7_4, {"budget": bc, "device": device}),
    ]
    dev = resolve_device(device)
    rows: list[Row] = []
    walls: dict[str, float] = {}
    for name, fn, kw in parts:
        _sync(dev)
        t0 = time.perf_counter()
        try:
            rows += fn(**kw)
        except Exception as e:  # isolate: one table must not sink the CSV
            traceback.print_exc(file=sys.stderr)
            rows.append((f"{name}/ERROR", 0.0, repr(e)))
        _sync(dev)
        walls[name] = time.perf_counter() - t0
    return rows, walls


def all_tables(quick: bool = False, device=None) -> list[Row]:
    """Every table's rows (``timed_tables`` without the wall times)."""
    return timed_tables(quick, device)[0]


def _fields(derived: str) -> dict[str, str]:
    """A row's ``key=value`` fields (a bracketed list is one value)."""
    return dict(re.findall(r"(\w+)=(\[[^\]]*\]|\S+)", derived))


def row_failures(rows: list[Row]) -> list[str]:
    """What a whole run's rows must not show: an ``ERROR`` row; Table
    2.1's six rows and Table 6.1's five not all ``exact=True``; Table
    7.3's three rows not one ``sparse_luts`` (skips must not change the
    sparse layers' cost)."""
    out = [f"{n}: {d}" for n, _, d in rows if n.endswith("/ERROR")]
    for table, count in (("table2.1", 6), ("table6.1", 5)):
        exact = [_fields(d).get("exact") for n, _, d in rows
                 if n.startswith(table + "/")]
        if exact != ["True"] * count:
            out.append(f"{table}: exact={exact}, want {count} x True")
    luts = [_fields(d).get("sparse_luts") for n, _, d in rows
            if n.startswith("table7.3/")]
    if len(luts) != 3 or len(set(luts)) != 1 or None in luts:
        out.append(f"table7.3: sparse_luts {luts} change across skips")
    return out


def check_rows(rows: list[Row]) -> None:
    """Raise if a whole run's rows show any of :func:`row_failures`."""
    bad = row_failures(rows)
    if bad:
        raise RuntimeError(f"{len(bad)} check(s) failed: " + "; ".join(bad))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="the reference's quick budgets (120 / 100 / 80 "
                    "steps against 300 / 250 / 200)")
    ap.add_argument("--csv", default=None,
                    help="also write the rows to this CSV file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    rows, walls = timed_tables(args.quick, args.device)
    out = csv.writer(sys.stdout)
    out.writerow(["name", "us_per_call", "derived"])
    out.writerows(rows)
    for name, s in walls.items():
        print(f"# {name}: {s:.2f} s wall")
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "us_per_call", "derived"])
            w.writerows(rows)
    try:
        check_rows(rows)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


if __name__ == "__main__":
    main()
