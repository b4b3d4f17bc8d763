"""The paper's flow on the FPGA4HEP task (thesis ch. 6), on one GPU:
``python -m repro_torch.launch.train_jsc_logicnet``.

Select a Table 6.1 model (A-E) and a sparsity method, train, report
per-class AUC-ROC and accuracy, verify the truth tables exactly against
the float path, compare the analytical LUT cost with the
logic-minimization proxy (Table 5.2), shrink the tables with the
truth-table compiler (``--optimize-level``, default 2; 0 skips it) and
verify the optimized tables exactly, compile the result into a serving
artifact and check it against the table codes::

    # train model A on the card and keep its serving artifact
    python -m repro_torch.launch.train_jsc_logicnet --model A \\
        --method apriori --steps 600 --out /tmp/logicnet_a
    python -m repro_torch.launch.serve --lut \\
        --artifact /tmp/logicnet_a/logicnet_A.npz --input-bw 3

    # a few steps on the CPU (plain PyTorch versions of the kernels)
    python -m repro_torch.launch.train_jsc_logicnet --steps 5 --device cpu

``--out`` writes the serving artifact only; the Verilog that
``examples/train_jsc_logicnet.py`` also writes there comes from
``repro_torch.core.logicnet.to_verilog`` (or ``core.verilog.
generate_verilog`` of a compile result's netlist).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

CLASSES = ["g", "q", "W", "Z", "t"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="A", choices=list("ABCDE"))
    ap.add_argument("--method", default="apriori",
                    choices=["apriori", "iterative", "momentum"])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimize-level", type=int, default=2,
                    help="truth-table compiler level (0 disables; see "
                    "repro_torch.compile)")
    ap.add_argument("--out", default=None,
                    help="directory for the serving artifact "
                    "logicnet_<model>.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import fpga4hep
    from repro_torch.data import jet_substructure_data

    cfg = fpga4hep.MODELS[args.model]()
    x, y = jet_substructure_data(8000, seed=0)
    run(cfg, (x[:7000], y[:7000], x[7000:], y[7000:]), name=args.model,
        classes=CLASSES, method=args.method, steps=args.steps,
        seed=args.seed, optimize_level=args.optimize_level, out=args.out,
        device=args.device)


def run(cfg, data, *, name: str, classes, method: str = "apriori",
        steps: int = 600, lr: float = 1e-2, seed: int = 0,
        optimize_level: int = 2, out: str | None = None,
        device=None) -> None:
    """Train ``cfg`` on ``data`` (train and held-out arrays), report
    per-class AUC-ROC and accuracy, verify the tables (and, at an
    ``optimize_level``, the compiled ones), build and check the serving
    artifact, and write it to ``out/logicnet_<name>.npz``."""
    import torch

    from repro_torch import engine
    from repro_torch._device import resolve_device
    from repro_torch.core import logicnet as LN
    from repro_torch.core.quantize import codes
    from repro_torch.core.train import auc_roc_ovr, train_logicnet
    from repro_torch.core.truth_table import minimized_lut_estimate

    dev = resolve_device(device)
    print(f"model {name}: HL={cfg.hidden} BW={cfg.bw} X={cfg.fan_in} "
          f"LUTs={cfg.luts()} (total {cfg.total_luts()}) on {dev}")

    xt, yt, xv, yv = data
    res = train_logicnet(cfg, xt, yt, xv, yv, method=method, steps=steps,
                         lr=lr, seed=seed, device=dev)
    aucs = auc_roc_ovr(res.model, xv, yv)
    for c, cname in enumerate(classes):
        print(f"  AUC-ROC[{cname}] = {aucs[c] * 100:.2f}")
    print(f"  avg AUC-ROC = {np.nanmean(list(aucs.values())) * 100:.2f}   "
          f"accuracy = {res.accuracy:.3f}")

    tables = LN.generate_tables(res.model)
    f_codes, t_codes = LN.verify_tables(res.model, tables, xv[:200])
    if not torch.equal(f_codes, t_codes):
        raise SystemExit("truth-table verification failed")
    print("truth-table functional verification: EXACT")

    analytical = sum(cfg.luts()[:len(tables)])
    minimized = sum(minimized_lut_estimate(t) for t in tables)
    print(f"analytical LUTs {analytical} vs minimization proxy "
          f"{minimized} ({analytical / max(minimized, 1):.2f}x reduction; "
          "Vivado synthesis lands lower still, Table 5.2)")

    opt = None
    if optimize_level:
        from repro_torch import compile as rcompile
        opt = rcompile.optimize(tables, optimize_level,
                                in_features=cfg.in_features)
        print(f"truth-table compiler: {rcompile.summarize(opt.stats)}")
        # verify the optimized tables themselves: one compile, reused for
        # the serving artifact below
        f_codes, t_codes = LN.verify_tables(res.model, opt.tables, xv[:200])
        if not torch.equal(f_codes, t_codes):
            raise SystemExit("optimized-table verification failed")
        print("optimized-table functional verification: EXACT")

    net = engine.compile_network(opt if opt is not None else tables,
                                 in_features=cfg.in_features, device=dev)
    bd = net.slab_breakdown()
    print(f"serving artifact: layout={net.layout} "
          f"table slab {bd['table_slab_bytes']} B "
          f"(total {bd['total_bytes']} B)")
    in_codes = codes(cfg.layer_cfgs()[0].in_quant,
                     torch.as_tensor(xv[:200], device=dev))
    if not torch.equal(net(in_codes), t_codes):
        raise SystemExit("serving artifact verification failed")
    print("serving artifact verification: EXACT")

    if out:
        os.makedirs(out, exist_ok=True)
        apath = net.save(os.path.join(out, f"logicnet_{name}.npz"))
        print(f"wrote serving artifact {apath} (python -m "
              f"repro_torch.launch.serve --lut --artifact {apath} serves it)")


if __name__ == "__main__":
    main()
