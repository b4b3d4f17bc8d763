"""Quickstart: the LogicNets flow end to end on one GPU,
``python -m repro_torch.launch.quickstart``.

The port's counterpart of ``examples/quickstart.py``: train a tiny
sparse-quantized net (Table 6.1 model C) on the jet-substructure
stand-in, convert every neuron to a truth table, verify the tables match
the quantized network bit-exactly through the fused whole-network
kernel, compile a serving artifact at optimize level 3 (one compiler
run, one slab build), check it against the table codes and through a
save/load round-trip, and emit Verilog::

    python -m repro_torch.launch.quickstart                 # on the card
    python -m repro_torch.launch.quickstart --device cpu --steps 5

On the card training launches the masked-matmul kernel, the verification
the uniform fused LUT kernel and the artifact the mixed one; ``--device
cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import os
import tempfile

STEPS = 300


def run(steps: int = STEPS, device=None) -> dict:
    """The quickstart flow; prints the reference example's lines and
    returns what it checked: ``accuracy``, ``verify_exact``, ``layout``,
    ``table_slab_bytes``, ``raw_table_bytes``, ``roundtrip_exact``,
    ``npz_bytes``, ``modules`` and ``verilog_bytes``.  A mismatch raises
    ``SystemExit``."""
    import torch

    from repro_torch import engine
    from repro_torch._device import resolve_device
    from repro_torch.configs import fpga4hep
    from repro_torch.core import logicnet as LN
    from repro_torch.core.quantize import codes as quant_codes
    from repro_torch.core.train import train_logicnet
    from repro_torch.data import jet_substructure_data

    dev = resolve_device(device)
    # 1. Data + topology (paper Table 6.1 model C: (64,32,32), BW=2, X=3).
    x, y = jet_substructure_data(4000, seed=0)
    cfg = fpga4hep.model_c()
    print(f"model C: per-layer LUTs {cfg.luts()}  total {cfg.total_luts()}")

    # 2. Train with a-priori fixed sparsity.
    res = train_logicnet(cfg, x[:3500], y[:3500], x[3500:], y[3500:],
                         method="apriori", steps=steps, device=dev)
    print(f"test accuracy: {res.accuracy:.3f}")

    # 3. Convert NEQs -> truth tables; functional verification through the
    # fused whole-network kernel (one launch for the entire sparse stack).
    tables = LN.generate_tables(res.model)
    f_codes, t_codes = LN.verify_tables(res.model, tables, x[3500:3600],
                                        fused=True)
    exact = torch.equal(f_codes, t_codes)
    print(f"truth-table functional verification (fused kernel): "
          f"{'EXACT MATCH' if exact else 'MISMATCH'}")
    if not exact:
        raise SystemExit("truth-table verification failed")
    out = {"accuracy": res.accuracy, "verify_exact": exact}

    # 4. Compile the serving artifact: the compiler and the slab build run
    # once, then every call serves from the slabs.
    net = engine.compile_network(tables, optimize_level=3,
                                 in_features=cfg.in_features, device=dev)
    bd = net.slab_breakdown()
    print(f"compiled artifact: layout={net.layout} "
          f"table slab {bd['table_slab_bytes']} B "
          f"(raw {net.stats.table_bytes_before} B)")
    in_codes = quant_codes(cfg.layer_cfgs()[0].in_quant,
                           torch.as_tensor(x[3500:3600], device=dev))
    if not torch.equal(net(in_codes), t_codes):
        raise SystemExit("compiled artifact differs from the table codes")
    out.update(layout=net.layout, table_slab_bytes=bd["table_slab_bytes"],
               raw_table_bytes=net.stats.table_bytes_before)

    # 5. Save/load round-trip: deployment loads the .npz straight into the
    # exact slabs, with no compiler on the serving host.
    with tempfile.TemporaryDirectory() as tmp:
        path = net.save(os.path.join(tmp, "logicnet_c.npz"))
        reloaded = engine.load(path, device=dev)
        exact = torch.equal(reloaded(in_codes), t_codes)
        npz_bytes = os.path.getsize(path)
        print(f"artifact round-trip ({npz_bytes} B npz): "
              f"{'EXACT MATCH' if exact else 'MISMATCH'}")
    if not exact:
        raise SystemExit("artifact round-trip failed")
    out.update(roundtrip_exact=exact, npz_bytes=npz_bytes)

    # 6. Emit Verilog (Listings 5.2-5.6 structure).
    files = LN.to_verilog(res.model)
    n_bytes = sum(map(len, files.values()))
    print(f"generated {len(files)} Verilog modules "
          f"({n_bytes / 1e3:.1f} kB)")
    print("\n".join(files["LogicNetModule.v"].splitlines()[:4]))
    out.update(modules=len(files), verilog_bytes=n_bytes)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="training steps (the reference example's 300)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    run(args.steps, args.device)


if __name__ == "__main__":
    main()
