"""The paper's MNIST flow (thesis ch. 7, Table 7.1), on one GPU:
``python -m repro_torch.launch.train_mnist_logicnet``.

Select a Table 7.1 MLP (``--row``, default the widest, ``mlp((2048,
2048, 2048), 2, 5)``), train it on the procedural digits
(``mnist_like_data``: 4000 rows to train on, 800 held out, flattened and
centred as ``benchmarks/paper_tables.py`` does; 250 steps at lr 5e-3, the
reference table's budget), then run the flow of
``repro_torch.launch.train_jsc_logicnet``: AUC-ROC and accuracy, exact
table verification, the serving artifact built and checked::

    # train the widest MLP on the card and serve its artifact
    python -m repro_torch.launch.train_mnist_logicnet --out /tmp/mnist
    python -m repro_torch.launch.serve --lut --smoke \\
        --artifact /tmp/mnist/logicnet_mnist.npz --input-bw 2

    # the narrowest row, a few steps on the CPU
    python -m repro_torch.launch.train_mnist_logicnet --row 0 --steps 3 \\
        --device cpu

The artifact's slabs exceed the fused kernels' budget at every Table 7.1
row, so the engine serves it per-layer.  ``--optimize-level`` (default
0) runs the truth-table compiler first.
"""

from __future__ import annotations

import argparse

MNIST_ROWS = (4000, 800)


def mnist_data(n_train: int = MNIST_ROWS[0], n_test: int = MNIST_ROWS[1]):
    """``benchmarks/paper_tables.py``'s MNIST data: procedural digits,
    flattened and centred (a 1-bit input quantizer thresholds at 0)."""
    from repro_torch.data import mnist_like_data

    x, y = mnist_like_data(n_train + n_test, seed=0)
    x = x.reshape(len(x), -1)
    x = (x - x.mean()) / (x.std() + 1e-6)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def main(argv=None) -> None:
    from repro_torch.configs import mnist

    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--row", type=int, default=len(mnist.TABLE_7_1) - 1,
                    choices=range(len(mnist.TABLE_7_1)),
                    help="Table 7.1 row (0-8; default: the widest)")
    ap.add_argument("--method", default="apriori",
                    choices=["apriori", "iterative", "momentum"])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimize-level", type=int, default=0,
                    help="truth-table compiler level (0 skips it)")
    ap.add_argument("--out", default=None,
                    help="directory for the serving artifact "
                    "logicnet_mnist.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    from repro_torch.launch.train_jsc_logicnet import run

    cfg = mnist.mlp(*mnist.TABLE_7_1[args.row])
    run(cfg, mnist_data(), name="mnist", classes=[str(d) for d in range(10)],
        method=args.method, steps=args.steps, lr=args.lr, seed=args.seed,
        optimize_level=args.optimize_level, out=args.out,
        device=args.device)


if __name__ == "__main__":
    main()
