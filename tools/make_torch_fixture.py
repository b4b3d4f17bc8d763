"""Write the model A fixtures that the PyTorch port is held against.

The port (``src/repro_torch``) has no truth-table compiler yet and never
imports JAX, so it serves a level-3 artifact that the reference package
compiled.  This tool makes that artifact and the reference outputs it is
compared with, from fixed seeds:

* ``model_a_l3.npz`` — ``repro.engine.CompiledLUTNet.save`` of fpga4hep
  model A generated the way ``python -m repro.launch.serve --lut`` does
  (``LN.init`` at PRNGKey(0), one ``train=True`` forward over 256 rows
  drawn at PRNGKey(1), ``generate_tables``, ``compile_network`` at
  optimize level 3) with ``block_b=16``;
* ``model_a_ref.npz`` (compressed) — the three raw ``(idx, table, bw_in)``
  triples, 4096 seeded input codes in ``[0, 8)`` (row 0 all 0, row 1
  all 7), and the reference outputs of the mixed (level-3), uniform
  (``compile_network(triples)``) and per-layer
  (``compile_network(triples, fused=False)``) artifacts on those codes;
* ``model_a_train.npz`` (compressed) — the training flow on
  ``jet_substructure_data(8000, 0)`` (rows ``[:7000]`` train, ``[7000:]``
  held out): model A's ``LN.init(cfg, PRNGKey(0), mask_seed=0)``
  (``init.<layer>.<leaf>``), the losses (``losses``) and final model
  (``trained.<layer>.<leaf>``) of ``train_logicnet(apriori, steps=20,
  batch=256, lr=1e-2, seed=0)``, its ``generate_tables``
  (``table_<i>`` / ``idx_<i>``), ``verify_tables``' float-path codes on
  the first 200 held-out rows (``verify_codes``), and the held-out
  accuracy of a 600-step run (``accuracy_600``).  Models are stored as
  ``repro_torch.core.logicnet.reference_to_arrays`` flattens them.

Run from the repo root (JAX on the CPU runs the Pallas kernels in
interpret mode)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/make_torch_fixture.py

``tests/test_torch_engine.py`` regenerates both in memory and asserts
they equal the committed files, so the fixture cannot drift from the
reference.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "torch_port")
ARTIFACT_NAME = "model_a_l3.npz"
REF_NAME = "model_a_ref.npz"
TRAIN_NAME = "model_a_train.npz"
TRAIN_STEPS = 20
LONG_STEPS = 600
N_VERIFY = 200
BLOCK_B = 16
N_CODES = 4096
CODES_SEED = 0


def model_a_tables():
    """Raw truth tables of generated model A, as ``serve --lut`` makes them."""
    import jax

    from repro.configs import fpga4hep
    from repro.core import logicnet as LN

    cfg = fpga4hep.model_a()
    model = LN.init(cfg, jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (256, cfg.in_features),
                           minval=-1, maxval=3)
    _, model = LN.forward(cfg, model, x, train=True)
    return cfg, LN.generate_tables(cfg, model)


def input_codes(n_in: int, bw: int) -> np.ndarray:
    """Seeded (N_CODES, n_in) int32 codes; rows 0 and 1 are all 0 / all max."""
    codes = np.random.default_rng(CODES_SEED).integers(
        0, 1 << bw, (N_CODES, n_in), dtype=np.int32)
    codes[0] = 0
    codes[1] = (1 << bw) - 1
    return codes


def build():
    """``(level-3 CompiledLUTNet, reference arrays dict)``, nothing written."""
    from repro import engine

    cfg, tables = model_a_tables()
    triples = [(np.asarray(t.indices, np.int32), np.asarray(t.table, np.int32),
                int(t.bw_in)) for t in tables]
    mixed = engine.compile_network(tables, optimize_level=3,
                                   in_features=cfg.in_features,
                                   block_b=BLOCK_B)
    uniform = engine.compile_network(triples, in_features=cfg.in_features,
                                     block_b=BLOCK_B)
    per_layer = engine.compile_network(triples, in_features=cfg.in_features,
                                       fused=False, block_b=BLOCK_B)
    assert (mixed.layout, uniform.layout, per_layer.layout) == (
        "mixed", "uniform", "per_layer")
    codes = input_codes(cfg.in_features, cfg.bw)
    ref = {"codes": codes, "bws": np.asarray([b for _, _, b in triples],
                                            np.int32)}
    for li, (idx, tab, _) in enumerate(triples):
        ref[f"idx_{li}"] = idx
        ref[f"table_{li}"] = tab
    for name, net in (("mixed", mixed), ("uniform", uniform),
                      ("per_layer", per_layer)):
        ref[f"out_{name}"] = np.asarray(net(codes), np.int32)
    return mixed, ref


def build_train() -> dict[str, np.ndarray]:
    """The training-flow arrays of ``model_a_train.npz``, nothing written."""
    import jax

    from repro.configs import fpga4hep
    from repro.core import logicnet as LN
    from repro.core.train import train_logicnet
    from repro.data import jet_substructure_data
    from repro_torch.core.logicnet import reference_to_arrays

    cfg = fpga4hep.model_a()
    x, y = jet_substructure_data(8000, seed=0)
    xt, yt, xv, yv = x[:7000], y[:7000], x[7000:], y[7000:]
    out = reference_to_arrays(LN.init(cfg, jax.random.PRNGKey(0),
                                      mask_seed=0), "init")
    res = train_logicnet(cfg, xt, yt, xv, yv, method="apriori",
                         steps=TRAIN_STEPS, batch=256, lr=1e-2, seed=0)
    out["losses"] = np.asarray(res.losses, np.float32)
    out.update(reference_to_arrays(res.model, "trained"))
    tables = LN.generate_tables(cfg, res.model)
    for i, tt in enumerate(tables):
        out[f"table_{i}"] = np.asarray(tt.table, np.int32)
        out[f"idx_{i}"] = np.asarray(tt.indices, np.int32)
    f_codes, t_codes = LN.verify_tables(cfg, res.model, tables,
                                        xv[:N_VERIFY])
    assert (np.asarray(f_codes) == np.asarray(t_codes)).all()
    out["verify_codes"] = np.asarray(f_codes, np.int32)
    long = train_logicnet(cfg, xt, yt, xv, yv, method="apriori",
                          steps=LONG_STEPS, batch=256, lr=1e-2, seed=0)
    out["accuracy_600"] = np.asarray(long.accuracy, np.float32)
    return out


def write(directory: str = FIXTURE_DIR) -> tuple[str, str, str]:
    os.makedirs(directory, exist_ok=True)
    mixed, ref = build()
    art = mixed.save(os.path.join(directory, ARTIFACT_NAME))
    ref_path = os.path.join(directory, REF_NAME)
    np.savez_compressed(ref_path, **ref)
    train_path = os.path.join(directory, TRAIN_NAME)
    np.savez_compressed(train_path, **build_train())
    return art, ref_path, train_path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=FIXTURE_DIR,
                    help="directory to write the three .npz files into")
    args = ap.parse_args()
    for path in write(args.out):
        print(f"{path}: {os.path.getsize(path)} B")


if __name__ == "__main__":
    main()
