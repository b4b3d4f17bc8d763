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
  (``compile_network(triples, fused=False)``) artifacts on those codes.

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


def write(directory: str = FIXTURE_DIR) -> tuple[str, str]:
    os.makedirs(directory, exist_ok=True)
    mixed, ref = build()
    art = mixed.save(os.path.join(directory, ARTIFACT_NAME))
    ref_path = os.path.join(directory, REF_NAME)
    np.savez_compressed(ref_path, **ref)
    return art, ref_path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=FIXTURE_DIR,
                    help="directory to write the two .npz files into")
    args = ap.parse_args()
    for path in write(args.out):
        print(f"{path}: {os.path.getsize(path)} B")


if __name__ == "__main__":
    main()
