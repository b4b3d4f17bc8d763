#!/usr/bin/env python3
"""Read both ways a head-parallel SSM rank can reach its heads' pieces.

Run from the root of a checkout (CPU only: abstract, no card)::

    python3 tools/ssm_regroup_routes.py [--out build/ssm_regroup_routes.json]

The mesh rules split an SSM block's packed ``in_proj`` columns evenly
over ``model``, not at heads, so each rank regroups either the weight's
columns (then projects) or the projected activation (after projecting on
its even share); ``models.ssm.HeadPlan.regroups_weight`` picks the one
with fewer rows.  For mamba2-370m and zamba2-2.7b x train_4k and
decode_32k at 16x16, this runs ``launch.dryrun.run_cell`` (``fake``
ranks, ``meta`` tensors) with that rule replaced by each answer in turn,
and prints per device TFLOP, collective GB and all-to-all GB of each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("mamba2-370m", "train_4k"), ("mamba2-370m", "decode_32k"),
         ("zamba2-2.7b", "train_4k"), ("zamba2-2.7b", "decode_32k"))

# one process a route: each starts its own fake process group
CELL = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models import ssm
route, cells = sys.argv[1], json.loads(sys.argv[2])
ssm.HeadPlan.regroups_weight = staticmethod(lambda u: route == "weight")
args = dryrun.parse_args([])
out = []
for arch, shape in cells:
    rec = dryrun.run_cell(arch, shape, False, args)
    out.append({"arch": arch, "shape": shape, "route": route,
                "status": rec["status"], "tflop": rec["cost"]["flops"] / 1e12,
                "collective_gb": rec["collectives"]["total"] / 1e9,
                "all_to_all_gb": rec["collectives"].get("all-to-all", 0) / 1e9})
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the readings here")
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    rows = []
    for route in ("activation", "weight"):
        proc = subprocess.run(
            [sys.executable, "-c", CELL, route, json.dumps(CELLS)],
            cwd=ROOT, env=env, capture_output=True, text=True, check=False)
        if proc.returncode:
            sys.exit(f"route {route}: rc {proc.returncode}\n"
                     f"{proc.stderr[-3000:]}")
        rows += json.loads(proc.stdout.strip().splitlines()[-1])
    for r in rows:
        print(f"{r['arch']} x {r['shape']} x 16x16, {r['route']}: "
              f"{r['status']}, {r['tflop']:.4g} TFLOP, "
              f"{r['collective_gb']:.4g} collective GB "
              f"({r['all_to_all_gb']:.4g} all-to-all) a device")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
