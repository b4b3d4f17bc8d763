"""Run one cell of BENCHMARK.json once, on the machine this starts on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the numbers the output check
compared, each beside its limit, as the last lines of standard error, and
one JSON object as the last line of standard output.  Exits non-zero,
printing no result, where no CUDA device (or fewer than the cell asks
for) is visible, where the program is not beside the benchmark, or where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules whose presence means JAX or the JAX package was loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def finite_or_none(x):
    """Numbers of the line as JSON holds them: a value that is not finite
    (a check that found no answer) becomes null."""
    if isinstance(x, dict):
        return {k: finite_or_none(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite_or_none(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def loaded_forbidden() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the program (src/repro_torch) is not in {ROOT}")
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from portbench.harness import runner, spec
    from portbench.harness.log import note
    note(f"{args.workload} seed {args.seed}: torch {torch.__version__}")
    cell = spec.cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} devices; "
             f"{torch.cuda.device_count()} visible")
    torch.set_num_threads(2)
    line = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    found = loaded_forbidden()
    if found:
        fail(f"JAX or the JAX package was loaded: {found}")
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite_or_none(line)), flush=True)


if __name__ == "__main__":
    main()
