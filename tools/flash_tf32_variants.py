#!/usr/bin/env python3
"""Time design variants of the float32 tensor-core flash-attention kernel.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 tools/flash_tf32_variants.py [--out build/flash_tf32_variants.json]

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_tf32.cu``
with one design choice undone by its knobs (``-D FA_TF32_...``, listed at
the top of the source); all are compiled at once
(one ``nvcc`` each, ``-Xptxas -v`` for registers and spills) into their
own shared libraries under ``build/flash_tf32_variants/`` and called
through ``ctypes`` on the same seeded float32 inputs as the kernel's
wrapper calls it.  At (4, 16, 8, 2048, 128) causal (qwen3-1.7b's prefill,
the shape ``chip_smoke.py`` phase 10 times) each variant's CUDA-event time
is taken in turns with SDPA's memory-efficient backend on K and V expanded
to 16 heads (the first half of the variants forward, then backward, so
each is read twice), and its largest |variant - plain| over the float32
tolerance (atol 1e-5 + rtol 1e-5 |plain|), which must stay below 1 for
every variant that computes the function.  The "timing only" variants
compute something else on purpose (no splits, one product): they show
what the splits and the second and third products cost.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPE = (4, 16, 8, 2048, 128)
# name -> (what it undoes, the kernel's design knobs it sets (nvcc -D),
# computes the function)
VARIANTS = {
    "chosen": ("the kernel as committed", [], True),
    "small_rna": ("small rounded to TF32 (cvt.rna rule) before mma",
                  ["FA_TF32_SMALL_RNA=1"], True),
    "col_guard": ("P V's column n-tiles behind a branch on D",
                  ["FA_TF32_PV_BRANCH=1"], True),
    "s_guard": ("S's k8 steps behind a branch on D", ["FA_TF32_S_BRANCH=1"],
                True),
    "ex2_approx": ("ex2.approx.ftz for the exponentials, not exp2f",
                   ["FA_TF32_EX2_APPROX=1"], True),
    "bk32": ("32-key K / V tiles at D <= 128", ["FA_TF32_BK128=32"], True),
    "nw4": ("4 warps (64 query rows) a block at D <= 128",
            ["FA_TF32_NW128=4"], True),
    "all_undone": ("small_rna, col_guard and s_guard at once",
                   ["FA_TF32_SMALL_RNA=1", "FA_TF32_PV_BRANCH=1",
                    "FA_TF32_S_BRANCH=1"], True),
    "no_split": ("timing only: operands passed unsplit, three products",
                 ["FA_TF32_SPLIT=0"], False),
    "one_product": ("timing only: one TF32 product a product, no splits",
                    ["FA_TF32_SPLIT=0", "FA_TF32_PRODUCTS=1"], False),
}


def build_all(out_dir: Path) -> dict:
    from repro_torch.kernels import _build
    src = _build.CSRC / "flash_attention_tf32.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, knobs, _) in VARIANTS.items():
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             *(f"-D{k}" for k in knobs), "-I", str(_build.CSRC),
             "-o", str(out_dir / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        regs = [line.split(":")[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill stores" in line]
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")) \
            .flash_attention_tf32_forward
        fn.argtypes = list(_build._SIGNATURES["flash_attention_tf32_forward"])
        fn.restype = ctypes.c_int
        built[name] = (fn, regs)
    return built


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="write the readings as JSON here")
    args = parser.parse_args()

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import chip_smoke as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.lut_lookup import stream_of

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    built = build_all(ROOT / "build" / "flash_tf32_variants")
    dev = torch.device("cuda")
    b, hq, hkv, s, d = SHAPE
    q, k, v = C.flash_inputs(torch, dev, b, hq, hkv, s, d, "float32")
    ke, ve = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    want = FA.flash_attention_plain(q, k, v, causal=True)
    limit = C.mm_limit(torch, want, 1e-5, 1e-5, 0)

    def call(fn):
        out = torch.empty((b, s, hq, d), device=dev).transpose(1, 2)
        views = [FA._tma_view(t) for t in (q, k, v)]
        strides = [x for _, sts in views for x in sts] + \
            list(out.stride()[:3])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 (ctypes.c_longlong * 12)(*strides), b, hq, hkv, s, s, d, 1,
                 0, float(d ** -0.5), stream_of(dev))
        if err:
            raise SystemExit(f"launch failed: cudaError_t {err}")
        return out

    def efficient():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, ke, ve, is_causal=True)

    rows = {}
    for name, (fn, regs) in built.items():
        got = call(fn)
        torch.cuda.synchronize()
        ratio = float(((got - want).abs() / limit).max())
        if VARIANTS[name][2] and not ratio <= 1:
            raise SystemExit(f"variant {name}: {ratio} of the float32 limit")
        rows[name] = {"undoes": VARIANTS[name][0], "ptxas": regs,
                      "err_over_limit": ratio, "ms": [], "sdpa_ms": []}
    order = list(built) + list(reversed(built))
    for name in order:
        fn = built[name][0]
        rows[name]["sdpa_ms"].append(C.cuda_ms(efficient, 3, 5))
        rows[name]["ms"].append(C.cuda_ms(lambda: call(fn), 3, 5))
    for name, row in rows.items():
        row["ms_mean"] = statistics.mean(row["ms"])
        row["vs_sdpa"] = row["ms_mean"] / statistics.mean(row["sdpa_ms"])
        print(f"{name:15s} {row['ms_mean']:.4f} ms {row['ms']} "
              f"({row['vs_sdpa']:.3f}x SDPA memory-efficient "
              f"{row['sdpa_ms']}), |variant - plain| "
              f"{row['err_over_limit']:.3f} of the float32 limit; "
              f"{' | '.join(row['ptxas'])}; {row['undoes']}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": smi, "shape": SHAPE, "variants": rows}, indent=1))


if __name__ == "__main__":
    main()
