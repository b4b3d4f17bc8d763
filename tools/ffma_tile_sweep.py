#!/usr/bin/env python3
"""Time tile configurations of the float32 masked-matmul kernel on the card.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 tools/ffma_tile_sweep.py

It compiles ``src/repro_torch/kernels/csrc/masked_matmul_ffma.cu`` once
more with every ``Tile<BM, BN, BK, THM, THN, blocks per SM>`` listed in
``LARGE`` and ``SMALL`` instantiated (into ``build/ffma_tile_sweep/``),
prints each one's registers and spills as ``ptxas`` reports them, checks
each against ``masked_matmul_forward`` (the first SIMT design) bit for bit,
and times it: CUDA-event time at 4096^3 with a half mask beside
``torch.addmm`` (TF32 off), and ``torch.profiler`` device time at model A's
256 x 64 x 64 and 256 x 16 x 64.  The kernel's own tiles are the first
entry of each list.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ffma_tile_sweep"
# (BM, BN, BK, THM, THN, blocks per SM); each holds (BM / THM) x (BN / THN)
# outputs a thread.  Static shared memory, 8 BK (BM + BN + 8) bytes, must
# stay within 48 KB.
LARGE = [(128, 256, 8, 16, 16, 1), (128, 128, 16, 16, 16, 2),
         (128, 128, 16, 16, 16, 1), (128, 128, 8, 16, 16, 2),
         (128, 128, 16, 16, 8, 2), (128, 128, 8, 16, 8, 2),
         (256, 128, 8, 16, 16, 1)]
SMALL = [(32, 32, 64, 8, 8, 1), (32, 32, 32, 8, 8, 1), (32, 32, 16, 8, 8, 1),
         (64, 32, 32, 16, 8, 1), (32, 64, 32, 8, 8, 1)]


def source(tiles) -> str:
    cases = "\n".join(
        f"    case {i}: launch<Tile<{', '.join(map(str, t))}>>(X, W, M, B, m, "
        f"n, k, tr != 0, O, s); break;" for i, t in enumerate(tiles))
    return f'''#include "{ROOT}/src/repro_torch/kernels/csrc/masked_matmul_ffma.cu"
extern "C" int sweep_launch(int v, const void* x, const void* w,
                            const void* mask, const void* b, int m, int n,
                            int k, int tr, void* out, void* stream) {{
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const float*>(x);
  auto W = static_cast<const float*>(w);
  auto M = static_cast<const float*>(mask);
  auto B = static_cast<const float*>(b);
  auto O = static_cast<float*>(out);
  switch (v) {{
{cases}
    default: return static_cast<int>(cudaErrorInvalidValue);
  }}
  return static_cast<int>(cudaGetLastError());
}}
'''


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("tools/ffma_tile_sweep.py needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels import masked_matmul as MM

    tiles = LARGE + SMALL
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sweep.cu").write_text(source(tiles))
    lib_path = OUT / "libsweep.so"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-o", str(lib_path), str(OUT / "sweep.cu")],
        capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode:
        sys.exit(f"nvcc failed:\n{log}")
    # ptxas names each kernel by its Tile<...> and transposed flag (Lb0,
    # Lb1); keep the non-transposed instantiation's registers and spills
    usage = {}
    for name, spills, regs in re.findall(
            r"TileI((?:Li\d+E)+)E*Lb0[^\n]*\n[^\n]*?(\d+) bytes spill "
            r"stores[^\n]*\n[^\n]*?Used (\d+) registers", log):
        usage[tuple(int(v) for v in re.findall(r"\d+", name))] = (
            int(regs), int(spills))
    lib = ctypes.CDLL(str(lib_path))
    lib.sweep_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    _build.library()             # the first design, for the bit check

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)

    def inputs(m, k, n):
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((m, k), generator=g, device=dev)
        w = torch.randn((k, n), generator=g, device=dev)
        mk = (torch.rand((k, n), generator=g, device=dev) < 0.5).float()
        return x, w, mk, torch.randn((n,), generator=g, device=dev)

    def run(v, x, w, mk, b, out):
        err = lib.sweep_launch(v, x.data_ptr(), w.data_ptr(), mk.data_ptr(),
                               b.data_ptr(), x.shape[0], out.shape[1],
                               x.shape[1], 0, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"tile {tiles[v]}: cudaError_t {err}")

    def event_ms(fn, iters=5, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
        return statistics.median(times)

    def device_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        return sum(e.self_device_time_total for e in evs) / max(
            sum(e.count for e in evs), 1) / 1e3

    for shape, group in (((4096, 4096, 4096), LARGE),
                         ((256, 64, 64), SMALL), ((256, 16, 64), SMALL)):
        x, w, mk, b = inputs(*shape)
        want = torch.empty((shape[0], shape[2]), device=dev)
        MM._launch_simt(x, w, mk, b, want)
        big = shape[0] == 4096

        def addmm():
            return torch.addmm(b, x, w * mk)

        if big:
            print(f"{shape}: addmm {event_ms(addmm):.4f} ms")
        for t in group:
            v = tiles.index(t)
            out = torch.empty_like(want)
            run(v, x, w, mk, b, out)
            same = torch.equal(out.view(torch.int32), want.view(torch.int32))
            t_ms = (event_ms(lambda: run(v, x, w, mk, b, out)) if big
                    else device_ms(lambda: run(v, x, w, mk, b, out)))
            regs, spills = usage.get(t, (None, None))
            print(f"{shape} Tile{t}: {'event' if big else 'device'} "
                  f"{t_ms:.5f} ms, registers {regs}, spill stores {spills} B, "
                  f"bit for bit masked_matmul_forward: {same}")
            if not same:
                sys.exit(f"tile {t} differs from masked_matmul_forward")
        if big:
            print(f"{shape}: addmm {event_ms(addmm):.4f} ms")


if __name__ == "__main__":
    main()
