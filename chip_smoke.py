#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (one ``nvcc`` per source, all at once), serves fpga4hep model A
(16 -> 64 -> 64 -> 64, fan-in 3, 3-bit codes) from the committed fixture
(``tests/fixtures/torch_port``: the reference's level-3 artifact, the raw
truth tables and the reference's outputs on 4096 seeded input rows), then
trains model A at full width, turns it into truth tables and serves them.
Phases, each of which must pass:

1. **kernels** — each of the three LUT kernels (mixed fused, uniform fused,
   per-layer) at model A's widths, at batches 0, 1, 16, 1000 and 4096,
   called directly and through the engine: bit-exact against its plain
   PyTorch version on the card and against the reference's outputs.
2. **serving** — for each layout, every launch counter set to 0, then
   ``run_closed_loop`` (4 clients x 4 requests of 1-8 rows, 3-bit codes)
   through ``ServingTier``: outputs bit-exact with ``net(codes)``, zero
   kernel builds and zero compiler runs after warmup, and the layout's
   kernel launched.  Its launch count is what the ``kernels`` line reports.
3. **times** — median CUDA-event time per forward of each kernel and of its
   plain version at batch 16 (the serving bucket) and 4096, calls issued
   back to back from Python (so host launch gaps count), and the device
   time per forward that ``torch.profiler`` records for the kernels alone
   (``device_ms``), beside the bound: the larger of the bytes the forward
   must move (codes in, codes out, slabs once) over 3.35 TB/s and its
   int32 operations over 33.5 TOP/s (half the 67 TFLOP/s fp32 CUDA-core
   rate: Hopper has 64 INT32 lanes per SM against 128 FP32).  No single PyTorch call computes
   these functions, so ``library_ms`` is null.
4. **masked matmul** — ``masked_matmul_forward`` against its plain version
   on the card: at model A's training shapes, at a ragged (130, 700, 50)
   that crosses every tile edge and at (4096, 4096, 4096), in float32
   (atol 1e-4, rtol 1e-5: another summation order) and bfloat16 (the
   reference's atol 5e-2, rtol 1e-3, plus exactly one bfloat16 step of
   the plain output: both round a float32 sum taken in another order);
   masked-out weights of 1e9 must vanish exactly;
   ``MaskedMatmulFn``'s gradients against autograd of the plain version.
5. **training** — (a) the reference's init of model A carried in from
   ``model_a_train.npz`` and trained 20 steps on the card: losses within
   rtol 1e-3 of the reference's; (b) the reference's trained weights
   carried in: truth tables generated on the card equal the reference's,
   except at entries whose float64 value lies within 1e-5 steps of a
   rounding half-way point (counted and printed); then, with every launch
   counter at 0 (the main path of this slice): (c) 600 steps from the
   port's own seeded init, 5 masked-matmul launches a step (3 forward,
   2 input gradients), held-out accuracy within 2 points of the
   reference's 600-step run; (d) ``verify_tables`` exact through the
   masked-matmul kernel (float path) against the per-layer and the fused
   uniform LUT kernels (table path); (e) the tables compiled and served
   through ``ServingTier`` bit-exact, with zero builds and compiler runs
   after warmup.
6. **masked-matmul times** — event and profiler device time at model A's
   widest layer (256 x 64 x 64, float32) and at 4096^3 (float32, bfloat16),
   beside the plain version, ``torch.addmm(b, x, w * mask)`` with TF32 off
   (``library_ms``, timed only as a yardstick) and the bound: the larger of
   the bytes moved (x, w, mask, b read once, out written once) over
   3.35 TB/s and the multiply-adds the mask keeps (2 M nnz(mask)) over
   67 TFLOP/s (float32, CUDA cores) or 989 TFLOP/s (bfloat16); and 50
   profiled training steps: host-clock time against device time per step.

The next-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout,
it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port"
BATCHES = (0, 1, 16, 1000, 4096)
TIME_BATCHES = (16, 4096)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
SOURCE = "src/repro_torch/kernels/csrc/lut_kernels.cu"
MM_SOURCE = "src/repro_torch/kernels/csrc/masked_matmul.cu"
# (atol, rtol, steps): float32, another summation order.  bfloat16: the
# reference's atol 5e-2 / rtol 1e-3 plus exactly one bfloat16 step (unit in
# the last place) of the plain output: kernel and plain version sum in
# float32 in different orders and round to bfloat16 independently, so an
# output near a rounding point may land one step apart (0.0625 at |y| in
# [8, 16))
MM_TOL = {"float32": (1e-4, 1e-5, 0), "bfloat16": (5e-2, 1e-3, 1)}
TRAIN_STEPS = 600
ACCURACY_POINTS = 0.02
BOUNDARY_STEPS = 1e-5


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(fn, iters: int, reps: int = 7) -> float:
    """Median over ``reps`` of CUDA-event time per call over ``iters``."""
    import torch
    for _ in range(3):
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


def device_ms(fn, iters: int) -> float | None:
    """Device time per call of every kernel ``fn`` launches, from the
    profiler's CUDA activity (None when the profiler records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def boundary_steps(cfg, model) -> list:
    """Per sparse layer, (O, E): how far each truth-table entry's float64
    value lies from a rounding half-way point of its output quantizer, in
    quantizer steps (0.5 = on a code)."""
    import numpy as np

    from repro_torch.core.sparsity import mask_to_indices
    cfgs = cfg.layer_cfgs()
    out = []
    for i, layer in enumerate(model[:len(cfgs) - 1]):
        c, q = cfgs[i], cfgs[i + 1].in_quant
        p, st = layer["params"], layer["bn_state"]
        idx = mask_to_indices(layer["mask"])
        w = (p["w"] * layer["mask"]).astype(np.float64)
        wj = np.take_along_axis(w, idx.T, axis=0).T           # (O, fi)
        scale = (p["bn"]["scale"].astype(np.float64)
                 / np.sqrt(st["var"].astype(np.float64) + 1e-5))
        bias = p["bn"]["bias"] - st["mean"].astype(np.float64) * scale
        ids = np.arange(2 ** (c.fan_in * c.bw_in))
        digits = (ids[:, None] >> (c.bw_in * np.arange(c.fan_in))) & (
            2 ** c.bw_in - 1)
        vals = digits * np.float64(np.float32(c.in_quant.step))
        y = (vals @ wj.T + p["b"].astype(np.float64)) * scale + bias
        u = np.clip(y, 0.0, q.max_val) / np.float64(np.float32(q.step))
        out.append(np.abs(u - np.floor(u) - 0.5).T)
    return out


def mm_limit(torch, want, atol, rtol, steps):
    """atol + rtol |want| + ``steps`` units in the last place of ``want``'s
    dtype at |want|, elementwise, in float32."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.full_like(w, torch.finfo(want.dtype).eps / 2), e)
    return atol + rtol * w.abs() + steps * ulp


def mm_inputs(torch, dev, m, k, n, dtype, mask=None, seed=0):
    """Seeded (x, w, mask, b) on the card in ``dtype``; ``mask`` defaults to
    a random half of the weights."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev)
    if mask is None:
        mask = torch.rand((k, n), generator=g, device=dev) < 0.5
    b = torch.randn((n,), generator=g, device=dev)
    dt = getattr(torch, dtype)
    return [t.to(device=dev, dtype=dt) for t in (x, w, mask, b)]


def model_a_masks():
    """The a-priori fan-in masks of model A's layers 0 and 1 (16 -> 64 and
    64 -> 64, fan-in 3), as the training path draws them."""
    from repro_torch.core.sparsity import apriori_mask
    return apriori_mask(0, 16, 64, 3), apriori_mask(1, 64, 64, 3)


def masked_matmul_phase(torch, dev) -> dict:
    """Phase 4: the masked-matmul kernel against its plain version."""
    from repro_torch.kernels.masked_matmul import (MaskedMatmulFn,
                                                   masked_matmul,
                                                   masked_matmul_plain)
    m0, m1 = model_a_masks()
    cases = [(256, 16, 64, "float32", m0), (256, 64, 64, "float32", m1),
             (130, 700, 50, "float32", None), (130, 700, 50, "bfloat16", None),
             (4096, 4096, 4096, "float32", None),
             (4096, 4096, 4096, "bfloat16", None)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for i, (m, k, n, dtype, mask) in enumerate(cases):
        x, w, mk, b = mm_inputs(torch, dev, m, k, n, dtype, mask, seed=i)
        atol, rtol, steps = MM_TOL[dtype]
        for bias in (b, None):
            before = masked_matmul.launches
            got = masked_matmul(x, w, mk, bias)
            want = masked_matmul_plain(x, w, mk, bias)
            torch.cuda.synchronize()
            if masked_matmul.launches != before + 1:
                fail(f"masked_matmul {m}x{k}x{n} {dtype}: kernel not launched")
            if got.dtype != x.dtype or got.shape != (m, n):
                fail(f"masked_matmul {m}x{k}x{n} {dtype}: gave {got.dtype} "
                     f"{tuple(got.shape)}")
            diff = (got.float() - want.float()).abs()
            if bool((diff > mm_limit(torch, want, atol, rtol, steps)).any()):
                fail(f"masked_matmul {m}x{k}x{n} {dtype}: max |kernel - "
                     f"plain| {float(diff.max())} beyond atol {atol} rtol "
                     f"{rtol} + {steps} {dtype} step")
            errs[dtype] = max(errs[dtype], float(diff.max()))
        log(f"phase 4 masked_matmul {m}x{k}x{n} {dtype}: max |kernel - plain| "
            f"{errs[dtype]:.3g} (atol {atol}, rtol {rtol}, + {steps} step)")
    x = torch.ones((4, 8), device=dev)
    w = torch.full((8, 4), 1e9, device=dev)
    mask = torch.zeros((8, 4), device=dev)
    mask[0] = 1.0
    if not bool((masked_matmul(x, w, mask) == 1e9).all()):
        fail("masked_matmul: masked-out weights of 1e9 leaked into the sum")
    x, w, mask, b = mm_inputs(torch, dev, 256, 64, 64, "float32", m1, seed=9)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    plain = [t.clone().requires_grad_() for t in (x, w, b)]
    before = masked_matmul.launches
    MaskedMatmulFn.apply(leaves[0], leaves[1], mask,
                         leaves[2]).square().sum().backward()
    masked_matmul_plain(plain[0], plain[1], mask,
                        plain[2]).square().sum().backward()
    torch.cuda.synchronize()
    if masked_matmul.launches != before + 2:
        fail("MaskedMatmulFn: expected one forward and one dx launch")
    for name, a, p in zip(("dx", "dw", "db"), leaves, plain):
        diff = (a.grad - p.grad).abs()
        if bool((diff > 1e-4 + 1e-5 * p.grad.abs()).any()):
            fail(f"MaskedMatmulFn {name}: max |kernel - plain| "
                 f"{float(diff.max())}")
        errs["float32"] = max(errs["float32"], float(diff.max()))
    log("phase 4 masked_matmul: mask exact; MaskedMatmulFn dx, dw, db "
        "within atol 1e-4 of autograd of the plain version")
    return {"max_abs_err": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"]}


def training_phase(torch, dev, kernels) -> dict:
    """Phase 5: train model A on the card, make tables, verify, serve."""
    import numpy as np

    from repro_torch import engine, serve
    from repro_torch.configs import fpga4hep
    from repro_torch.core import logicnet as LN
    from repro_torch.core.train import auc_roc_ovr, train_logicnet
    from repro_torch.data import jet_substructure_data
    from repro_torch.kernels.lut_lookup import lut_lookup
    from repro_torch.kernels.lut_network import lut_network
    from repro_torch.kernels.masked_matmul import masked_matmul

    with np.load(FIXTURE / "model_a_train.npz") as z:
        fx = {k: z[k] for k in z.files}
    cfg = fpga4hep.model_a()
    x, y = jet_substructure_data(8000, seed=0)
    xt, yt, xv, yv = x[:7000], y[:7000], x[7000:], y[7000:]

    # (a) the reference's init, 20 steps
    ref_losses = fx["losses"].astype(np.float64)
    res = train_logicnet(cfg, xt, yt, xv, yv, steps=len(ref_losses), seed=0,
                         device=dev, net=LN.from_reference(
                             cfg, LN.reference_from_arrays(fx, "init"), device=dev))
    rel = float(np.max(np.abs(np.asarray(res.losses) - ref_losses)
                       / np.abs(ref_losses)))
    if not rel <= 1e-3:
        fail(f"20-step losses differ from the reference's by rtol {rel}")
    log(f"phase 5a {len(ref_losses)} steps from the reference's init: losses "
        f"within rtol {rel:.3g} of the reference's (limit 1e-3); first "
        f"{res.losses[0]:.6f} last {res.losses[-1]:.6f}")

    # (b) the reference's trained weights -> tables on the card
    trained = LN.reference_from_arrays(fx, "trained")
    tables = LN.generate_tables(LN.from_reference(cfg, trained, device=dev))
    dist = boundary_steps(cfg, trained)
    near = int(sum(int((d < BOUNDARY_STEPS).sum()) for d in dist))
    mismatched = 0
    for i, tt in enumerate(tables):
        if not np.array_equal(tt.indices, fx[f"idx_{i}"]):
            fail(f"layer {i}: fan-in indices differ from the reference's")
        ne = tt.table != fx[f"table_{i}"]
        if bool((ne & (dist[i] >= BOUNDARY_STEPS)).any()):
            fail(f"layer {i}: {int(ne.sum())} table entries differ from the "
                 f"reference's away from a rounding half-way point")
        mismatched += int(ne.sum())
    log(f"phase 5b tables from the reference's trained weights: "
        f"{sum(t.table.size for t in tables)} entries, {mismatched} differ "
        f"from the reference's; {near} entries lie within {BOUNDARY_STEPS} "
        f"steps of a half-way point")

    # (c)-(e): the main path of this slice, every launch counter at 0
    for k in kernels.values():
        k["wrapper"].launches = 0
    masked_matmul.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_logicnet(cfg, xt, yt, xv, yv, steps=TRAIN_STEPS, seed=0,
                         device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = masked_matmul.launches
    # 3 forward + 2 input gradients a step, then the 3 sparse layers of
    # the held-out accuracy forward
    if train_launches != 5 * TRAIN_STEPS + 3:
        fail(f"training launched masked_matmul {train_launches} times; "
             f"expected {5 * TRAIN_STEPS + 3}")
    if not np.isfinite(res.losses).all():
        fail("training produced a non-finite loss")
    ref_acc = float(fx["accuracy_600"])
    if abs(res.accuracy - ref_acc) > ACCURACY_POINTS:
        fail(f"accuracy {res.accuracy:.4f} after {TRAIN_STEPS} steps is more "
             f"than 2 points from the reference's {ref_acc:.4f}")
    aucs = auc_roc_ovr(res.model, xv, yv)
    log(f"phase 5c {TRAIN_STEPS} steps from the port's own init: "
        f"{train_s / TRAIN_STEPS * 1e3:.3f} ms/step (host clock, synchronised, "
        f"held-out accuracy included), masked_matmul "
        f"{train_launches} launches ({train_launches / TRAIN_STEPS:.3f}/step); "
        f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; accuracy "
        f"{res.accuracy:.4f} vs the reference's {ref_acc:.4f}; AUC "
        + " ".join(f"{a * 100:.2f}" for a in aucs.values()))

    tables = LN.generate_tables(res.model)
    for fused, wrapper in ((False, lut_lookup), (True, lut_network)):
        before = wrapper.launches
        f_codes, t_codes = LN.verify_tables(res.model, tables, xv[:200],
                                            fused=fused)
        torch.cuda.synchronize()
        if wrapper.launches == before:
            fail(f"verify_tables fused={fused}: LUT kernel not launched")
        if f_codes.device.type != dev.type or not torch.equal(f_codes, t_codes):
            bad = (f_codes != t_codes).any(1).nonzero().flatten().tolist()
            fail(f"verify_tables fused={fused}: not exact on rows {bad}")
    log("phase 5d verify_tables on 200 held-out rows: EXACT, float path "
        "through masked_matmul_forward, table path through "
        "lut_layer_forward and lut_uniform_forward")

    net = engine.compile_network(tables, in_features=cfg.in_features,
                                 device=dev)
    if net.layout != "uniform":
        fail(f"the trained tables compiled to {net.layout}, not uniform")
    rep = serve.run_closed_loop(net, n_clients=4, n_per_client=4, rows_min=1,
                                rows_max=8, bw=3, seed=0)
    st = rep.stats
    if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
        fail(f"serving the trained model: compile-once contract broken: {st}")
    if not kernels["uniform"]["wrapper"].launches:
        fail("serving the trained model launched no uniform kernel")
    log(f"phase 5e trained model served: {rep.n_requests} requests "
        f"({rep.rows} rows) bit-exact, p50={rep.p50_ms:.3f} ms "
        f"p99={rep.p99_ms:.3f} ms, retraces={st['retraces_after_warmup']} "
        f"compiler_runs={st['compiler_runs_after_warmup']}")
    launches = masked_matmul.launches
    log(f"phase 5 main path launches: masked_matmul_forward {launches}, "
        f"lut_layer_forward {lut_lookup.launches}, lut_uniform_forward "
        f"{lut_network.launches}")
    return {"launches": launches, "loss_rtol_20": rel,
            "table_mismatches": mismatched, "boundary_entries": near,
            "train_step_ms": train_s / TRAIN_STEPS * 1e3,
            "launches_per_step": (train_launches - 3) / TRAIN_STEPS,
            "accuracy": res.accuracy}


def masked_matmul_times(torch, dev, mm: dict) -> dict:
    """Phase 6: masked-matmul times beside the plain version, the library
    call and the bound; returns the kernel's record."""
    from repro_torch.kernels.masked_matmul import (masked_matmul,
                                                   masked_matmul_plain)
    rec = {"name": "masked_matmul_forward", "route": "cuda",
           "source": MM_SOURCE,
           "replaces": "src/repro/kernels/masked_matmul.py:23", **mm,
           "shape": [256, 64, 64]}
    cases = (("", 256, 64, 64, "float32", model_a_masks()[1], 200),
             ("_4096_f32", 4096, 4096, 4096, "float32", None, 3),
             ("_4096_bf16", 4096, 4096, 4096, "bfloat16", None, 3))
    for suffix, m, k, n, dtype, mask, iters in cases:
        x, w, mk, b = mm_inputs(torch, dev, m, k, n, dtype, mask)
        ms = cuda_ms(lambda: masked_matmul(x, w, mk, b), iters)
        plain_ms = cuda_ms(lambda: masked_matmul_plain(x, w, mk, b), iters)
        library_ms = cuda_ms(lambda: torch.addmm(b, x, w * mk), iters)
        dev_ms = device_ms(lambda: masked_matmul(x, w, mk, b), iters)
        moved = nbytes(x, w, mk, b) + m * n * x.element_size()
        ops = 2 * m * int(mk.count_nonzero())
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FLOPS_PER_S[dtype] * 1e3
        rec.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                    f"device_ms{suffix}": dev_ms,
                    f"library_ms{suffix}": library_ms,
                    f"bound_ms{suffix}": max(bytes_ms, ops_ms),
                    f"bound_by{suffix}": ("bytes" if bytes_ms >= ops_ms
                                          else "operations")})
        log(f"phase 6 masked_matmul_forward {m}x{k}x{n} {dtype}: {ms:.5f} "
            f"ms/call, device {dev_ms} ms, plain {plain_ms:.5f} ms, addmm "
            f"{library_ms:.5f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
            f"({moved} B, {ops} flop)")
    return rec


def training_profile(torch, dev, steps: int = 50) -> dict:
    """Where a training step's time goes: host-clock time per step against
    the device time ``torch.profiler`` records per step, all kernels and
    the masked matmul's alone (model A, batch 256, from the port's init)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import fpga4hep
    from repro_torch.core.train import train_logicnet
    from repro_torch.data import jet_substructure_data
    x, y = jet_substructure_data(8000, seed=0)
    args = (fpga4hep.model_a(), x[:7000], y[:7000], x[7000:], y[7000:])
    train_logicnet(*args, steps=5, seed=0, device=dev)       # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_logicnet(*args, steps=steps, seed=0, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    events = prof.key_averages()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    mm = sum(getattr(e, "self_device_time_total", 0.0) for e in events
             if "masked_matmul_kernel" in e.key)
    if not total:
        fail("the profiler recorded no device time for training steps")
    out = {"train_wall_ms": wall_ms,
           "train_device_ms": total / steps / 1e3,
           "train_mm_device_ms": mm / steps / 1e3}
    out["train_idle_share"] = 1 - out["train_device_ms"] / wall_ms
    if out["train_idle_share"] < 0:
        fail(f"the profiler's device time per step "
             f"({out['train_device_ms']} ms) exceeds the host-clock time "
             f"({wall_ms} ms): it counts some kernel time twice")
    log(f"phase 6 training step ({steps} steps, profiled): {wall_ms:.3f} ms "
        f"host clock, {out['train_device_ms']:.4f} ms device "
        f"(masked_matmul_forward {out['train_mm_device_ms']:.4f} ms), "
        f"device idle {out['train_idle_share'] * 100:.1f} %")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir() or not FIXTURE.is_dir():
        fail(f"{ROOT} is not a checkout of the repo (no src/repro_torch or "
             f"tests/fixtures/torch_port)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import engine, serve
    from repro_torch.kernels import _build
    from repro_torch.kernels.lut_lookup import lut_lookup, lut_lookup_plain
    from repro_torch.kernels.lut_network import (lut_network,
                                                 lut_network_mixed,
                                                 lut_network_mixed_plain,
                                                 lut_network_plain)

    dev = torch.device("cuda")
    # float32 products stay float32 everywhere (library yardstick included)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"kernel library built and loaded in "
        f"{time.perf_counter() - t0:.2f} s: {_build.library_path().name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    ref = np.load(FIXTURE / "model_a_ref.npz")
    codes_all = torch.from_numpy(ref["codes"]).to(dev)
    triples = [(ref[f"idx_{i}"], ref[f"table_{i}"], int(ref["bws"][i]))
               for i in range(len(ref["bws"]))]
    nets = {
        "mixed": engine.load(str(FIXTURE / "model_a_l3.npz")),
        "uniform": engine.compile_network(triples, block_b=16),
        "per_layer": engine.compile_network(triples, fused=False,
                                            block_b=16),
    }
    for layout, net in nets.items():
        if net.layout != layout or net.device.type != "cuda":
            fail(f"{layout}: engine chose {net.layout} on {net.device}")

    def per_layer_kernel(c):
        for idx, tab, bw in nets["per_layer"].layers:
            c = lut_lookup(c, idx, tab, bw)
        return c

    def per_layer_plain(c):
        for idx, tab, bw in nets["per_layer"].layers:
            c = lut_lookup_plain(c, idx, tab, bw)
        return c

    s_mixed, s_uniform = nets["mixed"].slabs, nets["uniform"].slabs
    kernels = {
        "mixed": dict(
            name="lut_mixed_forward", wrapper=lut_network_mixed,
            kernel=lambda c: lut_network_mixed(c, s_mixed),
            plain=lambda c: lut_network_mixed_plain(c, s_mixed),
            replaces="src/repro/kernels/lut_network.py:541",
            slab_bytes=nbytes(s_mixed.idx_slab, s_mixed.shift_slab,
                              s_mixed.width_slab, s_mixed.table_slab,
                              s_mixed.row_meta, s_mixed.layer_meta,
                              s_mixed.perm),
            # per neuron element: mask, shift, add; per code: bound, address
            ops_per_row=sum(m.n_out * (3 * m.fan_in + 2)
                            for m in s_mixed.meta)),
        "uniform": dict(
            name="lut_uniform_forward", wrapper=lut_network,
            kernel=lambda c: lut_network(c, s_uniform),
            plain=lambda c: lut_network_plain(c, s_uniform),
            replaces="src/repro/kernels/lut_network.py:270",
            slab_bytes=nbytes(s_uniform.idx_slab, s_uniform.table_slab,
                              s_uniform.layer_meta, s_uniform.perm),
            ops_per_row=sum(m.n_out * (2 * m.fan_in + 2)
                            for m in s_uniform.meta)),
        "per_layer": dict(
            name="lut_layer_forward", wrapper=lut_lookup,
            kernel=per_layer_kernel, plain=per_layer_plain,
            replaces="src/repro/kernels/lut_lookup.py:86",
            slab_bytes=sum(nbytes(i, t)
                           for i, t, _ in nets["per_layer"].layers),
            ops_per_row=sum(i.shape[0] * (2 * i.shape[1] + 2)
                            for i, _, _ in nets["per_layer"].layers)),
    }
    n_in, n_out = codes_all.shape[1], nets["mixed"].n_out

    # -- phase 1: every kernel against its plain version and the reference
    for layout, k in kernels.items():
        want_all = ref[f"out_{layout}"]
        k["max_abs_err"] = 0
        for b in BATCHES:
            codes = codes_all[:b].contiguous()
            before = k["wrapper"].launches
            got = k["kernel"](codes)
            via_engine = nets[layout](codes)
            plain = k["plain"](codes)
            torch.cuda.synchronize()
            launched = k["wrapper"].launches - before
            if b and not launched:
                fail(f"{k['name']} batch {b}: kernel not launched")
            if b == 0 and launched:
                fail(f"{k['name']} batch 0 launched a kernel")
            err = int((got.long() - plain.long()).abs().max()) if b else 0
            k["max_abs_err"] = max(k["max_abs_err"], err)
            want = torch.from_numpy(want_all[:b]).to(dev)
            for what, out in (("kernel", got), ("engine", via_engine),
                              ("plain", plain)):
                if out.shape != (b, n_out) or out.dtype != torch.int32:
                    fail(f"{k['name']} batch {b}: {what} gave "
                         f"{out.dtype} {tuple(out.shape)}")
                if not torch.equal(out, want):
                    fail(f"{k['name']} batch {b}: {what} output differs "
                         f"from the reference's")
        log(f"phase 1 {k['name']}: bit-exact vs plain and reference at "
            f"batches {BATCHES}")

    # -- phase 2: the main path, serving each layout through the tier
    for layout, k in kernels.items():
        for other in kernels.values():
            other["wrapper"].launches = 0
        rep = serve.run_closed_loop(nets[layout], n_clients=4,
                                    n_per_client=4, rows_min=1, rows_max=8,
                                    bw=3, seed=0)
        k["launches"] = k["wrapper"].launches
        st = rep.stats
        if not k["launches"]:
            fail(f"serving {layout}: {k['name']} was never launched")
        if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
            fail(f"serving {layout}: compile-once contract broken: {st}")
        legs = " ".join(f"{leg}={rep.breakdown[leg]['mean_ms']:.3f}"
                        for leg in ("queue_wait", "assembly", "device"))
        log(f"phase 2 serving {layout}: {rep.n_requests} requests "
            f"({rep.rows} rows) bit-exact, p50={rep.p50_ms:.3f} ms "
            f"p99={rep.p99_ms:.3f} ms, {rep.rows_per_sec:.0f} rows/s, "
            f"{st['batches']} batches (flushes {st['flush_causes']}), "
            f"mean legs ms: {legs}; {k['name']} launches={k['launches']}, "
            f"retraces={st['retraces_after_warmup']} "
            f"compiler_runs={st['compiler_runs_after_warmup']}")

    # -- phase 3: times beside the bound
    records = []
    for layout, k in kernels.items():
        rec = {"name": k["name"], "route": "cuda", "source": SOURCE,
               "replaces": k["replaces"], "launches": k["launches"],
               "max_abs_err": k["max_abs_err"]}
        for b in TIME_BATCHES:
            codes = codes_all[:b].contiguous()
            iters = 200 if b <= 16 else 50
            ms = cuda_ms(lambda: k["kernel"](codes), iters)
            plain_ms = cuda_ms(lambda: k["plain"](codes), iters)
            dev_ms = device_ms(lambda: k["kernel"](codes), iters)
            moved = b * (n_in + n_out) * 4 + k["slab_bytes"]
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = b * k["ops_per_row"] / INT32_OPS_PER_S * 1e3
            suffix = "" if b == TIME_BATCHES[0] else f"_b{b}"
            rec.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                        f"device_ms{suffix}": dev_ms,
                        f"bound_ms{suffix}": max(bytes_ms, ops_ms),
                        f"bound_by{suffix}": ("bytes" if bytes_ms >= ops_ms
                                              else "operations")})
            log(f"phase 3 {k['name']} batch {b}: {ms:.5f} ms/forward, "
                f"device {dev_ms} ms, plain {plain_ms:.5f} ms, bound "
                f"{max(bytes_ms, ops_ms):.6f} ms ({moved} B)")
        rec["library_ms"] = None
        rec["batch"] = TIME_BATCHES[0]
        records.append(rec)

    mm = masked_matmul_phase(torch, dev)
    mm.update(training_phase(torch, dev, kernels))
    records.append(masked_matmul_times(torch, dev, mm))
    records[-1].update(training_profile(torch, dev))

    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
