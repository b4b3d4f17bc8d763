#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (one ``nvcc`` per source, all at once), times the port's
truth-table compiler (``repro_torch.compile.optimize``, host numpy) on
models A and D at levels 0-4 (printed as host time, on a line before the
kernels line), compiles and serves fpga4hep model A (16 -> 64 -> 64 ->
64, fan-in 3, 3-bit codes) from the committed fixture's raw truth tables
(``tests/fixtures/torch_port``: those tables, the reference's level-3
artifact and the reference's outputs on 4096 seeded input rows) and
fpga4hep model D (Table 6.1: 16 -> 64 -> 32 -> 32 at fan-in 5 and a
5-neuron head at fan-in 6, 2-bit codes, full widths; ``model_d_ref.npz``:
the reference's raw tables and outputs).  Model A at level 3, compiled by
the port, must equal the reference's artifact (slabs, layer meta,
``out_perm``, plan but its budget, stats but their timings); model D at
level 3 (100 neurons, 77 492 bytes of mixed slabs) must take the mixed
layout and the ``smem`` route by itself, while its raw uniform slabs
(547 960 bytes) exceed the shared-memory budget, so that the engine sends
the raw tables to the per-layer kernel by itself (the phase fails
otherwise); ``compile_runs()`` must rise by exactly the two level-3
builds.  Then it trains model A at full width, turns it into truth
tables, compiles, verifies and serves them.  Phases, each of which must
pass:

1. **kernels** — each of the three LUT kernels (mixed fused, uniform fused,
   per-layer) at model A's widths (the mixed one on the port's level-3
   compile and on the loaded reference artifact), the mixed kernel on
   model D at level 3 (fan-in 5 and 6, 2-bit codes, a 4-bit head; held to
   the raw tables' outputs) and the per-layer kernel on model D's raw
   tables, at batches 0, 1, 16, 1000 and 4096, called through its wrapper and
   through the engine; each route of the two fused kernels (``smem``:
   ``lut_fused_smem.cu``, slabs staged in shared memory; ``global``:
   ``lut_kernels.cu``, the first design) called directly, also on a copy
   of the slabs whose table slab is a view at an odd byte offset; and
   each route of the per-layer kernel (``smem``: tables staged in shared
   memory; ``direct``: read in place; both ``lut_layer_smem.cu``, as
   programmatic dependent launches) forced on every layer, also with
   every table 4 bytes past a 16-byte boundary, beside the first design
   (``lut_layer_forward`` in ``lut_kernels.cu``): bit-exact against the
   plain PyTorch version on the card and against the reference's outputs.
2. **serving** — for each layout (model A: mixed as the port compiled
   it, uniform, per-layer; model D: mixed at level 3, per-layer), every
   launch counter set to 0, then
   ``run_closed_loop`` (4 clients x 4 requests of 1-8 rows of the model's
   input codes) through ``ServingTier``: outputs bit-exact with
   ``net(codes)``, zero kernel builds and zero compiler runs after warmup,
   and the layout's kernel launched, the fused layouts on the ``smem``
   route only, the per-layer kernel on its two routes only.  Its launch
   counts are what the ``kernels`` line reports (the mixed and per-layer
   records sum models A and D, with ``launches_by_model``).
3. **times** — median CUDA-event time per forward of each kernel and of its
   plain version at batch 16 (the serving bucket) and 4096, calls issued
   back to back from Python (so host launch gaps count), and the device
   time per forward that ``torch.profiler`` records for the kernels alone
   (``device_ms``), beside the bound: the larger of the bytes the forward
   must move over 3.35 TB/s and its int32 operations over 33.5 TOP/s
   (half the 67 TFLOP/s fp32 CUDA-core rate: Hopper has 64 INT32 lanes per
   SM against 128 FP32).  A fused forward moves its codes in, its codes
   out, its slabs but the table slab once, and of the table slab the
   elements its batch addresses (:func:`fused_table_reads`); a per-layer
   forward moves, launch by launch, that layer's codes in and out, its
   indices once and the table entries its batch addresses
   (:func:`per_layer_bytes`, :func:`addressed_entries`).  The bound with
   whole tables or slabs is kept beside it (``bound_ms_whole_tables``,
   ``bound_ms_whole_slab``).  The fused kernels' two routes are timed in
   turns (global, smem, smem, global), event and device time per launch;
   the ``global`` route's are the earlier design's; model D at level 3's
   mixed times stand under ``model_d`` in the mixed record.  The per-layer
   forward (model A's three launches, model D's four, under
   ``model_d``) is also timed device-paced (:func:`paced_ms`: a spin
   kernel holds the stream while 50 forwards queue) in turns: the first
   design, the routed launches, the routed launches without programmatic
   dependent launch, and back; under PDL a waiting kernel's profiler
   record includes its wait.  No single PyTorch call computes these
   functions, so ``library_ms`` is null.
4. **masked matmul** — the three routes of ``masked_matmul`` against the
   plain version on the card, each case asserting its route from
   ``masked_matmul.launches_by_route``: float32 on the ffma kernel at
   model A's training shapes (its two masks), an input gradient at model
   A's widths with w and mask read as (N, K), ragged (130, 700, 50), (1,
   1, 1) and (129, 65, 127) (also read as (N, K)), K = 70 (not a multiple
   of 4) and 4096^3 (both reads), each also equal bit for bit to the first
   design, ``masked_matmul_forward``, on the same inputs (atol 1e-4,
   rtol 1e-5 against the plain version: another summation order); the SIMT
   kernel at (130, 700, 50) in bfloat16 (K, N not multiples of 8); the
   tensor-core (wgmma) kernel
   in bfloat16 at (256, 64, 64), at (130, 712, 56), (300, 64, 136) and
   (1000, 4104, 4096), ragged against its 256 x 128 x 64 tiles, and at
   4096^3 (the reference's atol 5e-2, rtol 1e-3, plus exactly one
   bfloat16 step of the plain output: both round a float32 sum taken in
   another order); masked-out weights of 1e9 must vanish exactly on every
   route (bit-equal to the call with those weights zeroed: float32 on both
   ffma tiles and both reads, bfloat16 on wgmma);
   ``MaskedMatmulFn``'s gradients against autograd of the plain version,
   its float32 dx made without a transposed copy of w or mask and equal
   bit for bit to the first design on the copies.
5. **training** — (a) the reference's init of model A carried in from
   ``model_a_train.npz`` and trained 20 steps on the card: losses within
   rtol 1e-3 of the reference's; (b) the reference's trained weights
   carried in: truth tables generated on the card equal the reference's,
   except at entries whose float64 value lies within 1e-5 steps of a
   rounding half-way point (counted and printed); then, with every launch
   counter at 0 (the main path of this slice): (c) 600 steps from the
   port's own seeded init, 5 masked-matmul launches a step (3 forward,
   2 input gradients), every one on the ffma route, held-out accuracy
   within 2 points of the reference's 600-step run; (d) ``verify_tables``
   exact through the masked-matmul kernel (float path) against the
   per-layer and the fused uniform LUT kernels (table path), then the
   compiler run once at level 3 and ``verify_tables(optimize_level=3)``
   exact through the mixed fused kernel (``fused=True``) and the per-layer
   kernel on the compiler's uniform lowering (``fused=False``), each
   launched; (e) the raw tables compiled (uniform) and the compiler's
   result compiled (mixed, on the ``smem`` route, equal to the table
   codes) and each served through ``ServingTier`` bit-exact, with zero
   builds and compiler runs after warmup.
6. **masked-matmul times** — event and profiler device time at model A's
   widest layer (256 x 64 x 64, float32, ffma) and at 4096^3 (float32 on
   the ffma route, bfloat16 on the wgmma route), each beside the SIMT
   kernel called directly on the same inputs (the earlier design; its
   device time too in float32), the plain version,
   ``torch.addmm(b, x, w * mask)`` with TF32 off
   (``library_ms``, timed only as a yardstick) and the bound: the larger of
   the bytes moved (x, w, mask, b read once, out written once) over
   3.35 TB/s and the multiply-adds the mask keeps (2 M nnz(mask)) over
   67 TFLOP/s (float32, CUDA cores) or 989 TFLOP/s (bfloat16); and 50
   profiled training steps: host-clock time against device time per step,
   the masked matmul's device time and launches, kernels and copy kernels
   a step.

7. **flash attention** — the three routes of ``flash_attention``
   against the plain version on the card, each case asserting its route
   from ``flash_attention.launches_by_route`` (D % 8 == 0 up to 256:
   bfloat16 on wgmma, float32 on tf32x3; any other D: SIMT): the
   reference tests' cases (MHA, GQA, MQA, ragged 250, causal and not,
   windows 16 / 64 / 1024, bfloat16), a ragged S = 1000, window 1024 at
   qwen3-1.7b's head shape, D 12 and 6 on the SIMT route in both dtypes,
   and the qwen3-1.7b prefill shape (4, 16, 2048, 128) with Hkv 8 (in
   float32 also against the SIMT kernel on the same inputs, within the
   same tolerance), and for both tensor-core routes a grid of GQA groups
   1, 2 and 8, D 16 (bfloat16) or 8 (float32), 64, 128 and 256, S 65, 250
   and 1000, causal and not, and windows 16, 64 and 1024; in float32
   (atol 1e-5, rtol 1e-5: another summation order, and on tf32x3 three
   TF32 products a product) and bfloat16 (the reference's atol 3e-2 plus
   exactly one bfloat16 step of the plain output); on the wgmma route
   also a second gate beside it, 1e-3 plus two bfloat16 steps of the
   plain output, elementwise, and a case at (1, 16, 32768, 128); at the
   prefill shape and at 32768 the gate's readings (largest difference
   over its limit, RMS ratio) of the kernel, of the kernel with P rounded
   to bfloat16 and of a stale-stage control (the plain version with one
   K/V tile replaced by the one two tiles before it), failing unless the
   gate rejects that control; and the inputs phase 9 gives the kernels,
   attn_apply's transposed (B, S, H, D) views at (2, 16, 64, 128) with
   Hkv 8 in float32 (tf32x3) and bfloat16 and at the prefill shape in
   bfloat16, each tensor-core output checked to be a view of a
   (B, S, H, D) buffer.
8. **smoke LMs against the reference** — the qwen3-1.7b and gemma3-27b
   smoke configs with the reference's params (``lm_smoke.npz``): prefill
   logits through the kernel, teacher-forced decode logits and, at float32
   compute, the tokens of every request of the serve loop, against the
   reference's (float32 atol 1e-4 / rtol 1e-4, bfloat16 0.05, tokens
   equal).
9. **qwen3-1.7b at full width, the main path of this slice** — every launch
   counter at 0, the port's seeded init (28 layers, d_model 2048, Hq 16,
   Hkv 8, head_dim 128, vocab 151 936, bfloat16 compute): (a) prefill of
   4 prompts x 2048 tokens through ``make_prefill_step``, exactly 28 flash
   launches, all on the wgmma route, finite logits; (b) 2 prompts of 64
   tokens fed one at a time through ``decode_step``, last logits against
   prefill's (28 flash launches each, all on tf32x3 at float32 compute
   and on wgmma at bfloat16): at float32 compute (a float32 cache, the
   same weights) within atol 1e-4 / rtol 1e-4, and at bfloat16 compute the
   same top-1
   tokens and the reference's atol 0.05 / rtol 0.05 on all but 1e-4 of
   the logits (28 layers of bfloat16 rounding in two summation orders
   move a logit by about 0.012 on average and past 0.05 at 21 of
   303 872); (c) ``serve_lm.serve`` at
   the CLI defaults (12 requests, 4 slots, 24 new tokens, cache 128):
   every request served.
10. **flash times** — at (4, 16, 2048, 128) and (1, 16, 32768, 128)
    (one layer of the prefill_32k cell's sequence), bfloat16, causal,
    Hkv 8: event time and profiled device time back to back (and a
    launch's device time inside the prefill's profile) beside the SIMT
    kernel called directly on the same inputs (the earlier design) and the
    wgmma kernel with P rounded to bfloat16 (what the hi + lo split
    costs), the plain version,
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    (``library_ms``, a yardstick the port never calls) and the bound, the
    larger of q, k, v and out moved once over 3.35 TB/s and 4 B Hq D per
    unmasked (q, k) pair over 989 TFLOP/s; and for the path, a prefill's
    host-clock time against its profiled device time (the kernel's share,
    the idle share) and decode's ms per step and tokens per second; and
    the float32 route (``flash_attention_tf32_forward``, phase 9b's
    float32 prefill) at (4, 16, 2048, 128) causal, Hkv 8: event and device
    time in turns with SDPA's memory-efficient backend on K and V expanded
    to 16 heads (the fused float32 yardstick, that record's
    ``library_ms``), beside the SIMT kernel
    called directly (the earlier design, event and device time), the plain
    version, SDPA with ``enable_gqa`` on the same float32 tensors (its math
    backend, ``library_math_ms``) and two bounds: the route's, its
    operations three times over at 495 TFLOP/s (dense TF32), and the SIMT
    route's at 67 TFLOP/s.

11. **the serving front** — (a) HTTP: ``BackgroundIngress`` on port 0
    over model A at level 3 as the port compiled it (mixed, ``smem``),
    then over model D's raw tables (per-layer, by the engine's choice),
    every launch counter at 0 before each: the fixture's 4096 rows as raw
    int8 and as JSON bodies, bit-exact with the reference's outputs;
    ``run_open_loop(url=..., verify_net=net)`` at 400 rps offered, 64
    requests of 1-8 rows, every request ``ok`` and bit-exact; a quota case
    (200 rows/s, burst 16) whose ``rejected_quota`` count is positive and
    equals the rise of ``ingress_rejected_total{reason="quota"}``; zero
    kernel builds and compiler runs after warmup; launches of the model's
    kernel only, on its expected routes; ``GET /metrics`` holding the
    ``serve_*`` and ``ingress_*`` families; HTTP p50 / p99 / rows/s printed
    beside phase 2's in-process figures.  (b) autotune:
    ``compile_network(optimize_level=3, autotune=True)`` on models A and D
    (one compiler run each): every enumerated variant timed, each with a
    kernel route (from ``launches_by_route``; a ``global`` route is
    reported, not failed), the winner the argmin of the table, the plan's
    ``backend`` naming the card, outputs bit-exact with the reference's;
    after ``save`` and ``load`` zero compiler runs, zero variants timed
    and the same outputs, and with ``backend`` stripped from the plan
    ``measured_here`` false; the search run a second time on the same
    tables, both timing tables printed (key, route, us a forward) with the
    spread among variants that differ only in block_b beside the gap
    between layouts.  (c) ``python -m repro_torch.launch.serve --lut
    --http 0 --smoke`` and ``--lut --autotune --smoke`` as subprocesses:
    exit 0, zero builds and compiler runs after warmup.  The LUT records
    carry phase 11's launches beside phase 2's (``launches_http_a`` /
    ``launches_http_d``, ``launches_autotune``).

12. **the legacy flag API and the MNIST family** — (a) every launch
    counter at 0: ``ops.lut_network(codes, layers, fused=True,
    optimize_level=3)`` twice over model A's raw tables, both bit-exact
    with the reference's outputs, the second adding 0 compiler runs and
    1 to ``engine_memo_hits_total``, the mixed kernel on ``smem``;
    ``fused=True`` without a level on the uniform kernel;
    ``ops.lut_lookup`` / ``masked_matmul`` / ``flash_attention`` each one
    launch, equal bit for bit to its wrapper; 10
    ``sparse_head_forward(fused=True)`` calls building one artifact.
    (b) Table 7.1's widest MLP, ``mlp((2048, 2048, 2048), 2, 5)`` at full
    width (784 -> 2048 x 3 sparse, fan-in 5, 2-bit codes, dense head),
    every launch counter at 0 before training and again before serving
    (the MNIST path): ``train_logicnet`` on ``mnist_like_data(4800, 0)``
    flattened and centred (4000 rows to train on, 800 held out), 250 steps
    at batch 256, lr 5e-3 (the reference table's budget), every masked
    matmul on ``ffma``, held-out accuracy at least ``MNIST_MIN_ACCURACY``;
    ``generate_tables`` and ``verify_tables`` EXACT on 200 held-out rows;
    ``compile_network`` with no level, which must pick ``per_layer`` for
    ``slab_exceeds_smem_budget`` by itself; the ``--smoke`` closed loop
    through ``ServingTier`` (zero builds and compiler runs after warmup,
    only the per-layer kernel launched, served rows equal to the plain
    version of the same artifact); the per-layer forward device-paced at
    batch 16, 256 and 4096 on the rule's routes and on the other route of
    every layer, beside the bound of the table entries each batch
    addresses (and the whole-tables bound); the masked matmul at
    the step's 256 x 784 x 2048 and 256 x 2048 x 2048 with the trained
    masks (event, device, plain, ``addmm``, bound); 30 profiled steps
    (host against device ms a step).  (c) Table 7.4's first layer,
    ``SparseConv(SparseConvCfg(1, 16, 3, first_layer=True))``: one
    train-mode forward and backward over 256 ``mnist_like_data`` images
    on the card with cuDNN's TF32 default on around it, against the same
    weights on the CPU: outputs within ``CONV_TOL``, gradients within it
    plus ``CONV_GRAD_ULPS`` float32 units of their envelope
    (:func:`conv_grad_envelope`), and a control with the depthwise conv's
    backward in TF32 refused by that gate wherever it changes a gradient.  The per-layer record carries
    the MNIST readings under ``mnist``, the masked-matmul record its two
    shapes under ``mnist`` and the training under ``mnist_training``, and
    each record its phase-12a launches (``launches_legacy_api``).

Every device time is ``torch.profiler``'s sum of the measured calls'
kernel records, taken only from a trace that holds all of them and, for
device-bound calls (the flash shapes, the 4096^3 masked matmuls), reads at
least ``DEVICE_BOUND_FLOOR`` of the CUDA-event time of the same calls
(:func:`trace_accepted`).

The next-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout,
it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import os
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
LUT_SOURCE = "src/repro_torch/kernels/csrc/lut_kernels.cu"
LUT_SMEM_SOURCE = "src/repro_torch/kernels/csrc/lut_fused_smem.cu"
LUT_LAYER_SOURCE = "src/repro_torch/kernels/csrc/lut_layer_smem.cu"
# forwards a device-paced reading queues behind the spin kernel, held
# twice SPIN_CYCLES (about 50 ms): a host issuing a launch in 60 us queues
# 4 x 50 launches in 12 ms
PACED_ITERS = 50
MM_SOURCE = "src/repro_torch/kernels/csrc/masked_matmul.cu"
MM_WGMMA_SOURCE = "src/repro_torch/kernels/csrc/masked_matmul_wgmma.cu"
MM_FFMA_SOURCE = "src/repro_torch/kernels/csrc/masked_matmul_ffma.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_WGMMA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
FA_TF32_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_tf32.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:30"
# dense TF32 on the tensor cores; the tf32x3 route issues three TF32
# products for each float32 product
TF32_FLOPS_PER_S = 495e12
TF32_PRODUCTS = 3
# flash attention: (atol, rtol, steps) as MM_TOL; float32 differs from the
# plain version in summation order only, bfloat16 takes the reference's
# atol 3e-2 plus one bfloat16 step of the plain output
FA_TOL = {"float32": (1e-5, 1e-5, 0), "bfloat16": (3e-2, 0.0, 1)}
# the wgmma route's second gate, beside FA_TOL, as (atol, rtol, steps):
# kernel and plain version differ in summation order and by P's hi + lo
# split (about 2^-17 of P), far below one bfloat16 step, so two steps of
# the plain output plus 1e-3 (outputs near zero).  At S 2048 an output
# is about 0.04, so FA_TOL's 3e-2 would pass a kernel that reads one
# stale K/V stage of sixteen (late rows move by about 5e-3): phase 7
# checks that this gate rejects such a control
FA_GATE = (1e-3, 0.0, 2)
LM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.05, 0.05)}
FULL_ARCH = "qwen3-1.7b"
PREFILL_SHAPE = (4, 2048)       # the prefill_32k cell cut to B 4 x S 2048
DECODE_CHECK_SHAPE = (2, 64)    # phase 9b's prompts, decoded against prefill
LONG_SEQ = 32768
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
# phase 12: Table 7.1's widest MNIST MLP, trained on the reference table's
# budget (benchmarks/paper_tables.py: 250 steps, lr 5e-3, 4000 + 800 rows)
MNIST_MLP = ((2048, 2048, 2048), 2, 5)
MNIST_STEPS = 250
MNIST_LR = 5e-3
# a floor for held-out accuracy on 10 classes (chance 0.1): a run that
# learned nothing fails
MNIST_MIN_ACCURACY = 0.5
MNIST_TIME_BATCHES = (16, 256, 4096)
# SparseConv on the card against the CPU: outputs within atol + rtol |y|;
# a parameter gradient sums B * H' * W' (173 056) terms, and a float32 sum
# taken in another order misses atol + rtol |g| at small elements, so a
# gradient element may also differ by CONV_GRAD_ULPS float32 units of its
# envelope (the sum of its last reduction's |terms|, from a float64 run):
# on the CPU the batch taken in four other orders moves w_dw by 3.9-5.9
# units (the gradient at the conv output carries BN's float32 error), and
# TF32 operands in its weight gradient by 2 888 (the gate sits 22x from
# each; tests/test_torch_chip_smoke.py)
CONV_TOL = (1e-5, 1e-5)
CONV_GRAD_ULPS = 128


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def per_layer_bytes(batch: int, n_in: int, shapes, entries=None) -> int:
    """The bytes a per-layer forward of ``batch`` rows must move: each
    launch reads its own (batch, I_l) codes and writes its own (batch, O_l)
    codes, and reads its (O_l, FI_l) indices once and, of its (O_l, E_l)
    table, the ``entries[l]`` entries the batch addresses
    (:func:`addressed_entries`; int32 throughout).  Without ``entries``
    whole tables are counted: what a batch that addresses every entry
    would need.  ``shapes`` holds each layer's (O_l, FI_l, E_l)."""
    total = 0
    for layer, (n_out, fan_in, n_entries) in enumerate(shapes):
        read = n_out * n_entries if entries is None else entries[layer]
        total += 4 * (batch * (n_in + n_out) + n_out * fan_in + read)
        n_in = n_out
    return total


def addressed_entries(layers, codes) -> list:
    """Each layer's count of table entries a per-layer forward over
    ``codes`` reads (its distinct (neuron, entry) pairs), layer by layer
    through the plain version; ``layers`` holds (indices, table, bw_in)."""
    import torch

    from repro_torch.kernels import lut_lookup as L
    out = []
    for idx, tab, bw in layers:
        entry = L.pack_fan_in_entries(codes, idx, bw)          # (O, B)
        rows = torch.arange(idx.shape[0], device=codes.device)[:, None]
        ok = (entry >= 0) & (entry < tab.shape[1])
        out.append(int(torch.unique(
            (rows * tab.shape[1] + entry)[ok]).numel()))
        codes = L.lut_lookup_plain(codes, idx, tab, bw)
    return out


def fused_table_reads(slabs, codes) -> int:
    """The table-slab elements a fused forward over ``codes`` reads: the
    distinct slab positions its entries address, layer by layer through
    the plain version (uniform slabs, or mixed ones: ``row_meta``)."""
    import torch

    from repro_torch.kernels import lut_lookup as L
    from repro_torch.kernels import lut_network as N
    mixed = hasattr(slabs, "row_meta")
    table = slabs.table_slab.reshape(-1)
    e_max = slabs.table_slab.shape[-1]
    h, row, reads = codes, 0, 0
    for m in slabs.meta:
        rows = slice(row, row + m.n_out)
        if mixed:
            entry = L.pack_fan_in_entries_mixed(
                h, slabs.idx_slab[rows, :m.fan_in],
                slabs.shift_slab[rows, :m.fan_in],
                slabs.width_slab[rows, :m.fan_in]).T            # (B, O)
            off, n_e = (slabs.row_meta[rows, 0].long(),
                        slabs.row_meta[rows, 1].long())
            ok = (entry >= 0) & (entry < n_e)
            pos = off + torch.minimum(entry.clamp(min=0), n_e - 1)
            reads += int(torch.unique(pos[ok]).numel())
            h = torch.where(ok, N._widen(table[pos], slabs.packed),
                            torch.zeros((), dtype=torch.int32,
                                        device=h.device))
        else:
            entry = L.pack_fan_in_entries(
                h, slabs.idx_slab[rows, :m.fan_in], m.bw_in).T  # (B, O)
            ok = (entry >= 0) & (entry < m.n_entries)
            pos = (torch.arange(row, row + m.n_out, device=h.device)
                   * e_max + entry)
            reads += int(torch.unique(pos[ok]).numel())
            h = N._widen(L.gather_entries(
                slabs.table_slab[rows, :m.n_entries], entry), slabs.packed)
        row += m.n_out
    return reads


def conv_grad_envelope(mod, x, r) -> dict:
    """Each parameter gradient's envelope for ``(mod(x) * r).sum()`` over
    a ``SparseConv`` ``mod`` in train mode: per element, the sum of the
    absolute values of the terms its last reduction adds, from a float64
    run on the CPU.  With ``dh``, ``dh1``, ``dy`` the gradients at bn1's
    input and output and at bn2's input, and the hats the batch-normalised
    activations: w_dw sum |x_q| |dh| (through the masked depthwise conv),
    b_dw sum |dh|, bn1 sum |dh1 h^| and sum |dh1|, w_pw sum |q_m| |dy|
    (masked), b_pw sum |dy|, bn2 sum |r y^| and sum |r|."""
    import copy

    import torch

    from repro_torch.core.layers import BN_EPS, depthwise
    from repro_torch.core.quantize import quantize
    m = copy.deepcopy(mod).cpu().double().train()
    cfg, dims = m.cfg, (0, 1, 2)
    x, r = x.detach().cpu().double(), r.detach().cpu().double()
    seen = {}
    hooks = [
        m.bn1.register_forward_hook(
            lambda _m, i, o: seen.update(h=i[0], h1=o)),
        m.bn2.register_forward_hook(lambda _m, i, o: seen.update(y=i[0])),
        m.bn1.register_full_backward_hook(
            lambda _m, gi, go: seen.update(dh=gi[0], dh1=go[0])),
        m.bn2.register_full_backward_hook(
            lambda _m, gi, go: seen.update(dy=gi[0]))]
    (m(x) * r).sum().backward()
    for h in hooks:
        h.remove()

    def hat(v):
        v = v.detach() - v.detach().mean(dims)
        return v * (v.square().mean(dims) + BN_EPS).rsqrt()

    with torch.no_grad():
        xq = quantize(cfg.in_quant, x).value.abs()
        qm = quantize(cfg.mid_quant, seen["h1"]).value.abs()
        dh, dh1, dy = seen["dh"].abs(), seen["dh1"].abs(), seen["dy"].abs()
        env = {"b_dw": dh.sum(dims), "b_pw": dy.sum(dims),
               "w_pw": m.mask_pw * torch.einsum("bhwc,bhwo->co", qm, dy),
               "bn1.scale": (dh1 * hat(seen["h"]).abs()).sum(dims),
               "bn1.bias": dh1.sum(dims),
               "bn2.scale": (r.abs() * hat(seen["y"]).abs()).sum(dims),
               "bn2.bias": r.abs().sum(dims)}
    probe = torch.zeros_like(m.w_dw, requires_grad=True)
    gw, = torch.autograd.grad(
        depthwise(xq, probe, cfg.stride, cfg.replicate), probe, dh)
    env["w_dw"] = m.mask_dw * gw
    return env


def conv_grad_reading(g, ref, env) -> float:
    """The largest excess of ``|g - ref|`` over ``CONV_TOL`` (atol + rtol
    ``|ref|``), in float32 units (2^-24) of the envelope ``env``: inf
    where an element with no envelope differs by more than the tolerance.
    A gradient passes at ``CONV_GRAD_ULPS`` or less."""
    atol, rtol = CONV_TOL
    g, ref, env = g.double().cpu(), ref.double().cpu(), env.double().cpu()
    excess = ((g - ref).abs() - atol - rtol * ref.abs()).clamp(min=0)
    units = excess / (2.0 ** -24 * env)
    return float(units.nan_to_num(nan=0.0).max())


def paced_ms(fn, iters: int = PACED_ITERS, reps: int = 5) -> float | None:
    """Device-paced ms a call: a spin kernel holds the stream while the
    host queues ``iters`` calls, and CUDA events bracket them (gaps between
    kernels included); the median over ``reps``.  None when the host did
    not finish queueing before the spin ended (the reading would be the
    host's pace)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2 * SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if not held:
            return None
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def reset_counts(wrapper) -> None:
    """Set a kernel wrapper's launch count and its per-route counts (where
    it has routes) to 0."""
    wrapper.launches = 0
    for route in getattr(wrapper, "launches_by_route", ()):
        wrapper.launches_by_route[route] = 0


def untimed(d):
    """A compile-stats record with every ``seconds`` field dropped."""
    if isinstance(d, dict):
        return {k: untimed(v) for k, v in d.items() if k != "seconds"}
    if isinstance(d, list):
        return [untimed(v) for v in d]
    return d


def plan_without_budget(plan: dict) -> dict:
    """A plan record without its budget fields (``vmem_budget_bytes``,
    ``headroom_bytes``): the port's budget is the card's shared memory,
    the reference artifact's its own, so they differ by design."""
    cost = {k: v for k, v in plan["variant"]["cost"].items()
            if k not in ("vmem_budget_bytes", "headroom_bytes")}
    return {**plan, "variant": {**plan["variant"], "cost": cost}}


def compile_host_times(models: dict) -> dict:
    """Wall seconds of one ``repro_torch.compile.optimize`` run per model
    and level 0-4 (host CPU time: the compiler is numpy)."""
    from repro_torch import compile as rcompile

    out = {}
    for name, triples in models.items():
        tables = rcompile.tables_from_triples(triples)
        for level in range(5):
            t0 = time.perf_counter()
            rcompile.optimize(tables, level, in_features=16)
            out[(name, level)] = time.perf_counter() - t0
    return out


def check_port_compiled(torch, net, stored) -> None:
    """The port's level-3 compile of model A against the reference's
    artifact of it: slabs, layer metadata, output permutation, plan (its
    budget aside) and compile stats (timings aside) all equal."""
    a, b = net.slabs, stored.slabs
    for f in ("idx_slab", "shift_slab", "width_slab", "table_slab"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not torch.equal(x, y):
            fail(f"model A at level 3: the port's {f} differs from "
                 f"model_a_l3.npz's")
    if ((a.meta, a.out_perm, a.packed, a.dedup_entries_saved)
            != (b.meta, b.out_perm, b.packed, b.dedup_entries_saved)):
        fail("model A at level 3: layer meta, out_perm or packing differ "
             "from model_a_l3.npz's")
    if (plan_without_budget(net.plan.as_dict())
            != plan_without_budget(stored.plan.as_dict())):
        fail(f"model A at level 3: plan {net.plan.as_dict()} differs from "
             f"{stored.plan.as_dict()}")
    if untimed(net.stats.as_dict()) != untimed(stored.stats.as_dict()):
        fail("model A at level 3: compile stats differ from the stored ones")
    log(f"model A compiled by the port at level 3 equals model_a_l3.npz: "
        f"idx/shift/width/table slabs ({a.table_slab.numel()} B table "
        f"slab), layer meta, out_perm, plan (budget aside) and stats "
        f"(timings aside; {net.stats.neurons_after} neurons, "
        f"{net.stats.table_bytes_after} B of tables)")


def table_at_odd_offset(torch, slabs):
    """The same slabs with the table slab a contiguous view one element
    into a larger buffer: an odd byte offset for an int8 table."""
    import dataclasses

    fields = {f.name: getattr(slabs, f.name)
              for f in dataclasses.fields(slabs) if f.init}
    return type(slabs)(**{**fields, "table_slab": view_at_offset(
        torch, slabs.table_slab)})


def view_at_offset(torch, t, pad: int = 1):
    """``t`` as a contiguous view ``pad`` elements into a larger buffer
    (a caller holds it to a chosen address modulo 16)."""
    buf = torch.zeros(t.numel() + pad, dtype=t.dtype, device=t.device)
    buf[pad:] = t.reshape(-1)
    return buf[pad:].reshape(t.shape)


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


def profiled(fn, iters: int) -> tuple[float, dict, dict]:
    """(host-clock ms per call, {kernel: device ms per call}, {kernel:
    launches per call}) over ``iters`` calls of ``fn`` under
    ``torch.profiler``.

    A first traced round of ``iters`` calls is discarded (the schedule's
    warm-up): launches made right after tracing starts can go unrecorded,
    which dropped one of three 4096^3 masked-matmul launches.  Records can
    still be lost (one of five flash launches at (4, 16, 2048, 128), all
    three at S 32768): a single kernel's time comes from
    :func:`device_ms`, which takes only complete traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
            prof.step()
    by_name: dict[str, float] = {}
    counts: dict[str, float] = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + t / iters / 1e3
            counts[e.key] = counts.get(e.key, 0.0) + e.count / iters
    return wall, by_name, counts


# a device-bound call's CUDA events bracket little but its kernels, so a
# profiler reading below this share of the event time of the same calls
# has lost kernel time (a record cut short), not found host overhead
DEVICE_BOUND_FLOOR = 0.8
# clock cycles (about 25 ms) of torch.cuda._sleep's spin kernel, which holds
# the stream while the host queues the measured calls: under the profiler
# the host takes longer to issue a call than a 0.25 ms kernel runs, and
# the events would then time the host's pace
SPIN_CYCLES = 50_000_000
# calls traced ahead of the measured ones, to take the records the
# profiler drops at the start of a trace (as many as eight seen)
LEAD_CALLS = 20


def trace_accepted(n_records: int, want: int, device_ms: float,
                   event_ms: float, device_bound: bool) -> bool:
    """Whether a trace's reading stands: the run of measured kernel records
    holds exactly ``want`` records and, for calls whose time is the
    device's (``device_bound``), the device time per call is at least
    ``DEVICE_BOUND_FLOOR`` of the CUDA-event time per call of the same
    calls.  A host-bound call's event time holds the card's gaps between
    its short kernels, so only the record count applies to it."""
    if n_records != want:
        return False
    return not device_bound or device_ms >= DEVICE_BOUND_FLOOR * event_ms


def device_ms(fn, iters: int, launches: int = 1, tries: int = 5,
              device_bound: bool = False) -> float | None:
    """Device time per call of ``fn``, which launches ``launches`` kernels a
    call, from a trace of ``iters`` calls between ``LEAD_CALLS`` calls
    before them and one after them, each group 20 ms apart on the host.
    The kernel records fall into runs split by device-side gaps of 10 ms
    or more; the longest run is the measured calls'.  CUDA events around
    the measured calls, inside the same trace, give their event time; a
    spin kernel first holds the stream until all of them are queued, so
    the events bracket the device's work (the spin's record is not
    counted).  The share of event time a reading takes is logged.

    The profiler can lose records (one a trace of masked-matmul launches,
    most flash launches of a window after a large trace) or cut them short
    (half the event time of device-bound calls, after an empty trace), so
    a trace counts only when :func:`trace_accepted` takes it (the calls
    around it take what a trace loses at its start and end); another is
    taken otherwise, up to ``tries`` times, then None (not measured).  The
    profiler drops the first records of a trace (as many as two of the
    float32 flash kernel's, eight of the MNIST-shape masked matmul's), so
    the calls before the measured ones are many.  The floor on event time
    holds for device-bound calls alone:
    model A's 0.003 ms masked matmul and the per-layer LUT kernels read
    0.67-0.78 of their event time (the card's gaps between short
    kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_CALLS):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / iters
        records = sorted((e.time_range for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and not e.is_user_annotation
                          and "spin_kernel" not in e.name),
                         key=lambda r: r.start)
        runs = [[]]
        for r in records:
            if runs[-1] and r.start - runs[-1][-1].end >= 1e4:
                runs.append([])
            runs[-1].append(r)
        measured = max(runs, key=len)
        dev = sum(r.elapsed_us() for r in measured) / 1e3 / iters
        if trace_accepted(len(measured), iters * launches, dev, event_ms,
                          device_bound):
            log(f"device_ms: {dev} ms a call of device time, "
                f"{dev / event_ms:.4f} of the CUDA-event time of the same "
                f"calls ({'device-bound' if device_bound else 'host-bound'}"
                f", {iters} calls of {launches} launches)")
            return dev
        if len(measured) != iters * launches:
            log(f"profiler kept {len(records)} kernel records of "
                f"{(iters + LEAD_CALLS + 1) * launches}, in runs of "
                f"{[len(r) for r in runs]}; tracing again")
        else:
            log(f"profiler read {dev} ms a call of device time against "
                f"{event_ms} ms of CUDA-event time for the same "
                f"device-bound calls (below {DEVICE_BOUND_FLOOR} of it); "
                f"tracing again")
    return None


def profile_split(torch, fn, iters: int) -> tuple:
    """(host ms per call, device ms per call, {kernel: device ms per call},
    {kernel: launches per call}) over ``iters`` calls of ``fn``; fails when
    the profiler records no device time or more device time than
    host-clock time."""
    wall, by_name, counts = profiled(fn, iters)
    total = sum(by_name.values())
    if not total:
        fail("the profiler recorded no device time")
    if total > wall:
        fail(f"the profiler's device time per call ({total} ms) exceeds the "
             f"host-clock time ({wall} ms): it counts some kernel time twice")
    return wall, total, by_name, counts


def top_kernels(by_name: dict, n: int = 6) -> str:
    return "; ".join(f"{k[:60]} {v:.4f}" for k, v in
                     sorted(by_name.items(), key=lambda kv: -kv[1])[:n])


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


def bits(t):
    """A float32 tensor's bits, for equality bit for bit."""
    import torch
    return t.contiguous().view(torch.int32)


def masked_matmul_phase(torch, dev) -> dict:
    """Phase 4: the masked-matmul kernels against their plain version, and
    the float32 (ffma) kernel against the first design bit for bit."""
    from repro_torch.kernels.masked_matmul import (MaskedMatmulFn,
                                                   masked_matmul,
                                                   masked_matmul_plain)
    m0, m1 = model_a_masks()
    # (M, K, N, dtype, mask, route, transposed): float32 runs the ffma
    # kernel, transposed reads w and mask as (N, K) (the input gradient);
    # bfloat16 with K and N multiples of 8 runs the tensor-core kernel,
    # ragged against its 256 x 128 x 64 tiles
    cases = [(256, 16, 64, "float32", m0, "ffma", False),
             (256, 64, 64, "float32", m1, "ffma", False),
             (256, 64, 64, "float32", m1.t().contiguous(), "ffma", True),
             (130, 700, 50, "float32", None, "ffma", False),
             (1, 1, 1, "float32", None, "ffma", False),
             (129, 65, 127, "float32", None, "ffma", False),
             (129, 65, 127, "float32", None, "ffma", True),
             (256, 70, 64, "float32", None, "ffma", False),
             (130, 700, 50, "bfloat16", None, "simt", False),
             (256, 64, 64, "bfloat16", m1, "wgmma", False),
             (130, 712, 56, "bfloat16", None, "wgmma", False),
             (300, 64, 136, "bfloat16", None, "wgmma", False),
             (1000, 4104, 4096, "bfloat16", None, "wgmma", False),
             (4096, 4096, 4096, "float32", None, "ffma", False),
             (4096, 4096, 4096, "float32", None, "ffma", True),
             (4096, 4096, 4096, "bfloat16", None, "wgmma", False)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    bit_cases = 0
    for i, (m, k, n, dtype, mask, route, tr) in enumerate(cases):
        x, w, mk, b = mm_inputs(torch, dev, m, k, n, dtype, mask, seed=i)
        ops = (w.t().contiguous(), mk.t().contiguous()) if tr else (w, mk)
        atol, rtol, steps = MM_TOL[dtype]
        for bias in (b, None):
            before = masked_matmul.launches
            by_route = masked_matmul.launches_by_route[route]
            got = masked_matmul(x, *ops, bias, transposed=tr)
            want = masked_matmul_plain(x, *ops, bias, transposed=tr)
            first = (simt_masked_matmul(torch, x, w, mk, bias)
                     if route == "ffma" else None)
            torch.cuda.synchronize()
            if masked_matmul.launches != before + 1:
                fail(f"masked_matmul {m}x{k}x{n} {dtype}: kernel not launched")
            if masked_matmul.launches_by_route[route] != by_route + 1:
                fail(f"masked_matmul {m}x{k}x{n} {dtype}: not launched on "
                     f"the {route} route ({masked_matmul.launches_by_route})")
            if got.dtype != x.dtype or got.shape != (m, n):
                fail(f"masked_matmul {m}x{k}x{n} {dtype}: gave {got.dtype} "
                     f"{tuple(got.shape)}")
            diff = (got.float() - want.float()).abs()
            if bool((diff > mm_limit(torch, want, atol, rtol, steps)).any()):
                fail(f"masked_matmul {m}x{k}x{n} {dtype}: max |kernel - "
                     f"plain| {float(diff.max())} beyond atol {atol} rtol "
                     f"{rtol} + {steps} {dtype} step")
            if first is not None and not torch.equal(bits(got), bits(first)):
                fail(f"masked_matmul {m}x{k}x{n} float32 (transposed {tr}): "
                     f"the ffma kernel differs from masked_matmul_forward "
                     f"at {int((bits(got) != bits(first)).sum())} outputs")
            bit_cases += first is not None
            errs[dtype] = max(errs[dtype], float(diff.max()))
        log(f"phase 4 masked_matmul {m}x{k}x{n} {dtype} ({route}"
            f"{', w and mask read as (N, K)' if tr else ''}): max |kernel - "
            f"plain| {errs[dtype]:.3g} (atol {atol}, rtol {rtol}, + {steps} "
            f"step){'; bit for bit masked_matmul_forward' * (route == 'ffma')}")
    x = torch.ones((4, 8), device=dev)
    w = torch.full((8, 4), 1e9, device=dev)
    mask = torch.zeros((8, 4), device=dev)
    mask[0] = 1.0
    before = masked_matmul.launches_by_route["ffma"]
    if not bool((masked_matmul(x, w, mask) == 1e9).all()):
        fail("masked_matmul: masked-out weights of 1e9 leaked into the sum")
    # float32 on both tiles of the ffma route, both reads: the mask is
    # multiplied into w on the way into shared memory
    for m, k, n in ((256, 64, 64), (2048, 1024, 4096)):
        x, w, mk, b = mm_inputs(torch, dev, m, k, n, "float32", seed=8)
        loud = torch.where(mk.bool(), w, torch.full_like(w, 1e9))
        same = bits(masked_matmul(x, w * mk, mk, b))
        for got in (masked_matmul(x, loud, mk, b),
                    masked_matmul(x, loud.t().contiguous(),
                                  mk.t().contiguous(), b, transposed=True)):
            if not torch.equal(bits(got), same):
                fail(f"masked_matmul float32 {m}x{k}x{n}: masked-out weights "
                     f"of 1e9 leaked into the sum")
    torch.cuda.synchronize()
    if masked_matmul.launches_by_route["ffma"] != before + 7:
        fail("masked_matmul float32 leak check: not on the ffma route")
    # bfloat16 on the tensor-core route: the mask is applied in shared
    # memory, so an unfenced write would let wgmma read the 1e9 weights
    x, w, mk, b = mm_inputs(torch, dev, 1000, 4104, 4096, "bfloat16", seed=7)
    loud = torch.where(mk.bool(), w, torch.full_like(w, 1e9))
    before = masked_matmul.launches_by_route["wgmma"]
    got = masked_matmul(x, loud, mk, b)
    same = masked_matmul(x, w * mk, mk, b)
    ones = torch.ones((64, 64), dtype=torch.bfloat16, device=dev)
    big = torch.full((64, 64), 1e9, dtype=torch.bfloat16, device=dev)
    one_row = torch.zeros((64, 64), dtype=torch.bfloat16, device=dev)
    one_row[0] = 1.0
    single = masked_matmul(ones, big, one_row)
    torch.cuda.synchronize()
    if masked_matmul.launches_by_route["wgmma"] != before + 3:
        fail("masked_matmul bfloat16 leak check: not on the wgmma route")
    if not torch.equal(got, same) or not bool((single == big[0, 0]).all()):
        fail("masked_matmul bfloat16: masked-out weights of 1e9 leaked into "
             f"the sum (max |loud - zeroed| "
             f"{float((got.float() - same.float()).abs().max())})")
    x, w, mask, b = mm_inputs(torch, dev, 256, 64, 64, "float32", m1, seed=9)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    plain = [t.clone().requires_grad_() for t in (x, w, b)]
    before = masked_matmul.launches_by_route["ffma"]
    copies = []
    contiguous = torch.Tensor.contiguous

    def watched(t, *args, **kwargs):
        # a .contiguous() that copies: what the input gradient must not do
        if not t.is_contiguous():
            copies.append(tuple(t.shape))
        return contiguous(t, *args, **kwargs)

    y = MaskedMatmulFn.apply(leaves[0], leaves[1], mask, leaves[2])
    torch.Tensor.contiguous = watched
    try:
        y.square().sum().backward()
        torch.cuda.synchronize()
    finally:
        torch.Tensor.contiguous = contiguous
    masked_matmul_plain(plain[0], plain[1], mask,
                        plain[2]).square().sum().backward()
    dy = 2 * y.detach()     # d sum(y^2) / dy, exact
    copied = simt_masked_matmul(torch, dy, w.t().contiguous(),
                                mask.t().contiguous(), None)
    torch.cuda.synchronize()
    if masked_matmul.launches_by_route["ffma"] != before + 2:
        fail("MaskedMatmulFn: expected one forward and one dx launch on the "
             "ffma route")
    if copies:
        fail(f"MaskedMatmulFn float32 backward made transposed copies of "
             f"{copies}")
    if not torch.equal(bits(leaves[0].grad), bits(copied)):
        fail("MaskedMatmulFn dx through the transposed read differs from the "
             "copy-based dx (masked_matmul_forward on w^T, mask^T)")
    for name, a, p in zip(("dx", "dw", "db"), leaves, plain):
        diff = (a.grad - p.grad).abs()
        if bool((diff > 1e-4 + 1e-5 * p.grad.abs()).any()):
            fail(f"MaskedMatmulFn {name}: max |kernel - plain| "
                 f"{float(diff.max())}")
        errs["float32"] = max(errs["float32"], float(diff.max()))
    log(f"phase 4 masked_matmul: ffma bit for bit masked_matmul_forward in "
        f"{bit_cases} calls; mask exact on every route (1e9 weights masked "
        f"out equal the zeroed call bit for bit: float32 at 256x64x64 and "
        f"2048x1024x4096, both reads; bfloat16 at 1000x4104x4096); "
        f"MaskedMatmulFn dx, dw, db within atol 1e-4 of autograd of the plain "
        f"version, dx read w and mask as (N, K) (no transposed copy) and "
        f"equals the copy-based dx bit for bit")
    return {"max_abs_err": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"], "ffma_bit_cases": bit_cases}


def training_phase(torch, dev, kernels) -> dict:
    """Phase 5: train model A on the card, make tables, verify, serve."""
    import numpy as np

    from repro_torch import compile as rcompile
    from repro_torch import engine, serve
    from repro_torch.configs import fpga4hep
    from repro_torch.core import logicnet as LN
    from repro_torch.core.quantize import codes as quant_codes
    from repro_torch.core.train import auc_roc_ovr, train_logicnet
    from repro_torch.data import jet_substructure_data
    from repro_torch.kernels.lut_lookup import lut_lookup
    from repro_torch.kernels.lut_network import (lut_network,
                                                 lut_network_mixed)
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
        reset_counts(k["wrapper"])
    reset_counts(masked_matmul)
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
    if masked_matmul.launches_by_route["ffma"] != train_launches:
        fail(f"float32 training left the ffma route: "
             f"{masked_matmul.launches_by_route}")
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
        "through masked_matmul_ffma_forward, table path through "
        "lut_layer_forward and lut_uniform_forward")

    # the compiler once, then verify_tables at level 3 through both LUT
    # kernels: mixed fused (fused=True) and per-layer on the compiler's
    # uniform lowering (fused=False)
    t0 = time.perf_counter()
    opt = rcompile.optimize(tables, 3, in_features=cfg.in_features)
    opt_s = time.perf_counter() - t0
    for fused, wrapper in ((True, lut_network_mixed), (False, lut_lookup)):
        before = wrapper.launches
        f_codes, o_codes = LN.verify_tables(res.model, tables, xv[:200],
                                            fused=fused, optimize_level=3)
        torch.cuda.synchronize()
        if wrapper.launches == before:
            fail(f"verify_tables fused={fused} optimize_level=3: "
                 f"{wrapper.__name__} not launched")
        if not torch.equal(f_codes, o_codes) or not torch.equal(o_codes,
                                                                t_codes):
            bad = (f_codes != o_codes).any(1).nonzero().flatten().tolist()
            fail(f"verify_tables fused={fused} optimize_level=3: not exact "
                 f"on rows {bad}")
    log(f"phase 5d compiled the trained tables once at level 3 in "
        f"{opt_s:.4f} s (host CPU): {rcompile.summarize(opt.stats)}; "
        f"verify_tables(optimize_level=3) EXACT through lut_mixed_forward "
        f"(fused=True) and lut_layer_forward (fused=False)")

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

    # the compiled artifact of the same tables, from the one compiler run
    runs = engine.compile_runs()
    net_opt = engine.compile_network(opt, in_features=cfg.in_features,
                                     block_b=16, device=dev)
    if net_opt.layout != "mixed" or engine.compile_runs() != runs:
        fail(f"the optimized trained tables compiled to {net_opt.layout} "
             f"with {engine.compile_runs() - runs} compiler runs")
    in_codes = quant_codes(cfg.layer_cfgs()[0].in_quant,
                           torch.as_tensor(xv[:200], device=dev))
    if not torch.equal(net_opt(in_codes), t_codes):
        fail("the optimized trained artifact differs from the table codes")
    before = (lut_network_mixed.launches,
              dict(lut_network_mixed.launches_by_route))
    rep = serve.run_closed_loop(net_opt, n_clients=4, n_per_client=4,
                                rows_min=1, rows_max=8, bw=3, seed=0)
    st = rep.stats
    served = lut_network_mixed.launches - before[0]
    on_smem = lut_network_mixed.launches_by_route["smem"] - before[1]["smem"]
    if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
        fail(f"serving the optimized trained model: compile-once contract "
             f"broken: {st}")
    if not served or on_smem != served:
        fail(f"serving the optimized trained model: {served} mixed launches, "
             f"{on_smem} on smem")
    slab_b = net_opt.slab_breakdown()["total_bytes"]
    log(f"phase 5e optimized trained model (mixed, {slab_b} B of slabs) "
        f"served: {rep.n_requests} requests "
        f"({rep.rows} rows) bit-exact, p50={rep.p50_ms:.3f} ms "
        f"p99={rep.p99_ms:.3f} ms, lut_mixed_forward {served} launches all "
        f"on smem, retraces={st['retraces_after_warmup']} "
        f"compiler_runs={st['compiler_runs_after_warmup']}")
    launches = masked_matmul.launches
    log(f"phase 5 main path launches: masked_matmul {launches} "
        f"(by route {masked_matmul.launches_by_route}), "
        f"lut_layer_forward {lut_lookup.launches}, lut_uniform_forward "
        f"{lut_network.launches} (by route "
        f"{lut_network.launches_by_route}), lut_mixed_forward "
        f"{lut_network_mixed.launches} (by route "
        f"{lut_network_mixed.launches_by_route})")
    return {"launches": launches,
            "launches_by_route": dict(masked_matmul.launches_by_route),
            "loss_rtol_20": rel,
            "table_mismatches": mismatched, "boundary_entries": near,
            "train_step_ms": train_s / TRAIN_STEPS * 1e3,
            "launches_per_step": (train_launches - 3) / TRAIN_STEPS,
            "accuracy": res.accuracy, "optimize_level3_s": opt_s,
            "lut_mixed_launches": lut_network_mixed.launches}


def simt_masked_matmul(torch, x, w, mk, b):
    """The SIMT kernel called directly, bypassing the route rule (and the
    launch counts): the earlier design, timed beside the tensor-core kernel
    (bfloat16) and the ffma kernel (float32) in the same run, and the
    float32 order oracle the ffma kernel must equal bit for bit."""
    from repro_torch.kernels import masked_matmul as MM
    out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    MM._launch_simt(x, w, mk, b, out)
    return out


def masked_matmul_times(torch, dev, mm: dict) -> dict:
    """Phase 6: masked-matmul times beside the plain version, the library
    call and the bound; returns the kernel's record."""
    from repro_torch.kernels.masked_matmul import (masked_matmul,
                                                   masked_matmul_plain,
                                                   masked_matmul_route)
    rec = {"name": "masked_matmul_ffma_forward", "route": "cuda",
           "source": MM_FFMA_SOURCE,
           "replaces": "src/repro/kernels/masked_matmul.py:23", **mm,
           "routes": {"ffma": MM_FFMA_SOURCE, "simt": MM_SOURCE,
                      "wgmma": MM_WGMMA_SOURCE},
           "shape": [256, 64, 64]}
    # (..., iters, device-bound): model A's layer is host-bound, the 4096^3
    # calls device-bound
    cases = (("", 256, 64, 64, "float32", model_a_masks()[1], 200, False),
             ("_4096_f32", 4096, 4096, 4096, "float32", None, 3, True),
             ("_4096_bf16", 4096, 4096, 4096, "bfloat16", None, 10, True))
    for suffix, m, k, n, dtype, mask, iters, bound_calls in cases:
        x, w, mk, b = mm_inputs(torch, dev, m, k, n, dtype, mask)
        route = masked_matmul_route(x.dtype, k, n)
        ms = cuda_ms(lambda: masked_matmul(x, w, mk, b), iters)
        plain_ms = cuda_ms(lambda: masked_matmul_plain(x, w, mk, b), iters)
        library_ms = cuda_ms(lambda: torch.addmm(b, x, w * mk), iters)
        dev_ms = device_ms(lambda: masked_matmul(x, w, mk, b), iters,
                           device_bound=bound_calls)
        moved = nbytes(x, w, mk, b) + m * n * x.element_size()
        ops = 2 * m * int(mk.count_nonzero())
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FLOPS_PER_S[dtype] * 1e3
        rec.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                    f"device_ms{suffix}": dev_ms,
                    f"library_ms{suffix}": library_ms,
                    f"bound_ms{suffix}": max(bytes_ms, ops_ms),
                    f"bound_by{suffix}": ("bytes" if bytes_ms >= ops_ms
                                          else "operations"),
                    f"dispatch{suffix}": route})
        # the earlier design on the same inputs: event time, and for
        # float32 (the main path's dtype) its device time too
        simt_ms = cuda_ms(lambda: simt_masked_matmul(torch, x, w, mk, b),
                          min(iters, 3) if route == "wgmma" else iters)
        rec[f"simt_ms{suffix}"] = simt_ms
        extra = f", the SIMT kernel on the same inputs {simt_ms:.5f} ms"
        if route == "ffma":
            simt_dev = device_ms(lambda: simt_masked_matmul(torch, x, w, mk,
                                                            b), iters,
                                 device_bound=bound_calls)
            rec[f"simt_device_ms{suffix}"] = simt_dev
            extra += f" (device {simt_dev} ms)"
        log(f"phase 6 masked_matmul {m}x{k}x{n} {dtype} ({route}): "
            f"{ms:.5f} ms/call, device {dev_ms} ms, plain {plain_ms:.5f} ms, "
            f"addmm {library_ms:.5f} ms ({ms / library_ms:.2f}x), bound "
            f"{max(bytes_ms, ops_ms):.6f} ms ({moved} B, {ops} flop: "
            f"{2 * m * k * n / ms / 1e9:.1f} TFLOP/s of dense work){extra}")
    return rec


def training_profile(torch, dev, steps: int = 50) -> dict:
    """Where a training step's time goes: host-clock time per step against
    the device time ``torch.profiler`` records per step, all kernels and
    the masked matmul's alone (model A, batch 256, from the port's init)."""
    from repro_torch.configs import fpga4hep
    from repro_torch.core.train import train_logicnet
    from repro_torch.data import jet_substructure_data
    x, y = jet_substructure_data(8000, seed=0)
    args = (fpga4hep.model_a(), x[:7000], y[:7000], x[7000:], y[7000:])
    wall, total, by_name, counts = profile_split(
        torch, lambda: train_logicnet(*args, steps=steps, seed=0,
                                      device=dev), 1)
    # every masked-matmul kernel (masked_matmul_ffma_kernel on float32)
    mm = sum(t for n, t in by_name.items() if "masked_matmul" in n)
    copies = sum(c for n, c in counts.items() if "copy" in n.lower())
    out = {"train_wall_ms": wall / steps,
           "train_device_ms": total / steps,
           "train_mm_device_ms": mm / steps,
           "train_kernels_per_step": sum(counts.values()) / steps,
           "train_mm_kernels_per_step": sum(
               c for n, c in counts.items() if "masked_matmul" in n) / steps,
           "train_copy_kernels_per_step": copies / steps}
    out["train_idle_share"] = 1 - total / wall
    log(f"phase 6 training step ({steps} steps, profiled): "
        f"{out['train_wall_ms']:.3f} ms host clock, "
        f"{out['train_device_ms']:.4f} ms device "
        f"(masked matmul {out['train_mm_device_ms']:.4f} ms in "
        f"{out['train_mm_kernels_per_step']:.2f} launches), device idle "
        f"{out['train_idle_share'] * 100:.1f} %; "
        f"{out['train_kernels_per_step']:.2f} kernels a step, of which "
        f"{out['train_copy_kernels_per_step']:.2f} copies")
    return out


def flash_inputs(torch, dev, b, hq, hkv, s, d, dtype, seed=0, bshd=False):
    """Seeded (B, H, S, D) q, k and v; with ``bshd`` they are transposed
    views of (B, S, H, D) tensors, as ``attn_apply`` passes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    if bshd:
        return [torch.randn(shape, generator=g, device=dev).to(dt)
                .transpose(1, 2)
                for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    return [torch.randn(shape, generator=g, device=dev).to(dt)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def expected_flash_route(dtype: str, d: int) -> str:
    """The route phase 7 expects: a tensor-core kernel for D % 8 == 0 up
    to 256 (wgmma in bfloat16, tf32x3 in float32), else SIMT."""
    if d % 8 == 0 and d <= 256:
        return "wgmma" if dtype == "bfloat16" else "tf32x3"
    return "simt"


def flash_phase(torch, dev) -> dict:
    """Phase 7: the flash-attention kernels against their plain version."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_attention_route)
    cases = [((b, hq, hkv, s, d), dt, dict(causal=c))
             for b, hq, hkv, s, d in ((1, 2, 2, 64, 16), (2, 4, 2, 96, 32),
                                      (1, 8, 1, 128, 16), (2, 4, 4, 250, 8))
             for c in (True, False) for dt in ("float32", "bfloat16")]
    cases += [((1, 2, 2, 128, 16), "float32", dict(causal=True, window=w))
              for w in (16, 64, 1024)]
    cases += [((1, 2, 2, 64, 32), "bfloat16", dict(causal=True)),
              ((1, 4, 2, 1000, 64), "float32", dict(causal=True)),
              ((2, 16, 1, 512, 128), "bfloat16", dict(causal=True)),
              ((1, 16, 8, 1000, 128), "float32", dict(causal=False)),
              ((1, 16, 8, 2048, 128), "bfloat16",
               dict(causal=True, window=1024)),
              ((4, 16, 8, 2048, 128), "float32", dict(causal=True)),
              ((4, 16, 8, 2048, 128), "bfloat16", dict(causal=True)),
              ((1, 16, 8, LONG_SEQ, 128), "bfloat16", dict(causal=True)),
              ((1, 4, 2, 100, 12), "bfloat16", dict(causal=True)),
              ((1, 4, 2, 100, 12), "float32", dict(causal=True)),
              ((1, 2, 2, 70, 6), "float32", dict(causal=False))]
    cases = [(shape, dt, kw, False) for shape, dt, kw in cases]
    # the main path's own inputs, attn_apply's transposed (B, S, H, D)
    # views: phase 9b's float32 (tf32x3) and bfloat16 prefills of 2 x 64
    # tokens and phase 9a's bfloat16 prefill
    b, s = DECODE_CHECK_SHAPE
    cases += [((b, 16, 8, s, 128), dt, dict(causal=True), True)
              for dt in ("float32", "bfloat16")]
    cases += [((PREFILL_SHAPE[0], 16, 8, PREFILL_SHAPE[1], 128), "bfloat16",
               dict(causal=True), True)]
    n_named = len(cases)
    # the tensor-core route's grid: GQA groups 1, 2 and 8, D 16 to 256, S
    # not a multiple of its 64-row and 64- or 128-key tiles, causal or not,
    # and sliding windows
    cases += [((1, hq, hkv, s, d), "bfloat16", dict(causal=c), False)
              for hq, hkv in ((4, 4), (4, 2), (8, 1))
              for d in (16, 64, 128, 256) for s in (65, 250, 1000)
              for c in (True, False)]
    cases += [((1, 4, 2, 1000, d), "bfloat16", dict(causal=c, window=w),
               False)
              for d in (64, 128) for w in (16, 64, 1024) for c in (True, False)]
    # the same grid for the float32 tensor-core route (tf32x3), D 8 to 256
    cases += [((1, hq, hkv, s, d), "float32", dict(causal=c), False)
              for hq, hkv in ((4, 4), (4, 2), (8, 1))
              for d in (8, 64, 128, 256) for s in (65, 250, 1000)
              for c in (True, False)]
    cases += [((1, 4, 2, 1000, d), "float32", dict(causal=c, window=w),
               False)
              for d in (64, 128) for w in (16, 64, 1024) for c in (True, False)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    route_errs = {"simt": 0.0, "wgmma": 0.0, "tf32x3": 0.0}
    by_route = {"simt": 0, "wgmma": 0, "tf32x3": 0}
    gate_worst = 0.0
    for i, (shape, dtype, kw, bshd) in enumerate(cases):
        q, k, v = flash_inputs(torch, dev, *shape, dtype, seed=i, bshd=bshd)
        route = flash_attention_route(q.dtype, shape[-1])
        if route != expected_flash_route(dtype, shape[-1]):
            fail(f"flash_attention {shape} {dtype}: routed to {route}, not "
                 f"{expected_flash_route(dtype, shape[-1])}")
        before = flash_attention.launches
        before_route = flash_attention.launches_by_route[route]
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if flash_attention.launches != before + 1:
            fail(f"flash_attention {shape} {dtype}: kernel not launched")
        if flash_attention.launches_by_route[route] != before_route + 1:
            fail(f"flash_attention {shape} {dtype}: not launched on the "
                 f"{route} route ({flash_attention.launches_by_route})")
        if got.dtype != q.dtype or got.shape != q.shape:
            fail(f"flash_attention {shape} {dtype}: gave {got.dtype} "
                 f"{tuple(got.shape)}")
        if route != "simt" and not got.transpose(1, 2).is_contiguous():
            fail(f"flash_attention {shape} {dtype} ({route}): the output is "
                 f"not a view of a (B, S, H, D) buffer")
        atol, rtol, steps = FA_TOL[dtype]
        diff = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (diff > mm_limit(torch, want, atol, rtol, steps)).any()):
            fail(f"flash_attention {shape} {dtype} {kw} ({route}): max "
                 f"|kernel - plain| {float(diff.max())} beyond atol {atol} "
                 f"rtol {rtol} + {steps} {dtype} step")
        err = float(diff.max())
        errs[dtype] = max(errs[dtype], err)
        route_errs[route] = max(route_errs[route], err)
        by_route[route] += 1
        gate = ""
        if route == "tf32x3" and shape == (*PREFILL_SHAPE[:1], 16, 8,
                                           PREFILL_SHAPE[1], 128):
            # the earlier float32 design on the same inputs
            simt = flash_direct(torch, q, k, v, "simt")
            simt_diff = (got - simt).abs()
            if bool((simt_diff > mm_limit(torch, simt, *FA_TOL[dtype])).any()):
                fail(f"flash_attention {shape} float32: max |tf32x3 - SIMT| "
                     f"{float(simt_diff.max())} beyond FA_TOL float32")
            gate = (f", max |kernel - SIMT kernel| "
                    f"{float(simt_diff.max()):.3g}")
            del simt, simt_diff
        if route == "wgmma":
            ratio, rms = gate_reading(torch, got, want)
            if ratio > 1:
                fail(f"flash_attention {shape} {dtype} {kw} (wgmma): "
                     f"|kernel - plain| reaches {ratio:.3g} times the gate "
                     f"atol {FA_GATE[0]} + {FA_GATE[2]} steps")
            gate_worst = max(gate_worst, ratio)
            gate = f", {ratio:.3g} of the gate, RMS ratio {rms:.3g}"
        if i < n_named:
            views = ", (B, S, H, D) views" if bshd else ""
            log(f"phase 7 flash_attention (B, Hq, Hkv, S, D) {shape} {dtype} "
                f"{kw}{views} ({route}): max |kernel - plain| "
                f"{err:.3g}{gate}")
        del q, k, v, got, want, diff
    log(f"phase 7 flash_attention: {len(cases)} cases within tolerance "
        f"({by_route['wgmma']} on the wgmma route, {by_route['tf32x3']} on "
        f"the tf32x3 route, {by_route['simt']} on the SIMT route; the last "
        f"{len(cases) - n_named}: GQA 1/2/8, D 8-256, S 65/250/1000, "
        f"windows 16/64/1024, causal or not, in bfloat16 and float32); "
        f"largest difference float32 {errs['float32']:.3g}, bfloat16 "
        f"{errs['bfloat16']:.3g}, by route {route_errs}; wgmma cases within "
        f"{gate_worst:.3g} of the second gate (atol {FA_GATE[0]} + "
        f"{FA_GATE[2]} bfloat16 steps)")
    return {"max_abs_err": errs["float32"],
            "max_abs_err_bf16": errs["bfloat16"],
            "max_abs_err_by_route": route_errs,
            "gate_worst_ratio": gate_worst, **gate_controls(torch, dev)}


def gate_reading(torch, got, want, tol=FA_GATE) -> tuple[float, float]:
    """(largest |got - want| over the elementwise limit of ``tol``, RMS of
    got - want over RMS of want)."""
    diff = (got.float() - want.float()).abs()
    ratio = float((diff / mm_limit(torch, want, *tol)).max())
    rms = float(diff.square().mean().sqrt()
                / want.float().square().mean().sqrt())
    return ratio, rms


def gate_controls(torch, dev) -> dict:
    """Phase 7, the second gate's readings at (4, 16, 2048, 128) and
    (1, 16, 32768, 128), bfloat16 causal, Hkv 8, each against the plain
    version: the kernel; the kernel with P rounded to bfloat16 (the design
    the hi + lo split replaced); and a stale-stage control, the plain
    version on inputs whose middle 128-key K/V tile is replaced by the one
    two tiles before it, as a kernel would compute that read a 2-stage
    ring's slot before its refill landed.  Fails unless the gate passes
    the kernel and rejects the stale stage."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    out = {}
    for suffix, (b, s) in (("", PREFILL_SHAPE), ("_32k", (1, LONG_SEQ))):
        q, k, v = flash_inputs(torch, dev, b, 16, 8, s, 128, "bfloat16")
        want = flash_attention_plain(q, k, v, causal=True)
        t = s // 128 // 2
        stale = [x.clone() for x in (k, v)]
        for x, src in zip(stale, (k, v)):
            x[:, :, t * 128:(t + 1) * 128] = src[:, :, (t - 2) * 128:
                                                 (t - 1) * 128]
        got = {"kernel": flash_attention(q, k, v, causal=True),
               "p_rounded": flash_direct(torch, q, k, v, "wgmma",
                                         split_p=False),
               "stale_stage": flash_attention_plain(q, *stale, causal=True)}
        torch.cuda.synchronize()
        read = {name: gate_reading(torch, g, want) for name, g in got.items()}
        tol = {name: gate_reading(torch, g, want, FA_TOL["bfloat16"])[0]
               for name, g in got.items()}
        for name, (ratio, rms) in read.items():
            out[f"gate_{name}{suffix}"] = [ratio, rms, tol[name]]
        if read["kernel"][0] > 1 or read["stale_stage"][0] <= 1:
            fail(f"flash_attention gate at ({b}, 16, 8, {s}, 128): kernel "
                 f"{read['kernel'][0]:.3g}, stale-stage control "
                 f"{read['stale_stage'][0]:.3g} of the limit (the kernel "
                 f"must pass, the control fail)")
        log(f"phase 7 second gate at (B, Hq, Hkv, S, D) ({b}, 16, 8, {s}, "
            f"128) causal, max |x - plain| over the gate's limit, RMS "
            f"ratio, max over FA_TOL's limit: " + "; ".join(
                f"{name} {r:.3g} / {m:.3g} / {tol[name]:.3g}"
                for name, (r, m) in read.items())
            + " (the stale stage rejected)")
        del q, k, v, want, got, stale
        torch.cuda.empty_cache()
    return out


def lm_check(name, got, want, dtype) -> float:
    import numpy as np
    got = got.float().cpu().numpy()
    atol, rtol = LM_TOL[dtype]
    diff = np.abs(got - want)
    if got.shape != want.shape or not np.isfinite(got).all() or bool(
            (diff > atol + rtol * np.abs(want)).any()):
        fail(f"{name}: {got.shape} vs {want.shape}, max |port - reference| "
             f"{float(diff.max())} beyond atol {atol} rtol {rtol}")
    return float(diff.max())


def lm_smoke_phase(torch, dev) -> dict:
    """Phase 8: the smoke LMs with the reference's params against the
    reference's outputs (``lm_smoke.npz``)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve_lm
    from repro_torch.models import model as M

    with np.load(FIXTURE / "lm_smoke.npz") as z:
        fx = {k: z[k] for k in z.files}
    out = {}
    for arch in ("qwen3-1.7b", "gemma3-27b"):
        pre = f"{arch}.params."
        arrays = {k[len(pre):]: v for k, v in fx.items()
                  if k.startswith(pre)}
        tokens = torch.from_numpy(fx[f"{arch}.tokens"]).to(dev)
        for cd in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      compute_dtype=cd)
            model = M.from_reference(cfg, arrays, device=dev)
            before = flash_attention.launches
            logits = M.forward(model, {"tokens": tokens})
            torch.cuda.synchronize()
            if flash_attention.launches - before != cfg.n_layers:
                fail(f"{arch} {cd} prefill launched flash_attention "
                     f"{flash_attention.launches - before} times, not "
                     f"{cfg.n_layers}")
            e_pre = lm_check(f"{arch} {cd} prefill", logits,
                             fx[f"{arch}.{cd}.prefill"], cd)
            want = fx[f"{arch}.{cd}.decode"]
            cache = {k: v.to(getattr(torch, cd)) for k, v in
                     M.init_cache(cfg, 2, want.shape[1], device=dev).items()}
            steps = []
            for t in range(want.shape[1]):
                lg, cache = M.decode_step(
                    model, cache, tokens[:, t:t + 1],
                    torch.full((2,), t, dtype=torch.int32, device=dev))
                steps.append(lg[:, 0])
            e_dec = lm_check(f"{arch} {cd} decode", torch.stack(steps, 1),
                             want, cd)
            msg = ""
            if cd == "float32":
                res = serve_lm.serve(cfg, model, requests=5, slots=2,
                                     max_new=6, cache_len=64)
                ids = [r["id"] for r in res.done]
                toks = [r["out"] for r in res.done]
                if (ids != fx[f"{arch}.{cd}.serve_ids"].tolist()
                        or toks != fx[f"{arch}.{cd}.serve_out"].tolist()):
                    fail(f"{arch} serve tokens differ from the reference's: "
                         f"{list(zip(ids, toks))}")
                msg = f"; serve: {len(ids)} requests, tokens equal"
            out[f"{arch}.{cd}"] = max(e_pre, e_dec)
            log(f"phase 8 {arch} {cd}: prefill max |port - reference| "
                f"{e_pre:.3g}, decode {e_dec:.3g} (atol/rtol "
                f"{LM_TOL[cd][0]}){msg}")
    return out


def lm_main_path(torch, dev, kernels) -> dict:
    """Phase 9: qwen3-1.7b at full width, every launch counter at 0."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.masked_matmul import masked_matmul
    from repro_torch.launch import serve_lm, steps
    from repro_torch.models import model as M

    cfg = get_config(FULL_ARCH)
    t0 = time.perf_counter()
    model = steps.init_params(cfg, seed=0, device=dev)
    model.compute_params()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 9 {FULL_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, Hq {cfg.n_heads}, Hkv {cfg.n_kv_heads}, head_dim "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab}: {n_params} parameters "
        f"drawn and cast to {cfg.compute_dtype} in "
        f"{time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")

    for k in kernels.values():
        reset_counts(k["wrapper"])
    reset_counts(masked_matmul)
    reset_counts(flash_attention)
    torch.cuda.synchronize()

    # (a) prefill of 4 x 2048 tokens
    b, s = PREFILL_SHAPE
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    prefill = steps.make_prefill_step(cfg)
    t0 = time.perf_counter()
    logits = prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    a_launches = flash_attention.launches
    if a_launches != cfg.n_layers:
        fail(f"prefill launched flash_attention {a_launches} times, not "
             f"{cfg.n_layers}")
    if flash_attention.launches_by_route["wgmma"] != cfg.n_layers:
        fail(f"prefill's flash launches did not all take the tensor-core "
             f"route: {flash_attention.launches_by_route}")
    if logits.shape != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"prefill logits {tuple(logits.shape)} not finite or not "
             f"({b}, {cfg.vocab})")
    log(f"phase 9a prefill {b} x {s} tokens: flash_attention launched "
        f"{a_launches} times (one per layer, all on the wgmma route), "
        f"logits {tuple(logits.shape)} "
        f"finite, first call {first_ms:.1f} ms (host clock, synchronised)")

    # (b) decode one token at a time against prefill: at float32 compute
    # with a float32 cache (the same weights; only the summation order
    # differs) and at the config's bfloat16 compute, where 28 layers of
    # bfloat16 rounding in two summation orders (GEMM against GEMV shapes)
    # move a logit by about 0.012 on average: the reference's 0.05 contract
    # (a 2-layer smoke model's) must hold for all but 1e-4 of the logits,
    # and every row's top-1 token must agree
    d_tokens = tokens[:DECODE_CHECK_SHAPE[0],
                      :DECODE_CHECK_SHAPE[1]].contiguous()
    f32 = M.LM(dataclasses.replace(cfg, compute_dtype="float32"),
               {"embed": dict(model.embed), "final_norm": model.final_norm,
                "layers": [layer.tree() for layer in model.layers]})
    diffs = {}
    for name, m in (("float32", f32), ("bfloat16", model)):
        before = dict(flash_attention.launches_by_route)
        want = steps.make_prefill_step(m.cfg)(m, {"tokens": d_tokens}).float()
        route = "tf32x3" if name == "float32" else "wgmma"
        ran = flash_attention.launches_by_route[route] - before[route]
        if ran != cfg.n_layers or sum(
                flash_attention.launches_by_route.values()) - sum(
                    before.values()) != cfg.n_layers:
            fail(f"the {name} prefill launched flash_attention {ran} times "
                 f"on the {route} route, not all {cfg.n_layers} "
                 f"({flash_attention.launches_by_route})")
        cache = M.init_cache(cfg, *DECODE_CHECK_SHAPE, device=dev)
        if name == "float32":
            cache = {k: v.float() for k, v in cache.items()}
        decode = steps.make_decode_step(m.cfg)
        for t in range(d_tokens.shape[1]):
            got, cache = decode(m, cache, d_tokens[:, t:t + 1],
                                torch.full((d_tokens.shape[0],), t,
                                           dtype=torch.int32, device=dev))
        diff = (got.float() - want).abs()
        tol = 1e-4 if name == "float32" else 0.05
        over = int((diff > tol + tol * want.abs()).sum())
        top1 = got.argmax(-1).tolist(), want.argmax(-1).tolist()
        diffs[name] = float(diff.max())
        p999 = float(diff.flatten().kthvalue(int(diff.numel() * 0.999))[0])
        log(f"phase 9b {name} compute: prefill's {cfg.n_layers} flash "
            f"launches on the {route} route; {d_tokens.shape[0]} prompts x "
            f"{d_tokens.shape[1]} tokens decoded "
            f"one at a time: last logits within {diffs[name]:.5f} of "
            f"prefill's "
            f"(mean {float(diff.mean()):.5f}, 99.9th percentile "
            f"{p999:.5f}; {over} of {diff.numel()} beyond atol {tol} + rtol "
            f"{tol}); top-1 tokens {top1[0]} vs {top1[1]}")
        allowed = 0 if name == "float32" else diff.numel() * 1e-4
        if over > allowed or top1[0] != top1[1]:
            fail(f"{name} compute: decode's last logits differ from "
                 f"prefill's by up to {diffs[name]}: {over} of "
                 f"{diff.numel()} beyond atol {tol} + rtol {tol} "
                 f"(allowed {allowed:.0f}), top-1 {top1}")
    del f32, cache

    # (c) the server at the CLI defaults
    res = serve_lm.serve(cfg, model)
    if len(res.done) != 12 or any(len(r["out"]) != 24 for r in res.done):
        fail(f"served {len(res.done)} of 12 requests")
    step_ms = res.seconds / res.steps * 1e3
    log(f"phase 9c served {len(res.done)} requests, {res.tokens} tokens in "
        f"{res.steps} decode steps: {step_ms:.3f} ms/step (host clock, "
        f"synchronised every step), {res.tokens / res.seconds:.1f} "
        f"tokens/s, occupancy {res.occupancy:.2f}")
    lut_launches = sum(w.launches for w in {
        id(k["wrapper"]): k["wrapper"] for k in kernels.values()}.values())
    launches = flash_attention.launches
    log(f"phase 9 main path launches: flash_attention_forward {launches} "
        f"({cfg.n_layers} per prefill, {launches // cfg.n_layers} "
        f"prefills; by route {flash_attention.launches_by_route}), "
        f"masked_matmul_forward "
        f"{masked_matmul.launches}, LUT kernels {lut_launches}")
    return {"model": model, "cfg": cfg, "tokens": tokens,
            "launches": launches,
            "launches_by_route": dict(flash_attention.launches_by_route),
            "prefill_first_ms": first_ms,
            "decode_step_ms": step_ms,
            "decode_tokens_per_s": res.tokens / res.seconds,
            "decode_vs_prefill_max_abs": diffs["bfloat16"],
            "decode_vs_prefill_max_abs_f32": diffs["float32"]}


def sdpa(q, k, v):
    """``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    held to its fused backends, so it never builds the (S x S) scores."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)


def path_times(torch, dev, path: dict) -> dict:
    """Phase 10, the path: a prefill's host-clock time against its
    profiled device time, and a decode step's."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    model, cfg, tokens = path["model"], path["cfg"], path["tokens"]
    prefill = steps.make_prefill_step(cfg)
    wall, total, by_name, _ = profile_split(
        torch, lambda: prefill(model, {"tokens": tokens}), 3)
    fa = sum(t for n, t in by_name.items() if "flash_attention" in n)
    # the same shape as the kernel's timing at PREFILL_SHAPE, one layer
    rec = {"device_ms_in_prefill": fa / cfg.n_layers,
           "prefill_wall_ms": wall, "prefill_device_ms": total,
           "prefill_flash_device_ms": fa, "prefill_flash_share": fa / total,
           "prefill_idle_share": 1 - total / wall}
    log(f"phase 10 prefill {PREFILL_SHAPE[0]} x {PREFILL_SHAPE[1]} "
        f"(profiled, 3 calls): {wall:.2f} ms host clock, {total:.2f} ms "
        f"device, flash_attention_forward {fa:.2f} ms "
        f"({fa / total * 100:.1f} % of device time), device idle "
        f"{(1 - total / wall) * 100:.1f} %; top kernels (ms/call): "
        f"{top_kernels(by_name)}")

    cache = M.init_cache(cfg, 4, 128, device=dev)
    tok = tokens[:, :1].contiguous()
    pos = torch.zeros((4,), dtype=torch.int32, device=dev)
    decode = steps.make_decode_step(cfg)
    wall, total, by_name, _ = profile_split(
        torch, lambda: decode(model, cache, tok, pos)[0].argmax(-1).cpu(),
        20)
    rec.update({"decode_wall_ms": wall, "decode_device_ms": total,
                "decode_idle_share": 1 - total / wall,
                "decode_step_ms": path["decode_step_ms"],
                "decode_tokens_per_s": path["decode_tokens_per_s"]})
    log(f"phase 10 decode step, 4 slots, cache 128 (profiled, 20 steps): "
        f"{wall:.3f} ms host clock, {total:.3f} ms device, device idle "
        f"{(1 - total / wall) * 100:.1f} %; top kernels (ms/step): "
        f"{top_kernels(by_name)}")
    return rec


def flash_direct(torch, q, k, v, route: str, split_p: bool = True):
    """One kernel of ``route`` called directly on bfloat16, causal,
    bypassing the route rule (and the launch counts): the SIMT kernel is
    the earlier design; the wgmma kernel with ``split_p=False`` rounds P
    to bfloat16 (one P V product), the design the hi + lo split replaced.
    Both are timed beside the kernel in the same run."""
    from repro_torch.kernels import flash_attention as FA
    b, hq, s, d = q.shape
    if route == "simt":
        out = torch.empty_like(q)
        FA._launch_simt(q, k, v, out, True, None, 1.0 / d ** 0.5)
    else:
        out = torch.empty((b, s, hq, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        FA._launch_wgmma(q, k, v, out, True, None, 1.0 / d ** 0.5,
                         split_p=split_p)
    return out


def flash_times(torch, dev) -> dict:
    """Phase 10, the kernel: event and device times beside its bound, the
    plain version, SDPA and the earlier SIMT design, at the prefill shape
    and at one layer of a 32k sequence."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    rec = {}
    for suffix, (b, s), iters, reps in (("", PREFILL_SHAPE, 5, 7),
                                        ("_32k", (1, LONG_SEQ), 1, 3)):
        q, k, v = flash_inputs(torch, dev, b, 16, 8, s, 128, "bfloat16")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters,
                     reps)
        rounded_ms = cuda_ms(lambda: flash_direct(torch, q, k, v, "wgmma",
                                                  split_p=False), iters, reps)
        dev_ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                           5, device_bound=True)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                         causal=True),
                           iters, reps)
        library_ms = cuda_ms(lambda: sdpa(q, k, v), iters, reps)
        simt_ms = cuda_ms(lambda: flash_direct(torch, q, k, v, "simt"), 1,
                          3)
        moved = nbytes(q, k, v) + q.numel() * q.element_size()
        pairs = s * (s + 1) // 2
        ops = 4 * b * 16 * 128 * pairs
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FLOPS_PER_S["bfloat16"] * 1e3
        rec.update({f"ms{suffix}": ms, f"device_ms{suffix}": dev_ms,
                    f"plain_ms{suffix}": plain_ms,
                    f"library_ms{suffix}": library_ms,
                    f"simt_ms{suffix}": simt_ms,
                    f"p_rounded_ms{suffix}": rounded_ms,
                    f"bound_ms{suffix}": max(bytes_ms, ops_ms),
                    f"bound_by{suffix}": ("bytes" if bytes_ms >= ops_ms
                                          else "operations"),
                    f"shape{suffix}": [b, 16, 8, s, 128]})
        log(f"phase 10 flash_attention_forward (B, Hq, Hkv, S, D) "
            f"({b}, 16, 8, {s}, 128) bfloat16 causal (wgmma): {ms:.4f} "
            f"ms/call, device {dev_ms} ms (back to back), plain "
            f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
            f"({ms / library_ms:.2f}x), the SIMT kernel {simt_ms:.4f} ms, "
            f"P rounded (one P V product) {rounded_ms:.4f} ms (the split "
            f"costs {(ms / rounded_ms - 1) * 100:.1f} %), "
            f"bound {max(bytes_ms, ops_ms):.5f} ms ({moved} B, {ops} flop: "
            f"{ops / ms / 1e9:.1f} TFLOP/s achieved)")
        del q, k, v
        torch.cuda.empty_cache()
    return rec


def flash_f32_times(torch, dev) -> dict:
    """Phase 10, the float32 route (the tf32x3 kernel, which phase 9b's
    float32 prefill runs) at the prefill shape: event and device time beside
    the SIMT kernel called directly on the same inputs (the earlier design,
    also event and device time), the plain version, SDPA with
    ``enable_gqa`` on the same float32 tensors (its math backend: no fused
    backend takes float32 GQA), SDPA's memory-efficient backend on K and V
    expanded to Hq heads outside the timed call (the fused float32 kernel
    the route is measured against: three TF32 products a product, as
    here), timed in turns with the kernel, and two bounds: the route's, its
    operations three times over at the 495 TFLOP/s dense TF32 rate, and the
    SIMT route's, once at the 67 TFLOP/s float32 CUDA-core rate.  Returns
    the kernel's record, whose ``library_ms`` is the memory-efficient
    backend's time (K and V expanded outside the timed call) and
    ``library_math_ms`` the math backend's."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_attention_route)
    b, s = PREFILL_SHAPE
    q, k, v = flash_inputs(torch, dev, b, 16, 8, s, 128, "float32")
    route = flash_attention_route(q.dtype, 128)
    if route != "tf32x3":
        fail(f"float32 flash attention routes to {route}, not tf32x3")
    ke, ve = (t.repeat_interleave(2, dim=1) for t in (k, v))

    def kernel():
        return flash_attention(q, k, v, causal=True)

    def efficient():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, ke, ve, is_causal=True)

    # in turns, kernel and yardstick twice each, in one run
    runs = {"kernel": [], "efficient": []}
    for name in ("efficient", "kernel", "kernel", "efficient"):
        runs[name].append(cuda_ms(kernel if name == "kernel" else efficient,
                                  5, 7))
    ms = statistics.mean(runs["kernel"])
    fused_ms = statistics.mean(runs["efficient"])
    dev_ms = device_ms(kernel, 5, device_bound=True)
    simt_ms = cuda_ms(lambda: flash_direct(torch, q, k, v, "simt"), 3, 5)
    simt_dev = device_ms(lambda: flash_direct(torch, q, k, v, "simt"), 3,
                         device_bound=True)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                       1, 3)
    math_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 3, 5)
    moved = nbytes(q, k, v) + q.numel() * q.element_size()
    ops = 4 * b * 16 * 128 * (s * (s + 1) // 2)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = TF32_PRODUCTS * ops / TF32_FLOPS_PER_S * 1e3
    simt_ops_ms = ops / FLOPS_PER_S["float32"] * 1e3
    log(f"phase 10 flash_attention_tf32_forward (B, Hq, Hkv, S, D) ({b}, 16, "
        f"8, {s}, 128) float32 causal ({route}): {ms:.4f} ms/call "
        f"({runs['kernel']}), device {dev_ms} ms (back to back); SDPA "
        f"memory-efficient on K, V expanded {fused_ms:.4f} ms "
        f"({runs['efficient']}): the kernel is {ms / fused_ms:.3f}x it; the "
        f"SIMT kernel (earlier design) {simt_ms:.4f} ms, device {simt_dev} "
        f"ms; plain {plain_ms:.4f} ms; SDPA (enable_gqa, math backend) "
        f"{math_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.5f} ms ({moved} "
        f"B, {ops} flop x {TF32_PRODUCTS} at 495 TFLOP/s TF32; the SIMT "
        f"route's {max(bytes_ms, simt_ops_ms):.5f} ms at 67 TFLOP/s): "
        f"{ops / ms / 1e9:.1f} TFLOP/s of float32 work achieved")
    return {"ms": ms, "ms_runs": runs["kernel"], "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": fused_ms,
            "library_ms_runs": runs["efficient"],
            "vs_library": ms / fused_ms, "library_math_ms": math_ms,
            "simt_ms": simt_ms, "simt_device_ms": simt_dev,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "simt_bound_ms": max(bytes_ms, simt_ops_ms),
            "shape": [b, 16, 8, s, 128]}


def http_get(port: int, path: str) -> tuple[int, str]:
    """One ``GET`` against a localhost ingress (30 s timeout)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def counter_value(snap: dict, name: str, **labels) -> float:
    for s in snap.get(name, {}).get("series", []):
        if s["labels"] == labels:
            return s["value"]
    return 0.0


def block_b_spread(timings: dict) -> tuple[dict, dict]:
    """Per (layout, pack): the spread of the variants that differ only in
    block_b, (max - min) / min, and the group's best over the table's
    best (the gap between layouts)."""
    groups: dict[str, list[float]] = {}
    for key, us in timings.items():
        layout, _, pack = key.split("/")
        groups.setdefault(f"{layout}/{pack}", []).append(us)
    best = min(timings.values())
    return ({g: (max(v) - min(v)) / min(v) for g, v in groups.items()},
            {g: min(v) / best for g, v in groups.items()})


def serving_front_phase(torch, dev, kernels, ref, ref_d, triples) -> dict:
    """Phase 11: the serving front, the HTTP ingress (a) and the variant
    autotuner (b) on the card, then both serving commands of the CLI (c)."""
    import asyncio
    import tempfile

    import numpy as np

    from repro_torch import engine, obs, serve
    from repro_torch.checkpoint.ckpt import load_arrays, save_arrays
    from repro_torch.compile import optimize, tables_from_triples
    from repro_torch.engine.autotune import backend_of
    from repro_torch.kernels import enumerate_variants
    from repro_torch.kernels.lut_lookup import lut_lookup
    from repro_torch.kernels.lut_network import (lut_network,
                                                 lut_network_mixed)

    wrappers = (lut_network_mixed, lut_network, lut_lookup)
    out = {"http": {}, "autotune": {}, "autotune_launches": {}}

    def infer(port, codes, raw):
        return asyncio.run(asyncio.wait_for(serve.http_infer(
            "127.0.0.1", port, codes, raw=raw, timeout_s=60), 120))

    # (a) HTTP: model A at level 3 as the port compiled it (mixed, smem),
    # then model D's raw tables (per-layer, by the engine's choice)
    for key in ("mixed", "per_layer_d"):
        k = kernels[key]
        net, want = k["net"], k["want"]
        rows = k["codes"].cpu().numpy()
        for w in wrappers:
            reset_counts(w)
        with serve.BackgroundIngress(net) as ing:
            for raw in (True, False):
                got = infer(ing.port, rows, raw)
                if not np.array_equal(got, want):
                    fail(f"phase 11a {key}: {len(rows)} rows over HTTP "
                         f"({'raw' if raw else 'JSON'}) differ from the "
                         f"reference's outputs")
            # the same arrivals and requests over HTTP and in process, in
            # turns: the difference is what the HTTP leg adds
            load = dict(offered_rps=400.0, n_requests=64, rows_min=1,
                        rows_max=8, bw=k["bw"], seed=0)
            turns = {"http": [], "in_process": []}
            h0 = obs.registry().snapshot()
            for how in ("http", "in_process", "in_process", "http"):
                r = (serve.run_open_loop(url=ing.url, verify_net=net, **load)
                     if how == "http" else serve.run_open_loop(net, **load))
                if r.outcomes != {"ok": 64}:
                    fail(f"phase 11a {key}: open loop ({how}) gave "
                         f"{r.outcomes}")
                turns[how].append(r)
            h1 = obs.registry().snapshot()
            rep = turns["http"][0]
            status, page = http_get(ing.port, "/metrics")
            st = ing.stats()
        server_ms = {}
        for name in ("ingress_request_seconds", "ingress_decode_seconds",
                     "ingress_infer_seconds"):
            a, b = h0[name]["series"][0], h1[name]["series"][0]
            server_ms[name] = ((b["sum"] - a["sum"])
                               / max(1, b["count"] - a["count"]) * 1e3)
        mean = {how: {m: statistics.mean(getattr(r, m) for r in rs)
                      for m in ("p50_ms", "p99_ms", "rows_per_sec")}
                for how, rs in turns.items()}
        if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
            fail(f"phase 11a {key}: compile-once contract broken: {st}")
        families = ("serve_requests_total", "serve_batches_total",
                    "serve_request_latency_seconds",
                    "ingress_requests_total", "ingress_infer_seconds",
                    "ingress_decode_seconds", "ingress_open_connections")
        missing = [f for f in families if f"# TYPE {f} " not in page]
        if status != 200 or missing:
            fail(f"phase 11a {key}: GET /metrics {status}, missing "
                 f"{missing}")
        wrapper = k["wrapper"]
        by_route = dict(wrapper.launches_by_route)
        launched = wrapper.launches
        others = sum(w.launches for w in wrappers if w is not wrapper)
        if not launched or others:
            fail(f"phase 11a {key}: {k['name']} launched {launched} times, "
                 f"the other LUT kernels {others}")
        if "routes" in k and (by_route["global"]
                              or by_route["smem"] != launched):
            fail(f"phase 11a {key}: {k['name']} left the smem route: "
                 f"{by_route}")
        if "layer_routes" in k and sum(by_route.values()) != launched:
            fail(f"phase 11a {key}: {k['name']} routes {by_route} for "
                 f"{launched} launches")
        # the quota case: 200 rows/s, burst 16, against about 1800 rows/s
        # offered
        quota = serve.IngressConfig(quota=serve.QuotaConfig(
            rate_rows_per_s=200.0, burst_rows=16.0))
        before = obs.registry().snapshot()
        with serve.BackgroundIngress(net, config=quota) as ing:
            q = serve.run_open_loop(
                url=ing.url, offered_rps=400.0, n_requests=64, rows_min=1,
                rows_max=8, bw=k["bw"], seed=1, tenant="smoke",
                verify_net=net)
            qst = ing.stats()
        after = obs.registry().snapshot()
        delta = (counter_value(after, "ingress_rejected_total",
                               reason="quota")
                 - counter_value(before, "ingress_rejected_total",
                                 reason="quota"))
        n_quota = q.outcomes.get("rejected_quota", 0)
        if not n_quota or delta != n_quota or q.rejected != n_quota:
            fail(f"phase 11a {key}: quota run {q.outcomes}, "
                 f"ingress_rejected_total{{reason=quota}} rose by {delta}")
        if qst["retraces_after_warmup"] or qst["compiler_runs_after_warmup"]:
            fail(f"phase 11a {key}: compile-once contract broken: {qst}")
        p2 = k["phase2"]
        out["http"][key] = {
            "launches": launched, "launches_by_route": by_route,
            "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
            "rows_per_sec": rep.rows_per_sec, "quota": dict(q.outcomes),
            "turns_mean": mean, "server_mean_ms": server_ms}
        log(f"phase 11a HTTP {key} (model {k['model']}, {net.layout}): "
            f"{len(rows)} rows raw and JSON bit-exact; open loop 400 rps x "
            f"64 requests ({rep.rows} rows) all ok and bit-exact, "
            f"p50={rep.p50_ms:.3f} ms p99={rep.p99_ms:.3f} ms "
            f"{rep.rows_per_sec:.0f} rows/s over HTTP (phase 2 in process: "
            f"p50={p2['p50_ms']:.3f} p99={p2['p99_ms']:.3f} "
            f"{p2['rows_per_sec']:.0f} rows/s); in turns (http, in "
            f"process, in process, http), mean of two: HTTP p50 "
            f"{mean['http']['p50_ms']:.3f} p99 {mean['http']['p99_ms']:.3f} "
            f"ms against in process p50 {mean['in_process']['p50_ms']:.3f} "
            f"p99 {mean['in_process']['p99_ms']:.3f} ms on the same "
            f"arrivals; server side a request mean "
            f"{server_ms['ingress_request_seconds']:.3f} ms (decode "
            f"{server_ms['ingress_decode_seconds']:.4f}, tier "
            f"{server_ms['ingress_infer_seconds']:.3f}); quota 200 rows/s "
            f"burst 16: "
            f"{q.outcomes}, ingress_rejected_total{{reason=quota}} +"
            f"{delta:.0f}; {k['name']} launches={launched} by route "
            f"{by_route}; retraces={st['retraces_after_warmup']} "
            f"compiler_runs={st['compiler_runs_after_warmup']}")

    # (b) autotune: models A and D compiled at level 3, every variant
    # timed on the card, then saved, loaded and replayed
    backend = backend_of(dev)
    launches_total = {w.__name__: 0 for w in wrappers}
    names = {"lut_network_mixed": "lut_mixed_forward",
             "lut_network": "lut_uniform_forward",
             "lut_lookup": "lut_layer_forward"}
    layout_wrapper = {"mixed": lut_network_mixed, "uniform": lut_network,
                      "per_layer": lut_lookup}
    codes_of = {"A": ref["codes"], "D": ref_d["codes"]}
    want_of = {"A": ref["out_mixed"], "D": ref_d["out_uniform"]}
    for model, trip in triples.items():
        res = optimize(tables_from_triples(trip), 3, in_features=16)
        uniform = [(t.indices, t.table, t.bw_in) for t in res.tables]
        expected = [v.key for v in enumerate_variants(
            uniform, res.mixed_tables, block_bs=(16, 64, 128, 256))]
        for w in wrappers:
            reset_counts(w)
        runs0 = engine.compile_runs()
        snap0 = obs.registry().snapshot()
        net = engine.compile_network(trip, optimize_level=3,
                                     in_features=16, block_b=16,
                                     autotune=True, device=dev)
        plan = net.plan
        timed = (sum(s["value"] for s in obs.registry().snapshot()[
            "engine_autotune_variants_total"]["series"])
            - sum(s["value"] for s in snap0.get(
                "engine_autotune_variants_total", {}).get("series", [])))
        if engine.compile_runs() != runs0 + 1:
            fail(f"phase 11b model {model}: {engine.compile_runs() - runs0} "
                 f"compiler runs for one autotuned build")
        if list(plan.timings_us) != expected or timed != len(expected):
            fail(f"phase 11b model {model}: timed {list(plan.timings_us)} "
                 f"({timed} counted), enumerated {expected}")
        for layout in {key.split("/")[0] for key in expected}:
            if not layout_wrapper[layout].launches:
                fail(f"phase 11b model {model}: no {layout} launch")
        for w in wrappers:
            launches_total[w.__name__] += w.launches
        plain = [key for key, r in plan.routes.items() if r == "plain"]
        if plain or set(plan.routes) != set(expected):
            fail(f"phase 11b model {model}: routes {plan.routes}")
        argmin = min(plan.timings_us, key=plan.timings_us.get)
        if plan.variant.key != argmin or plan.source != "autotune":
            fail(f"phase 11b model {model}: chose {plan.variant.key}, the "
                 f"table's argmin is {argmin}")
        if plan.backend != backend or not net.measured_here:
            fail(f"phase 11b model {model}: backend {plan.backend!r}")
        if net.block_b != plan.block_b:
            fail(f"phase 11b model {model}: serves at {net.block_b}, plan "
                 f"{plan.block_b}")
        x = torch.from_numpy(codes_of[model]).to(dev)
        got = net(x).cpu().numpy()
        if not np.array_equal(got, want_of[model]):
            fail(f"phase 11b model {model}: the autotuned artifact's "
                 f"outputs differ from the reference's")
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / f"model_{model.lower()}_tuned.npz")
            net.save(path)
            runs0 = engine.compile_runs()
            snap0 = obs.registry().snapshot()
            loaded = engine.load(path, device=dev)
            same = np.array_equal(loaded(x).cpu().numpy(), got)
            retimed = (obs.registry().snapshot()
                       ["engine_autotune_variants_total"]
                       != snap0["engine_autotune_variants_total"])
            if (engine.compile_runs() != runs0 or retimed or not same
                    or loaded.plan != plan or not loaded.measured_here):
                fail(f"phase 11b model {model}: load ran "
                     f"{engine.compile_runs() - runs0} compiler runs, "
                     f"searched again {retimed}, same outputs {same}, "
                     f"measured here {loaded.measured_here}")
            arrays, meta = load_arrays(path)
            meta["plan"].pop("backend")
            save_arrays(path, arrays, meta)
            foreign = engine.load(path, device=dev)
            if (foreign.measured_here or foreign.plan.source != "autotune"
                    or not np.array_equal(foreign(x).cpu().numpy(), got)):
                fail(f"phase 11b model {model}: a plan without its "
                     f"backend loads as measured here "
                     f"({foreign.measured_here})")
        # the search again on the same tables: block_b-only variants do
        # the same work at 256 rows, so their order is the host's noise
        plan2, _ = engine.autotune_network(
            uniform, res.mixed_tables, in_features=16, block_b=16,
            device=dev)
        spread1, gap1 = block_b_spread(plan.timings_us)
        spread2, gap2 = block_b_spread(plan2.timings_us)
        log(f"phase 11b autotune model {model} at level 3 on {backend} "
            f"({plan.batch} rows, {len(expected)} variants; winner run 1 "
            f"{plan.variant.key}, run 2 {plan2.variant.key}; heuristic "
            f"{plan.default_key}); key, route, us a forward run 1 / run 2:")
        for key in expected:
            log(f"phase 11b   {key:24s} {plan.routes[key]:7s} "
                f"{plan.timings_us[key]:9.2f} / {plan2.timings_us[key]:9.2f}")
        log(f"phase 11b model {model}: spread of block_b-only variants "
            f"(max-min)/min run 1 "
            + ", ".join(f"{g} {v:.3f}" for g, v in spread1.items())
            + "; run 2 " + ", ".join(f"{g} {v:.3f}"
                                     for g, v in spread2.items())
            + "; gap between layouts (group best / table best) run 1 "
            + ", ".join(f"{g} {v:.3f}" for g, v in gap1.items())
            + "; run 2 " + ", ".join(f"{g} {v:.3f}" for g, v in gap2.items())
            + "; outputs bit-exact with the reference's, save/load: 0 "
              "compiler runs, 0 variants timed, same outputs; backend "
              "stripped: measured_here False")
        out["autotune"][model] = {
            "winner": plan.variant.key, "winner_run2": plan2.variant.key,
            "default_key": plan.default_key, "routes": plan.routes,
            "timings_us": plan.timings_us,
            "timings_us_run2": plan2.timings_us,
            "block_b_spread": [spread1, spread2],
            "layout_gap": [gap1, gap2]}
    out["autotune_launches"] = {names[n]: c
                                for n, c in launches_total.items()}

    # (c) the CLI's two serving commands, as a user runs them
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra, must in ((["--http", "0"], ("responses verified bit-exact "
                                           "over HTTP",)),
                        (["--autotune"], (f"autotuned on {backend}",))):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--lut",
               *extra, "--smoke", "--report-every-s", "0"]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines()
                 if "autotuned on" in ln or "latency" in ln
                 or "contract" in ln]
        if (proc.returncode
                or "retraces=0 compiler_runs=0 after warmup"
                not in proc.stdout
                or any(m not in proc.stdout for m in must)):
            fail(f"phase 11c {' '.join(cmd[2:])}: rc {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        log(f"phase 11c {' '.join(cmd[3:])}: rc 0; " + " | ".join(lines))
    return out


def legacy_api_phase(torch, dev, ref, triples) -> dict:
    """Phase 12a: the legacy flag API (``repro_torch.kernels.ops``) on the
    card, through the engine's memo."""
    import numpy as np

    from repro_torch import engine, obs
    from repro_torch.configs import fpga4hep
    from repro_torch.core import logicnet as LN
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lut_lookup import lut_lookup
    from repro_torch.kernels.lut_network import (lut_network,
                                                 lut_network_mixed)
    from repro_torch.kernels.masked_matmul import masked_matmul

    wrappers = (lut_network_mixed, lut_network, lut_lookup, masked_matmul,
                flash_attention)
    for w in wrappers:
        reset_counts(w)

    def memo_hits():
        return counter_value(obs.registry().snapshot(),
                             "engine_memo_hits_total")

    codes = torch.from_numpy(ref["codes"]).to(dev)
    engine.cache_clear()
    runs0, hits0 = engine.compile_runs(), memo_hits()
    first = ops.lut_network(codes, triples, fused=True, optimize_level=3)
    runs1, hits1 = engine.compile_runs(), memo_hits()
    second = ops.lut_network(codes, triples, fused=True, optimize_level=3)
    runs2, hits2 = engine.compile_runs(), memo_hits()
    torch.cuda.synchronize()
    want = torch.from_numpy(ref["out_mixed"]).to(dev)
    for name, out in (("first", first), ("second", second)):
        if not torch.equal(out, want):
            fail(f"phase 12a ops.lut_network(fused=True, optimize_level=3) "
                 f"{name} call differs from the reference's outputs")
    if (runs1 - runs0, runs2 - runs1, hits2 - hits1) != (1, 0, 1):
        fail(f"phase 12a: compiler runs {runs1 - runs0} then "
             f"{runs2 - runs1}, memo hits {hits1 - hits0} then "
             f"{hits2 - hits1} (want 1, 0 runs and a hit on the second)")
    mixed_routes = dict(lut_network_mixed.launches_by_route)
    if lut_network_mixed.launches != 2 or mixed_routes["smem"] != 2:
        fail(f"phase 12a: the mixed kernel launched "
             f"{lut_network_mixed.launches} times, routes {mixed_routes}")
    uniform = ops.lut_network(codes, triples, fused=True)
    torch.cuda.synchronize()
    if not torch.equal(uniform, torch.from_numpy(ref["out_uniform"]).to(dev)):
        fail("phase 12a ops.lut_network(fused=True) differs from the "
             "reference's outputs")
    if (lut_network.launches, lut_network.launches_by_route["smem"]) != (
            1, 1):
        fail(f"phase 12a: fused=True without a level launched the uniform "
             f"kernel {lut_network.launches} times, routes "
             f"{lut_network.launches_by_route}")

    # each other legacy function against its wrapper on the same inputs
    idx, tab, bw = (torch.from_numpy(np.asarray(a)).to(dev)
                    if i < 2 else a for i, a in enumerate(triples[0]))
    x, w, mk, b = mm_inputs(torch, dev, 256, 64, 64, "float32",
                            model_a_masks()[1].to(dev))
    q, k, v = flash_inputs(torch, dev, 1, 16, 8, 256, 128, "bfloat16")
    cases = (
        ("lut_lookup", lut_lookup, lambda: ops.lut_lookup(codes, idx, tab,
                                                          bw),
         lambda: lut_lookup(codes, idx, tab, bw)),
        ("masked_matmul", masked_matmul,
         lambda: ops.masked_matmul(x, w, mk, b),
         lambda: masked_matmul(x, w, mk, b)),
        ("flash_attention", flash_attention,
         lambda: ops.flash_attention(q, k, v),
         lambda: flash_attention(q, k, v)))
    for name, wrapper, legacy, direct in cases:
        before = wrapper.launches
        got = legacy()
        launched = wrapper.launches - before
        want_out = direct()
        torch.cuda.synchronize()
        if launched != 1:
            fail(f"phase 12a ops.{name} launched its kernel {launched} "
                 f"times")
        if not torch.equal(got, want_out):
            fail(f"phase 12a ops.{name} differs from its wrapper's output")
    # the fault this slice repairs: a deployment forward with fused=True
    # builds its artifact once
    cfg = fpga4hep.model_a()
    net = LN.init(cfg, torch.Generator().manual_seed(0), device=dev)
    xa = np.random.default_rng(0).standard_normal((256, 16)).astype(
        np.float32)
    LN.forward(net, xa, train=True)
    tables = LN.generate_tables(net)
    want_head = LN.sparse_head_forward(net, tables, xa)
    runs0 = engine.compile_runs()
    builds0 = sum(s["value"] for s in obs.registry().snapshot()[
        "engine_builds_total"]["series"])
    for _ in range(10):
        head = LN.sparse_head_forward(net, tables, xa, fused=True)
        if not torch.equal(head, want_head):
            fail("phase 12a sparse_head_forward(fused=True) differs from "
                 "the per-layer table path")
    builds = sum(s["value"] for s in obs.registry().snapshot()[
        "engine_builds_total"]["series"]) - builds0
    if engine.compile_runs() - runs0 > 1 or builds != 1:
        fail(f"phase 12a: 10 sparse_head_forward(fused=True) calls ran the "
             f"compiler {engine.compile_runs() - runs0} times and built "
             f"{builds} artifacts")
    launches = {name: w.launches for name, w in zip(
        ("lut_mixed_forward", "lut_uniform_forward", "lut_layer_forward",
         "masked_matmul_ffma_forward", "flash_attention_forward"),
        wrappers)}
    log(f"phase 12a legacy API on model A: ops.lut_network(fused=True, "
        f"optimize_level=3) twice bit-exact with the reference, compiler "
        f"runs 1 then 0, memo hits +1 on the second call, mixed kernel "
        f"routes {mixed_routes}; fused=True without a level on the uniform "
        f"kernel; ops.lut_lookup / masked_matmul / flash_attention each one "
        f"launch, equal to their wrappers; 10 sparse_head_forward(fused=True) "
        f"calls: {engine.compile_runs() - runs0} compiler runs, {builds} "
        f"build; launches {launches}")
    engine.cache_clear()
    return {"launches": launches, "mixed_routes": mixed_routes}


def mnist_phase(torch, dev, sms) -> dict:
    """Phase 12b: Table 7.1's widest MLP trained, verified and served at
    full width; the per-layer kernel and the masked matmul timed at its
    shapes."""
    import numpy as np

    from repro_torch import engine, serve
    from repro_torch.configs import mnist
    from repro_torch.core import logicnet as LN
    from repro_torch.core.quantize import codes as quant_codes
    from repro_torch.core.train import train_logicnet
    from repro_torch.kernels import lut_lookup as L
    from repro_torch.kernels.lut_network import (lut_network,
                                                 lut_network_mixed)
    from repro_torch.kernels.masked_matmul import (masked_matmul,
                                                   masked_matmul_plain,
                                                   masked_matmul_route)
    from repro_torch.launch.train_mnist_logicnet import mnist_data

    cfg = mnist.mlp(*MNIST_MLP)
    xt, yt, xv, yv = mnist_data()
    wrappers = (masked_matmul, L.lut_lookup, lut_network, lut_network_mixed)
    for w in wrappers:
        reset_counts(w)
    # the weights are drawn on the host before the clock starts (10.4 M
    # normals and 6 144 masks: a few hundred ms that are not a step's)
    net0 = LN.init(cfg, torch.Generator().manual_seed(0), mask_seed=0,
                   device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_logicnet(cfg, xt, yt, xv, yv, steps=MNIST_STEPS,
                         lr=MNIST_LR, seed=0, device=dev, net=net0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    mm_launches = masked_matmul.launches
    mm_routes = dict(masked_matmul.launches_by_route)
    losses = np.asarray(res.losses)
    if (not np.isfinite(losses).all() or res.accuracy < MNIST_MIN_ACCURACY
            or mm_routes["ffma"] != mm_launches
            or mm_launches < 5 * MNIST_STEPS):
        fail(f"phase 12b training: accuracy {res.accuracy}, finite losses "
             f"{np.isfinite(losses).all()}, masked_matmul {mm_launches} "
             f"launches by route {mm_routes}")
    log(f"phase 12b MNIST mlp{MNIST_MLP} ({cfg.in_features} -> "
        f"{' -> '.join(map(str, cfg.hidden))} sparse at fan-in "
        f"{cfg.fan_in}, {cfg.bw}-bit, dense -> {cfg.n_classes}; "
        f"{cfg.total_luts()} LUTs): {MNIST_STEPS} steps at batch 256 in "
        f"{train_s:.2f} s ({train_s / MNIST_STEPS * 1e3:.3f} ms a step on "
        f"the host clock, the data upload and the held-out accuracy pass "
        f"included), "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, held-out accuracy "
        f"{res.accuracy:.4f}; masked_matmul {mm_launches} launches by route "
        f"{mm_routes}")
    net_m = res.model

    t0 = time.perf_counter()
    tables = LN.generate_tables(net_m)
    gen_s = time.perf_counter() - t0
    f_codes, t_codes = LN.verify_tables(net_m, tables, xv[:200])
    torch.cuda.synchronize()
    if not torch.equal(f_codes, t_codes):
        fail(f"phase 12b verify_tables: "
             f"{int((f_codes != t_codes).sum())} codes differ")
    log(f"phase 12b tables: {len(tables)} layers x {tables[0].table.shape} "
        f"generated on the card in {gen_s:.2f} s; verify_tables on 200 "
        f"held-out rows EXACT")

    runs0 = engine.compile_runs()
    net = engine.compile_network(tables, block_b=16, device=dev)
    plain_net = engine.compile_network(tables, use_pallas=False,
                                       block_b=16, device=dev)
    cost = net.plan.variant.cost
    if (net.layout != "per_layer" or cost.reason != "slab_exceeds_smem_budget"
            or engine.compile_runs() != runs0):
        fail(f"phase 12b: the engine chose {net.layout} for "
             f"{cost.reason!r}, not per_layer for slab_exceeds_smem_budget")
    for w in wrappers:
        reset_counts(w)
    rep = serve.run_closed_loop(net, n_clients=4, n_per_client=4,
                                rows_min=1, rows_max=8, bw=2, seed=0)
    st = rep.stats
    layer_launches = L.lut_lookup.launches
    layer_routes = dict(L.lut_lookup.launches_by_route)
    if (not layer_launches or st["retraces_after_warmup"]
            or st["compiler_runs_after_warmup"]
            or lut_network.launches or lut_network_mixed.launches):
        fail(f"phase 12b serving: per-layer launches {layer_launches}, "
             f"stats {st}")
    # served rows equal net(codes) (run_closed_loop checks that); net(codes)
    # equals the plain chain of the same artifact's tables
    for r in serve.make_requests(net.n_in, 16, rows_min=1, rows_max=8, bw=2,
                                 seed=0):
        c = torch.from_numpy(r).to(dev)
        if not torch.equal(net(c), plain_net(c)):
            fail("phase 12b: a served request differs from the plain "
                 "version of the same artifact")
    legs = " ".join(f"{leg}={rep.breakdown[leg]['mean_ms']:.3f}"
                    for leg in ("queue_wait", "assembly", "device"))
    log(f"phase 12b serving per_layer (the engine's choice: "
        f"{cost.slab_bytes} B of uniform slabs against a "
        f"{cost.vmem_budget_bytes} B budget): {rep.n_requests} requests "
        f"({rep.rows} rows) bit-exact with the plain version, "
        f"p50={rep.p50_ms:.3f} ms p99={rep.p99_ms:.3f} ms, "
        f"{rep.rows_per_sec:.0f} rows/s, mean legs ms: {legs}; lut_lookup "
        f"launches {layer_launches} by route {layer_routes}, "
        f"retraces={st['retraces_after_warmup']} "
        f"compiler_runs={st['compiler_runs_after_warmup']}")

    # the per-layer forward device-paced at three batches, on the routes
    # the rule picks and on the other route of every layer
    x_all = np.concatenate([xt, xv])
    codes_all = quant_codes(cfg.layer_cfgs()[0].in_quant, torch.from_numpy(
        x_all[:max(MNIST_TIME_BATCHES)]).to(dev)).to(torch.int32)
    shapes = [(i.shape[0], i.shape[1], t.shape[1]) for i, t, _ in net.layers]

    def chain(route_of):
        def call(c):
            for idx, tab, bw in net.layers:
                out = torch.empty((c.shape[0], idx.shape[0]),
                                  dtype=torch.int32, device=dev)
                geom = L.lut_layer_route(c.shape[0], c.shape[1],
                                         idx.shape[0], idx.shape[1],
                                         tab.shape[1], sms,
                                         route=route_of(c, idx, tab))
                L._launch_layer(c, idx, tab, bw, out, geom)
                c = out
            return c
        return call

    def rule_route(c, idx, tab):
        return L.lut_layer_route(c.shape[0], c.shape[1], idx.shape[0],
                                 idx.shape[1], tab.shape[1], sms).route

    def other_route(c, idx, tab):
        return "smem" if rule_route(c, idx, tab) == "direct" else "direct"

    layer_rec = {"model": f"mnist mlp{MNIST_MLP}", "layers": len(shapes),
                 "shapes": shapes, "launches": layer_launches,
                 "launches_by_route": layer_routes,
                 "serving": {"p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
                             "rows_per_sec": rep.rows_per_sec}}
    for b in MNIST_TIME_BATCHES:
        c = codes_all[:b].contiguous()
        want = plain_net(c)
        fns = {"rule": chain(rule_route), "other": chain(other_route)}
        for what, fn in fns.items():
            out = fn(c)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                fail(f"phase 12b per-layer forward batch {b} ({what} "
                     f"routes) differs from the plain version")
        routes, other, n_in = [], [], c.shape[1]
        for n_out, fan_in, n_e in shapes:
            g = L.lut_layer_route(b, n_in, n_out, fan_in, n_e, sms)
            routes.append(g.route)
            other.append("smem" if g.route == "direct" else "direct")
            n_in = n_out
        turns = {w: [] for w in fns}
        for w in ("rule", "other", "other", "rule"):
            turns[w].append(paced_ms(lambda: fns[w](c)))
        paced = {w: (None if None in v else statistics.mean(v))
                 for w, v in turns.items()}
        ms = cuda_ms(lambda: net(c), 50)
        plain_ms = cuda_ms(lambda: plain_net(c), 10)
        whole = per_layer_bytes(b, c.shape[1], shapes)
        entries = addressed_entries(net.layers, c)
        moved = per_layer_bytes(b, c.shape[1], shapes, entries)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = b * sum(o * (2 * f + 2) for o, f, _ in shapes) \
            / INT32_OPS_PER_S * 1e3
        whole_ms = max(whole / HBM_BYTES_PER_S * 1e3, ops_ms)
        layer_rec[f"b{b}"] = {
            "paced_ms": paced["rule"], "routes": routes,
            "paced_ms_other_route": paced["other"], "other_routes": other,
            "turns_paced_ms": turns, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": moved, "entries_addressed": entries,
            "bound_ms_whole_tables": whole_ms,
            "bound_bytes_whole_tables": whole}
        log(f"phase 12b per-layer forward batch {b}: device-paced "
            f"{paced['rule']} ms on the rule's routes {routes}, "
            f"{paced['other']} ms on the other routes {other} (turns "
            f"{turns}); engine call {ms:.5f} ms event, plain "
            f"{plain_ms:.5f} ms, bound {max(bytes_ms, ops_ms):.6f} ms "
            f"({moved} B: the {sum(entries)} table entries this batch "
            f"addresses), {whole_ms:.6f} ms with whole tables ({whole} B)")

    # the masked matmul at the training step's two shapes, float32
    mm_rec = {}
    for mask in (net_m.layers[0].mask, net_m.layers[1].mask):
        m, (k, n) = 256, mask.shape
        x, w, mk, bias = mm_inputs(torch, dev, m, k, n, "float32",
                                   mask.detach())
        route = masked_matmul_route(x.dtype, k, n)
        want = masked_matmul_plain(x, w, mk, bias)
        got = masked_matmul(x, w, mk, bias)
        torch.cuda.synchronize()
        atol, rtol, _ = MM_TOL["float32"]
        err = float((got - want).abs().max())
        if route != "ffma" or not bool(
                ((got - want).abs() <= atol + rtol * want.abs()).all()):
            fail(f"phase 12b masked_matmul {m}x{k}x{n} ({route}): max "
                 f"|kernel - plain| {err}")
        ms = cuda_ms(lambda: masked_matmul(x, w, mk, bias), 200)
        plain_ms = cuda_ms(lambda: masked_matmul_plain(x, w, mk, bias), 200)
        library_ms = cuda_ms(lambda: torch.addmm(bias, x, w * mk), 200)
        dev_ms = device_ms(lambda: masked_matmul(x, w, mk, bias), 200,
                           device_bound=True)
        moved = nbytes(x, w, mk, bias) + m * n * 4
        ops = 2 * m * int(mk.count_nonzero())
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FLOPS_PER_S["float32"] * 1e3
        mm_rec[f"{m}x{k}x{n}"] = {
            "route": route, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        log(f"phase 12b masked_matmul {m}x{k}x{n} float32 ({route}, the "
            f"MNIST mask, nnz {int(mk.count_nonzero())}): {ms:.5f} ms/call, "
            f"device {dev_ms} ms, plain {plain_ms:.5f} ms, addmm "
            f"{library_ms:.5f} ms ({ms / library_ms:.2f}x), bound "
            f"{max(bytes_ms, ops_ms):.6f} ms ({moved} B)")

    # where a training step's time goes: 50 steps a call of an already
    # made network (the profiler's first call is its warm-up); the call's
    # one upload of the 12.5 MB of training data is split out
    steps = 50
    net1 = LN.init(cfg, torch.Generator().manual_seed(1), mask_seed=0,
                   device=dev)
    wall, total, by_name, counts = profile_split(
        torch, lambda: train_logicnet(cfg, xt, yt, xv, yv, steps=steps,
                                      lr=MNIST_LR, seed=0, device=dev,
                                      net=net1), 1)
    mm_dev = sum(t for n, t in by_name.items() if "masked_matmul" in n)
    h2d = sum(t for n, t in by_name.items() if "Memcpy HtoD" in n)
    train = {"steps": MNIST_STEPS, "train_s": train_s,
             "ms_per_step": train_s / MNIST_STEPS * 1e3,
             "accuracy": res.accuracy, "loss_first": float(losses[0]),
             "loss_last": float(losses[-1]),
             "masked_matmul_launches": mm_launches,
             "masked_matmul_routes": mm_routes,
             "profiled_steps": steps,
             "profiled_wall_ms": wall / steps,
             "profiled_device_ms": total / steps,
             "profiled_device_ms_without_uploads": (total - h2d) / steps,
             "profiled_mm_device_ms": mm_dev / steps,
             "kernels_per_step": sum(counts.values()) / steps,
             "idle_share": 1 - total / wall, "tables_s": gen_s}
    log(f"phase 12b training step ({steps} steps a call, profiled): "
        f"{train['profiled_wall_ms']:.3f} ms host clock, "
        f"{train['profiled_device_ms']:.4f} ms device "
        f"({train['profiled_device_ms_without_uploads']:.4f} without the "
        f"host-to-device copies; masked matmul "
        f"{train['profiled_mm_device_ms']:.4f} ms), device idle "
        f"{train['idle_share'] * 100:.1f} %, {train['kernels_per_step']:.2f} "
        f"kernels a step; top: {top_kernels(by_name)}")
    return {"per_layer": layer_rec, "masked_matmul": mm_rec,
            "training": train}


def sparse_conv_phase(torch, dev) -> dict:
    """Phase 12c: Table 7.4's first SparseConv layer, one train-mode
    forward and backward on the card against the same weights on the
    CPU, with cuDNN's TF32 default (allow_tf32 True) left on around it.
    A control repeats the step with the depthwise conv's backward left to
    that default (the layer's float32 block lifted for the backward only):
    where its gradients differ from the sound run's, the gate must refuse
    them."""
    import contextlib
    import copy
    from unittest import mock

    from repro_torch.core import SparseConv, SparseConvCfg
    from repro_torch.core import layers as LY

    cfg = SparseConvCfg(1, 16, 3, first_layer=True)
    cpu = SparseConv(cfg, torch.Generator().manual_seed(0)).train()
    card, control = copy.deepcopy(cpu).to(dev), copy.deepcopy(cpu).to(dev)
    x, r = conv_inputs(torch)
    env = conv_grad_envelope(cpu, x, r)
    xd, rd = x.to(dev), r.to(dev)

    def step(mod, xx, rr, tf32_backward=False):
        mod.zero_grad(set_to_none=True)
        y = mod(xx)
        with (mock.patch.object(LY, "_float32_convs", contextlib.nullcontext)
              if tf32_backward else contextlib.nullcontext()):
            (y * rr).sum().backward()
        return y

    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y_card = step(card, xd, rd)
        step(control, xd, rd, tf32_backward=True)
        y_cpu = step(cpu, x, r)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: step(card, xd, rd), 20)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    atol, rtol = CONV_TOL
    y_err = float((y_card.detach().cpu() - y_cpu.detach()).abs().max())
    if not bool(((y_card.detach().cpu() - y_cpu.detach()).abs()
                 <= atol + rtol * y_cpu.detach().abs()).all()):
        fail(f"phase 12c SparseConv output: max |card - cpu| {y_err}")
    want = {n: p.grad for n, p in cpu.named_parameters()}
    got = {n: p.grad.cpu() for n, p in card.named_parameters()}
    ctl = {n: p.grad.cpu() for n, p in control.named_parameters()}
    g_err = {n: float((got[n] - want[n]).abs().max()) for n in want}
    units = {n: conv_grad_reading(got[n], want[n], env[n]) for n in want}
    ctl_units = {n: conv_grad_reading(ctl[n], want[n], env[n])
                 for n in want}
    ctl_err = {n: float((ctl[n] - want[n]).abs().max()) for n in want}
    changed = [n for n in want if not torch.equal(ctl[n], got[n])]
    log(f"phase 12c SparseConv {cfg} on 256 mnist_like images: outputs "
        f"within {atol} + {rtol} |y| of the CPU's (max |diff| {y_err}); "
        f"gradients: max |card - cpu| {g_err}, excess over the tolerance "
        f"in float32 units of each envelope {units} (gate "
        f"{CONV_GRAD_ULPS}); control with a TF32 backward: max |diff| "
        f"{ctl_err}, units {ctl_units}, gradients that changed {changed}; "
        f"{ms:.4f} ms a step (event), cuDNN TF32 left on outside the "
        f"layer's own float32 block")
    for n, u in units.items():
        if u > CONV_GRAD_ULPS:
            fail(f"phase 12c SparseConv gradient {n}: {u} float32 units of "
                 f"its envelope over the tolerance (gate {CONV_GRAD_ULPS})")
    if changed and max(ctl_units[n] for n in changed) <= CONV_GRAD_ULPS:
        fail(f"phase 12c: a TF32 backward changed {changed} and the "
             f"gradient gate passed it ({ctl_units})")
    return {"y_max_abs_err": y_err, "grad_max_abs_err": g_err,
            "grad_envelope_units": units, "grad_gate_units": CONV_GRAD_ULPS,
            "control_tf32_backward": {"grad_max_abs_err": ctl_err,
                                      "grad_envelope_units": ctl_units,
                                      "changed": changed},
            "ms_per_step": ms}


def conv_inputs(torch):
    """Phase 12c's 256 images and the upstream gradient (CPU, seeded)."""
    from repro_torch.data import mnist_like_data
    x, _ = mnist_like_data(256, 1)
    r = torch.randn((256, 26, 26, 16),
                    generator=torch.Generator().manual_seed(1))
    return torch.from_numpy(x), r


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
    from repro_torch.kernels import lut_lookup as lut_lookup_mod
    from repro_torch.kernels.lut_lookup import lut_lookup, lut_lookup_plain
    from repro_torch.kernels import lut_network as lut_network_mod
    from repro_torch.kernels.lut_network import (lut_network,
                                                 lut_network_mixed,
                                                 lut_network_mixed_plain,
                                                 lut_network_plain)

    dev = torch.device("cuda")
    # float32 products stay float32 everywhere (library yardstick included),
    # and bfloat16 products sum in float32 to the end, as the reference's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    ref_d = np.load(FIXTURE / "model_d_ref.npz")
    if not np.array_equal(ref_d["out_uniform"], ref_d["out_per_layer"]):
        fail("model_d_ref.npz: the reference's two layouts disagree")
    codes_all = torch.from_numpy(ref["codes"]).to(dev)

    def triples_of(r):
        return [(r[f"idx_{i}"], r[f"table_{i}"], int(r["bws"][i]))
                for i in range(len(r["bws"]))]

    triples, triples_d = triples_of(ref), triples_of(ref_d)
    host_s = compile_host_times({"A": triples, "D": triples_d})
    log(f"compile host time (optimize wall s on the host CPU of the card's "
        f"machine, not card time; {smi}): "
        + " ".join(f"{m}@L{lv} {t:.4f}" for (m, lv), t in host_s.items()))

    # the port's own compiler: model A and model D at level 3, before
    # anything is served, each one compiler run
    runs0 = engine.compile_runs()
    nets = {
        "mixed": engine.compile_network(triples, optimize_level=3,
                                        in_features=16, block_b=16),
        # the reference's artifact: phase 1 holds the load path
        "mixed_loaded": engine.load(str(FIXTURE / "model_a_l3.npz")),
        # model D's level-3 slabs fit the fused budget: mixed by itself
        "mixed_d": engine.compile_network(triples_d, optimize_level=3,
                                          block_b=16),
        "uniform": engine.compile_network(triples, block_b=16),
        # model A's raw tables fit the uniform layout: the per-layer kernel
        # serves them only by force
        "per_layer": engine.compile_network(triples, fused=False,
                                            block_b=16),
        # model D's raw tables do not: the engine sends them to it by itself
        "per_layer_d": engine.compile_network(triples_d, block_b=16),
    }
    compiled = 2
    if engine.compile_runs() != runs0 + compiled:
        fail(f"compile_runs() rose by {engine.compile_runs() - runs0} for "
             f"{compiled} optimize_level builds")
    for key, net in nets.items():
        want = "per_layer" if key.startswith("per_layer") else (
            key.split("_")[0])
        if net.layout != want or net.device.type != "cuda":
            fail(f"{key}: engine chose {net.layout} on {net.device}")
    check_port_compiled(torch, nets["mixed"], nets["mixed_loaded"])
    cost_md = nets["mixed_d"].plan.variant.cost
    route_md = lut_network_mod.lut_fused_route(
        lut_network_mod._smem_state(nets["mixed_d"].slabs, 16).layout)
    if cost_md.reason != "fused" or route_md != "smem":
        fail(f"model D at level 3: {cost_md.reason!r} on route {route_md}, "
             f"not fused on smem")
    log(f"model D at level 3: the engine chose mixed by itself "
        f"({cost_md.slab_bytes} B of mixed slabs against a "
        f"{cost_md.vmem_budget_bytes} B budget; "
        f"{nets['mixed_d'].stats.neurons_after} neurons, "
        f"{nets['mixed_d'].stats.table_bytes_after} B of tables), route "
        f"{route_md}; compile_runs() rose by {compiled} for the 2 "
        f"optimize_level builds")
    cost_d = nets["per_layer_d"].plan.variant.cost
    if cost_d.reason != "slab_exceeds_smem_budget":
        fail(f"model D: the engine chose per_layer for {cost_d.reason!r}, "
             f"not slab_exceeds_smem_budget")
    log(f"model D (fpga4hep Table 6.1: 16 -> 64 -> 32 -> 32 -> 5, fan-in 5 "
        f"and 6, 2-bit codes, full widths): the engine chose per_layer by "
        f"itself ({cost_d.reason}: {cost_d.slab_bytes} B of uniform slabs "
        f"against a {cost_d.vmem_budget_bytes} B budget)")
    sms = lut_lookup_mod._sm_count(dev.index or 0)

    def layer_chain(net, route=None, layers=None, pdl=1):
        """A per-layer forward: through the wrapper (counted) when
        ``route`` is None; else every launch called directly, uncounted, on
        ``route``: "smem" or "direct" forced, "rule" as the wrapper routes
        it, or "first" (the first design)."""
        layers = layers or net.layers

        def call(c):
            for idx, tab, bw in layers:
                if route is None:
                    c = lut_lookup(c, idx, tab, bw)
                    continue
                out = torch.empty((c.shape[0], idx.shape[0]),
                                  dtype=torch.int32, device=dev)
                if c.shape[0] and route == "first":
                    lut_lookup_mod._launch_first(c, idx, tab, bw, out)
                elif c.shape[0]:
                    geom = lut_lookup_mod.lut_layer_route(
                        c.shape[0], c.shape[1], idx.shape[0], idx.shape[1],
                        tab.shape[1], sms, tab.element_size(),
                        route=None if route == "rule" else route)
                    lut_lookup_mod._launch_layer(c, idx, tab, bw, out, geom,
                                                 pdl=pdl)
                c = out
            return c
        return call

    def layer_plain(net):
        def call(c):
            for idx, tab, bw in net.layers:
                c = lut_lookup_plain(c, idx, tab, bw)
            return c
        return call

    s_uniform = nets["uniform"].slabs

    def direct(slabs):
        """Each route of a fused kernel called directly (uncounted)."""
        def call(route, c):
            out = torch.empty((c.shape[0], slabs.n_out), dtype=torch.int32,
                              device=dev)
            if c.shape[0] == 0:
                return out
            if route == "global":
                lut_network_mod._launch_global(c, slabs, out)
            else:
                lut_network_mod._launch_smem(
                    c, out, lut_network_mod._smem_state(slabs, c.shape[1]))
            return out
        return call

    fused_routes = {"smem": LUT_SMEM_SOURCE, "global": LUT_SOURCE}

    def per_layer(key, model, r):
        net = nets[key]
        return dict(
            name="lut_layer_forward", model=model, wrapper=lut_lookup,
            net=net, codes=torch.from_numpy(r["codes"]).to(dev),
            want=r["out_uniform" if model == "D" else "out_per_layer"],
            bw=int(r["bws"][0]), kernel=layer_chain(net),
            plain=layer_plain(net),
            layer_routes={"smem": LUT_LAYER_SOURCE,
                          "direct": LUT_LAYER_SOURCE},
            source=LUT_LAYER_SOURCE,
            replaces="src/repro/kernels/lut_lookup.py:86",
            shapes=[(i.shape[0], i.shape[1], t.shape[1])
                    for i, t, _ in net.layers],
            ops_per_row=sum(i.shape[0] * (2 * i.shape[1] + 2)
                            for i, _, _ in net.layers),
            per_call=len(net.layers))

    def mixed(key, model, r, want, served=True):
        net = nets[key]
        sl = net.slabs
        return dict(
            name="lut_mixed_forward", wrapper=lut_network_mixed, net=net,
            model=model, served=served,
            codes=torch.from_numpy(r["codes"]).to(dev), want=r[want],
            bw=int(r["bws"][0]),
            kernel=lambda c: lut_network_mixed(c, sl),
            plain=lambda c: lut_network_mixed_plain(c, sl),
            slabs=sl, direct=direct(sl), routes=fused_routes,
            source=LUT_SMEM_SOURCE,
            replaces="src/repro/kernels/lut_network.py:541",
            slab_bytes=nbytes(sl.idx_slab, sl.shift_slab, sl.width_slab,
                              sl.table_slab, sl.row_meta, sl.layer_meta,
                              sl.perm),
            # per neuron element: mask, shift, add; per code: bound, address
            ops_per_row=sum(m.n_out * (3 * m.fan_in + 2)
                            for m in sl.meta), per_call=1)

    kernels = {
        # the main path's mixed layout: model A compiled by the port
        "mixed": mixed("mixed", "A", ref, "out_mixed"),
        # the reference's artifact of the same slabs: phase 1 only
        "mixed_loaded": mixed("mixed_loaded", "A", ref, "out_mixed",
                              served=False),
        # model D at level 3: the compiler keeps the raw tables' function
        # on every code the 2-bit input bus carries
        "mixed_d": mixed("mixed_d", "D", ref_d, "out_uniform"),
        "uniform": dict(
            name="lut_uniform_forward", wrapper=lut_network,
            net=nets["uniform"], codes=codes_all, want=ref["out_uniform"],
            bw=3, kernel=lambda c: lut_network(c, s_uniform),
            plain=lambda c: lut_network_plain(c, s_uniform),
            slabs=s_uniform, direct=direct(s_uniform), routes=fused_routes,
            source=LUT_SMEM_SOURCE,
            replaces="src/repro/kernels/lut_network.py:270",
            slab_bytes=nbytes(s_uniform.idx_slab, s_uniform.table_slab,
                              s_uniform.layer_meta, s_uniform.perm),
            ops_per_row=sum(m.n_out * (2 * m.fan_in + 2)
                            for m in s_uniform.meta), per_call=1),
        "per_layer": per_layer("per_layer", "A", ref),
        "per_layer_d": per_layer("per_layer_d", "D", ref_d),
    }

    # -- phase 1: every kernel against its plain version and the reference
    for key, k in kernels.items():
        n_out = k["net"].n_out
        k["max_abs_err"] = 0
        calls = {"kernel": k["kernel"], "engine": k["net"]}
        if "direct" in k:
            odd = table_at_odd_offset(torch, k["slabs"])
            if odd.table_slab.data_ptr() % 2 != 1 and odd.packed:
                fail(f"{k['name']}: the odd-offset table slab is at "
                     f"{odd.table_slab.data_ptr()}")
            odd_direct = direct(odd)
            for route in k["routes"]:
                calls[f"{route} route"] = (
                    lambda c, r=route: k["direct"](r, c))
                calls[f"{route} route, table at an odd offset"] = (
                    lambda c, r=route: odd_direct(r, c))
        if "layer_routes" in k:
            # every table 4 bytes past a 16-byte boundary: the staged
            # copy's head and tail go by threads
            shifted = [(i, view_at_offset(torch, t), bw)
                       for i, t, bw in k["net"].layers]
            torch.cuda.synchronize()
            if any(t.data_ptr() % 16 != 4 for _, t, _ in shifted):
                fail("the shifted per-layer tables are not 4 bytes past a "
                     "16-byte boundary")
            for route in k["layer_routes"]:
                calls[f"{route} route"] = layer_chain(k["net"], route)
                calls[f"{route} route, tables at 4 mod 16 bytes"] = (
                    layer_chain(k["net"], route, shifted))
            calls["first design"] = layer_chain(k["net"], "first")
        for b in BATCHES:
            codes = k["codes"][:b].contiguous()
            before = k["wrapper"].launches
            got = {"kernel": k["kernel"](codes)}
            launched = k["wrapper"].launches - before
            got.update({what: fn(codes) for what, fn in calls.items()
                        if what != "kernel"})
            got["plain"] = k["plain"](codes)
            torch.cuda.synchronize()
            if b and launched != k["per_call"]:
                fail(f"{k['name']} ({key}) batch {b}: the wrapper counted "
                     f"{launched} launches for one call")
            if b == 0 and launched:
                fail(f"{k['name']} ({key}) batch 0 launched a kernel")
            want = torch.from_numpy(k["want"][:b]).to(dev)
            for what, out in got.items():
                if out.shape != (b, n_out) or out.dtype != torch.int32:
                    fail(f"{k['name']} ({key}) batch {b}: {what} gave "
                         f"{out.dtype} {tuple(out.shape)}")
                if b and what != "plain":
                    err = int((out.long() - got["plain"].long()).abs().max())
                    k["max_abs_err"] = max(k["max_abs_err"], err)
                if not torch.equal(out, want):
                    fail(f"{k['name']} ({key}) batch {b}: {what} output "
                         f"differs from the reference's")
        log(f"phase 1 {k['name']} ({key}): bit-exact vs plain and reference "
            f"at batches {BATCHES} ({', '.join(calls)})")

    # -- phase 2: the main path, serving each layout through the tier
    wrappers = {id(k["wrapper"]): k["wrapper"] for k in kernels.values()}
    for key, k in kernels.items():
        if not k.get("served", True):
            continue
        for w in wrappers.values():
            reset_counts(w)
        rep = serve.run_closed_loop(k["net"], n_clients=4, n_per_client=4,
                                    rows_min=1, rows_max=8, bw=k["bw"],
                                    seed=0)
        k["launches"] = k["wrapper"].launches
        by_route = dict(k["wrapper"].launches_by_route)
        k["launches_by_route"] = by_route
        st = rep.stats
        if not k["launches"]:
            fail(f"serving {key}: {k['name']} was never launched")
        if "routes" in k and (by_route["global"]
                              or by_route["smem"] != k["launches"]):
            fail(f"serving {key}: {k['name']} left the smem route: "
                 f"{by_route}")
        if "layer_routes" in k and sum(by_route.values()) != k["launches"]:
            fail(f"serving {key}: {k['name']} launched {k['launches']} "
                 f"times, {by_route} on its routes")
        if st["retraces_after_warmup"] or st["compiler_runs_after_warmup"]:
            fail(f"serving {key}: compile-once contract broken: {st}")
        k["phase2"] = {"p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
                       "rows_per_sec": rep.rows_per_sec}
        legs = " ".join(f"{leg}={rep.breakdown[leg]['mean_ms']:.3f}"
                        for leg in ("queue_wait", "assembly", "device"))
        log(f"phase 2 serving {key}: {rep.n_requests} requests "
            f"({rep.rows} rows) bit-exact, p50={rep.p50_ms:.3f} ms "
            f"p99={rep.p99_ms:.3f} ms, {rep.rows_per_sec:.0f} rows/s, "
            f"{st['batches']} batches (flushes {st['flush_causes']}), "
            f"mean legs ms: {legs}; {k['name']} launches={k['launches']} "
            f"by route {by_route}, "
            f"retraces={st['retraces_after_warmup']} "
            f"compiler_runs={st['compiler_runs_after_warmup']}")

    # -- phase 3: times beside the bound
    def layer_times(k) -> dict:
        """A per-layer forward's times at TIME_BATCHES: event ms (routed
        and the first design), device-paced ms in turns (the first design,
        the routed launches, the routed launches without programmatic
        dependent launch), profiler device ms, the plain version and the
        bound."""
        net, n_call = k["net"], k["per_call"]
        rec = {"layers": n_call}
        for b in TIME_BATCHES:
            codes = k["codes"][:b].contiguous()
            iters = 200 if b <= 16 else 50
            sfx = "" if b == TIME_BATCHES[0] else f"_b{b}"
            fns = {"first": layer_chain(net, "first"),
                   "routed": k["kernel"],
                   "no_pdl": layer_chain(net, "rule", pdl=0)}
            turns = {w: [] for w in fns}
            for w in ("first", "routed", "no_pdl", "no_pdl", "routed",
                      "first"):
                turns[w].append(paced_ms(lambda: fns[w](codes)))
            paced = {w: (None if None in v else statistics.mean(v))
                     for w, v in turns.items()}
            ms = cuda_ms(lambda: k["kernel"](codes), iters)
            earlier_ms = cuda_ms(lambda: fns["first"](codes), iters)
            plain_ms = cuda_ms(lambda: k["plain"](codes), iters)
            dev_ms = device_ms(lambda: k["kernel"](codes), iters, n_call)
            earlier_dev = device_ms(lambda: fns["first"](codes), iters,
                                    n_call)
            whole = per_layer_bytes(b, codes.shape[1], k["shapes"])
            moved = per_layer_bytes(b, codes.shape[1], k["shapes"],
                                    addressed_entries(net.layers, codes))
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = b * k["ops_per_row"] / INT32_OPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            used, c_in = [], codes.shape[1]
            for n_out, fan_in, n_e in k["shapes"]:
                used.append(lut_lookup_mod.lut_layer_route(
                    b, c_in, n_out, fan_in, n_e, sms).route)
                c_in = n_out
            rec.update({
                f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                f"device_ms{sfx}": dev_ms,
                f"device_ms_per_launch{sfx}": (
                    None if dev_ms is None else dev_ms / n_call),
                f"paced_ms{sfx}": paced["routed"],
                f"paced_ms_no_pdl{sfx}": paced["no_pdl"],
                f"earlier_ms{sfx}": earlier_ms,
                f"earlier_device_ms{sfx}": earlier_dev,
                f"earlier_paced_ms{sfx}": paced["first"],
                f"turns_paced_ms{sfx}": turns,
                f"bound_ms{sfx}": bound,
                f"bound_ms_per_launch{sfx}": bound / n_call,
                f"bound_by{sfx}": ("bytes" if bytes_ms >= ops_ms
                                   else "operations"),
                f"bound_bytes{sfx}": moved,
                f"bound_ms_whole_tables{sfx}": max(
                    whole / HBM_BYTES_PER_S * 1e3, ops_ms),
                f"bound_bytes_whole_tables{sfx}": whole,
                f"routes_used{sfx}": used})
            log(f"phase 3 {k['name']} model {k['model']} batch {b} "
                f"({n_call} launches a forward, routes {used}): "
                f"device-paced {paced['routed']} ms a forward (without "
                f"PDL {paced['no_pdl']}, first design {paced['first']}; "
                f"turns {turns}), event {ms:.5f} ms (first design "
                f"{earlier_ms:.5f}), device {dev_ms} ms (first design "
                f"{earlier_dev}), plain {plain_ms:.5f} ms, bound "
                f"{bound:.6f} ms ({moved} B: the table entries this batch "
                f"addresses; {whole} B with whole tables)")
        return rec

    def fused_times(k) -> dict:
        """A fused kernel's times at TIME_BATCHES: the earlier design
        (route global) and the routed kernel (smem) in turns, event and
        device ms, the plain version and the bound."""
        rec = {}
        for b in TIME_BATCHES:
            codes = k["codes"][:b].contiguous()
            iters = 200 if b <= 16 else 50
            suffix = "" if b == TIME_BATCHES[0] else f"_b{b}"
            # the earlier design and the routed kernel in turns
            turns = {"global": [], "smem": []}
            for route in ("global", "smem", "smem", "global"):
                fn = ((lambda: k["direct"]("global", codes))
                      if route == "global" else
                      (lambda: k["kernel"](codes)))
                turns[route].append(cuda_ms(fn, iters))
            ms = statistics.mean(turns["smem"])
            earlier_dev = device_ms(
                lambda: k["direct"]("global", codes), iters)
            plain_ms = cuda_ms(lambda: k["plain"](codes), iters)
            dev_ms = device_ms(lambda: k["kernel"](codes), iters)
            sl = k["slabs"]
            tab_bytes = nbytes(sl.table_slab)
            whole = (b * (codes.shape[1] + k["net"].n_out) * 4
                     + k["slab_bytes"])
            moved = whole - tab_bytes + (fused_table_reads(sl, codes)
                                         * sl.table_slab.element_size())
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = b * k["ops_per_row"] / INT32_OPS_PER_S * 1e3
            rec.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                        f"device_ms{suffix}": dev_ms,
                        f"earlier_ms{suffix}": statistics.mean(
                            turns["global"]),
                        f"earlier_device_ms{suffix}": earlier_dev,
                        f"turns_ms{suffix}": turns,
                        f"bound_ms{suffix}": max(bytes_ms, ops_ms),
                        f"bound_by{suffix}": ("bytes" if bytes_ms >= ops_ms
                                              else "operations"),
                        f"bound_bytes{suffix}": moved,
                        f"bound_ms_whole_slab{suffix}": max(
                            whole / HBM_BYTES_PER_S * 1e3, ops_ms),
                        f"bound_bytes_whole_slab{suffix}": whole})
            log(f"phase 3 {k['name']} model {k.get('model', 'A')} batch "
                f"{b}: {ms:.5f} ms/forward, "
                f"device {dev_ms} ms, plain {plain_ms:.5f} ms, bound "
                f"{max(bytes_ms, ops_ms):.6f} ms ({moved} B: the table "
                f"entries this batch addresses; {whole} B with the whole "
                f"slab), earlier "
                f"design (global route) "
                f"{rec[f'earlier_ms{suffix}']:.5f} ms, device "
                f"{earlier_dev} ms")
        return rec

    records = []
    layer_rec = None
    mixed_rec = None
    for key, k in kernels.items():
        if "layer_routes" in k:
            times = layer_times(k)
            if layer_rec is None:
                # model A's chain at the top level, as earlier runs
                # recorded it; model D's under "model_d"
                layer_rec = {
                    "name": k["name"], "route": "cuda",
                    "source": k["source"], "replaces": k["replaces"],
                    "launches": 0, "launches_by_route": {},
                    "launches_by_model": {}, "max_abs_err": 0,
                    "routes": k["layer_routes"],
                    "earlier_design": {"source": LUT_SOURCE,
                                       "entry": "lut_layer_forward"},
                    **times, "library_ms": None, "batch": TIME_BATCHES[0]}
                records.append(layer_rec)
            else:
                layer_rec[f"model_{k['model'].lower()}"] = times
            layer_rec["launches"] += k["launches"]
            layer_rec["launches_by_model"][k["model"]] = k["launches"]
            for r, n in k["launches_by_route"].items():
                layer_rec["launches_by_route"][r] = (
                    layer_rec["launches_by_route"].get(r, 0) + n)
            layer_rec["max_abs_err"] = max(layer_rec["max_abs_err"],
                                           k["max_abs_err"])
            continue
        if not k.get("served", True):
            continue
        if key == "mixed_d":
            # model D at level 3 under "model_d"; its launches join the
            # mixed record's
            mixed_rec["model_d"] = fused_times(k)
            mixed_rec["launches"] += k["launches"]
            mixed_rec["launches_by_model"]["D"] = k["launches"]
            for r, n in k["launches_by_route"].items():
                mixed_rec["launches_by_route"][r] += n
            continue
        rec = {"name": k["name"], "route": "cuda", "source": k["source"],
               "replaces": k["replaces"], "launches": k["launches"],
               "max_abs_err": k["max_abs_err"], "routes": k["routes"],
               "launches_by_route": dict(k["launches_by_route"])}
        if key == "mixed":
            mixed_rec = rec
            rec["launches_by_model"] = {"A": k["launches"]}
            rec["max_abs_err"] = max(kernels[m]["max_abs_err"] for m in
                                     ("mixed", "mixed_loaded", "mixed_d"))
            rec["compile_host_s"] = {f"{m}@L{lv}": t
                                     for (m, lv), t in host_s.items()}
        rec.update(fused_times(k))
        rec["library_ms"] = None
        rec["batch"] = TIME_BATCHES[0]
        records.append(rec)

    mm = masked_matmul_phase(torch, dev)
    mm.update(training_phase(torch, dev, kernels))
    # phase 5's own mixed launches (verify_tables and the optimized trained
    # model served), beside phase 2's
    mixed_rec["launches_training_path"] = mm.pop("lut_mixed_launches")
    records.append(masked_matmul_times(torch, dev, mm))
    records[-1].update(training_profile(torch, dev))

    fa = flash_phase(torch, dev)
    fa["lm_smoke_max_abs"] = lm_smoke_phase(torch, dev)
    path = lm_main_path(torch, dev, kernels)
    # flash attention in two records, each with its own routes' launches on
    # the main path (the wrapper's total is launches_all_routes): the
    # float32 tensor-core kernel (phase 9b's float32 prefill; its phase-7
    # error, its phase-10 times), and the bfloat16 and SIMT kernels
    by_route = path["launches_by_route"]
    tf_rec = {"name": "flash_attention_tf32_forward", "route": "cuda",
              "source": FA_TF32_SOURCE, "replaces": FA_REPLACES,
              "launches": by_route["tf32x3"],
              "max_abs_err": fa["max_abs_err_by_route"]["tf32x3"],
              "routes": {"tf32x3": FA_TF32_SOURCE}}
    fa_rec = {"name": "flash_attention_forward", "route": "cuda",
              "source": FA_WGMMA_SOURCE, "replaces": FA_REPLACES,
              "launches": by_route["wgmma"] + by_route["simt"],
              "launches_all_routes": path["launches"],
              "launches_by_route": by_route,
              "routes": {"simt": FA_SOURCE, "wgmma": FA_WGMMA_SOURCE}, **fa}
    # the kernels' traces before the prefill's: the profiler loses most
    # records of short traces taken after a large one
    fa_rec.update(flash_times(torch, dev))
    tf_rec.update(flash_f32_times(torch, dev))
    fa_rec.update(path_times(torch, dev, path))
    fa_rec.update({k: path[k] for k in ("prefill_first_ms",
                                        "decode_vs_prefill_max_abs",
                                        "decode_vs_prefill_max_abs_f32")})
    del path
    torch.cuda.empty_cache()
    records.append(fa_rec)
    records.append(tf_rec)

    front = serving_front_phase(torch, dev, kernels, ref, ref_d,
                                {"A": triples, "D": triples_d})
    for rec, key, model in ((mixed_rec, "mixed", "A"),
                            (layer_rec, "per_layer_d", "D")):
        rec[f"launches_http_{model.lower()}"] = front["http"][key][
            "launches"]
        rec[f"launches_http_{model.lower()}_by_route"] = front["http"][key][
            "launches_by_route"]
        rec[f"http_{model.lower()}"] = {
            m: front["http"][key][m] for m in ("p50_ms", "p99_ms",
                                               "rows_per_sec")}
    for rec in records:
        if rec["name"] in front["autotune_launches"]:
            rec["launches_autotune"] = front["autotune_launches"][
                rec["name"]]

    # -- phase 12: the legacy flag API, the MNIST path, SparseConv
    legacy = legacy_api_phase(torch, dev, ref, triples)
    mnist_out = mnist_phase(torch, dev, sms)
    conv = sparse_conv_phase(torch, dev)
    for rec in records:
        if rec["name"] in legacy["launches"]:
            rec["launches_legacy_api"] = legacy["launches"][rec["name"]]
    layer_rec["mnist"] = mnist_out["per_layer"]
    mm_rec = next(r for r in records
                  if r["name"] == "masked_matmul_ffma_forward")
    mm_rec["mnist"] = mnist_out["masked_matmul"]
    mm_rec["mnist"]["launches"] = mnist_out["training"][
        "masked_matmul_launches"]
    mm_rec["mnist_training"] = mnist_out["training"]
    mm_rec["sparse_conv"] = conv

    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
